"""Sharding plans: which mesh axes carry which kind of parallelism.

Counterpart of ``repro/dist/plan.py``.  A ``ShardingPlan`` names the mesh
axes of data parallelism (``dp``), parameter sharding (``fsdp``), tensor
parallelism (``tp``) and expert parallelism (``ep``); ``use_plan`` makes a
plan current for the dynamic extent of a block (a ``contextvars`` variable,
so nesting behaves like lexical scoping, also across exceptions) and
``current_plan`` reads it.

The port has no ``jax.sharding.Mesh``: its :class:`Mesh` is a numpy array of
entries with axis names, the shards of a rung in mesh order.  An entry is
either a ``torch.device`` (a *local* mesh: every entry belongs to this
process) or a :class:`RankDevice`, a ``(rank, device)`` pair of a
``torch.distributed`` process group (a *rank* mesh).  Either may name one
physical device many times: virtual devices, eight of them on one card or
on the CPU in the tests, as the reference forces eight host devices; a rank
runs its own entries in mesh order on its device.  A rank mesh builds one
process group per mesh axis, and one over the whole mesh, when it is
constructed (``new_group`` is collective over the world, so every rank
builds every mesh in the same order); a reduction over an axis goes through
that axis's group (:meth:`Mesh.group`).  A local mesh over several physical
devices raises in :meth:`Mesh.physical_device`: one process drives one
device, and several devices take one rank each (``launch.mesh.init_ranks``
under ``torchrun``).  A rank mesh builds a group over every subset of its
axes, so a spec entry naming several axes (``("pod", "data")``) has one.

On a rank mesh with one entry per rank the training state is sharded at
run time (``dist.sharding.state_layout``): each rank holds its shard of
every leaf the rules shard.  The collectives below carry it, each batched
per dtype into one call over one axis group: :func:`all_gather_dim` and
:func:`reduce_scatter_dim` along a dim, :func:`all_to_all_dim0` over the
leading dim; :func:`gather_shards` is the autograd form a block's forward
calls (its backward reduce-scatters the gradient over the data-parallel
axes and slices it over the others, or sums it where each rank used a part
of the whole) and :func:`all_to_all` the one ``models/moe_ep.py`` routes
tokens through (its backward is the reverse exchange).  Tensor-parallel
compute (``models/transformer.py``) brackets a block's split products with
:func:`copy_to_group` (identity forward, all-reduce sum backward: in front
of the column-parallel products) and :func:`reduce_from_group` (all-reduce
sum forward, identity backward: after the row-parallel ones), Megatron's
``f`` and ``g``; :func:`tensor_parallel_counts` counts their all-reduces.
Where the training stack splits the residual stream by columns over tp,
a sublayer enters by :func:`residual_entry` (all-gather forward; backward
a sum reduce-scatter, or the rank's own columns) and leaves by
:func:`residual_exit` (reduce-scatter sum forward, all-gather backward)
or, when it computed whole, :func:`residual_slice` (the rank's columns,
all-gather backward); :func:`residual_counts` counts them by kind.  Each
tensor helper here reports the collective it issues to
the recorders of :func:`record_collectives` (kind, bytes, the group's
ranks): what the dry run (``utils/hlo.py``) and the scale-out tests count.
The training step and the sharded state issue every collective through
them; the pod exchange's list gather (``dist/compression.py``) and
:func:`broadcast_object` (serving's policy decisions) report nothing.
Chunks are ordered by the shard's position along the entry's axes, in the
entry's order, whatever the groups' rank order.  A local mesh keeps whole
leaves (its entries share one device, so sharding would save no byte).  The reference's ``constrain`` activation hook has no
counterpart; ``dist.sharding`` holds the PartitionSpec rules.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist

AxisNames = Any  # str | tuple[str, ...]


def process_rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """A rank mesh's entry: the shard runs in process ``rank`` on ``device``
    (as that rank names it)."""

    rank: int
    device: torch.device

    def __post_init__(self):
        object.__setattr__(self, "rank", int(self.rank))
        object.__setattr__(self, "device", torch.device(self.device))

    def __repr__(self) -> str:
        return f"RankDevice({self.rank}, {self.device})"


def rank_devices(device: torch.device | str, world: int | None = None,
                 per_rank: int = 1) -> list[RankDevice]:
    """``per_rank`` entries for each rank ``0 .. world - 1`` (the default
    group's size when None), in rank order, each on ``device``: every rank
    lists the whole world with its own device, which is the one its own
    entries run on."""
    world = world_size() if world is None else int(world)
    return [RankDevice(r, device) for r in range(world) for _ in range(per_rank)]


def _object_array(entries: Any) -> np.ndarray:
    """``entries`` (a nested sequence) as an object array of its leaves."""
    src = np.asarray(entries, dtype=object)
    arr = np.empty(src.shape, dtype=object)
    for idx in np.ndindex(arr.shape):
        arr[idx] = src[idx]
    return arr


class Mesh:
    """Shards arranged on named axes.  ``devices`` is an object array of
    ``torch.device`` whose shape gives each axis's size and ``ranks`` the
    rank of every entry (this process's rank for a local mesh)."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        src = _object_array(devices)
        kinds = {isinstance(e, RankDevice) for e in src.flat}
        if len(kinds) > 1:
            raise ValueError("a mesh's entries are all devices or all RankDevice pairs")
        #: whether the entries are ``(rank, device)`` pairs (a rank mesh)
        self.ranked = kinds == {True}
        #: this process's rank
        self.rank = process_rank()
        self.devices = np.empty(src.shape, dtype=object)
        self.ranks = np.full(src.shape, self.rank, dtype=np.int64)
        for idx in np.ndindex(src.shape):
            e = src[idx]
            if self.ranked:
                self.devices[idx], self.ranks[idx] = e.device, e.rank
            else:
                self.devices[idx] = torch.device(e)
        if src.ndim != len(axis_names):
            raise ValueError(f"devices of shape {src.shape} do not fit the axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(str(a) for a in axis_names)
        self._groups: dict[tuple[str, ...], tuple[Any, tuple[int, ...]]] = {}
        self._axis_groups: dict[tuple[str, ...], tuple[Any, int, list[int] | None]] = {}
        if self.ranked:
            self._build_groups()

    # -- shape -----------------------------------------------------------------
    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list[torch.device]:
        """The devices in mesh order (the last axis fastest)."""
        return list(self.devices.flat)

    # -- ranks and groups ------------------------------------------------------
    def _axes_key(self, axes: AxisNames) -> tuple[str, ...]:
        """``axes`` as a subset of the mesh's axes, in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not axes or not set(axes) <= set(self.axis_names) or len(set(axes)) < len(axes):
            raise KeyError(f"{axes} is not a subset of the mesh's axes {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def _rank_sets(self, axes: tuple[str, ...]) -> list[tuple[int, ...]]:
        """The distinct rank lists (mesh order, repeats dropped) along
        ``axes``, one per position on the other axes, first seen first."""
        along = [self.axis_names.index(a) for a in axes]
        other = [i for i in range(len(self.axis_names)) if i not in along]
        n = math.prod(self.devices.shape[i] for i in along)
        rows = self.ranks.transpose(other + along).reshape(-1, n)
        sets: list[tuple[int, ...]] = []
        for row in rows:
            s = tuple(dict.fromkeys(int(r) for r in row))
            if s not in sets:
                sets.append(s)
        return sets

    def _build_groups(self) -> None:
        """One process group per axis and one over the whole mesh, built on
        every rank in the same order (``new_group`` is collective over the
        world); a rank keeps the group it belongs to."""
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a mesh of RankDevice entries needs torch.distributed initialised "
                "(repro_torch.launch.mesh.init_ranks, under torchrun)")
        names = self.axis_names
        keys = [tuple(names[i] for i in range(len(names)) if (mask >> i) & 1)
                for mask in range(1, 1 << len(names))]
        keys.sort(key=len)  # one axis first, the whole mesh last
        for key in keys:
            for ranks in self._rank_sets(key):
                group = dist.new_group(sorted(ranks))
                if self.rank in ranks:
                    self._groups[key] = (group, ranks)

    def group(self, axes: AxisNames):
        """The process group of this rank along ``axes`` (any subset of the
        mesh's axes); None on a local mesh."""
        if not self.ranked:
            return None
        return self._groups[self._axes_key(axes)][0]

    def group_ranks(self, axes: AxisNames) -> tuple[int, ...]:
        """The ranks of this rank's group along ``axes``, in mesh order."""
        if not self.ranked:
            return (self.rank,)
        return self._groups[self._axes_key(axes)][1]

    @property
    def one_entry_per_rank(self) -> bool:
        """Whether every rank holds exactly one entry (a rank mesh whose
        state can be sharded)."""
        return self.ranked and len(set(self.ranks.flat)) == self.size

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """``{axis: position}`` of ``rank``'s entry (this rank's by
        default); raises unless the rank holds exactly one entry."""
        rank = self.rank if rank is None else int(rank)
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} holds {len(where)} entries of {self!r}, not one")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_group(self, axes: AxisNames) -> tuple[Any, int, list[int] | None]:
        """``(group, n, order)`` for a collective over ``axes`` (a name or
        a tuple, in the order that numbers the shards): ``n`` shards, and
        ``order[k]``, the position in the group (ranks sorted) of the rank
        holding shard ``k``, or None when that is ``k`` itself."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes not in self._axis_groups:
            mine = self.coords()
            members = sorted(self.group_ranks(axes))
            index = {}
            for r in members:
                c = self.coords(r)
                if any(c[a] != mine[a] for a in self.axis_names if a not in axes):
                    raise ValueError(f"rank {r} is off this rank's line along {axes}")
                k = 0
                for a in axes:
                    k = k * self.shape[a] + c[a]
                index[k] = members.index(r)
            order = [index[k] for k in range(len(members))]
            self._axis_groups[axes] = (
                self.group(axes), len(members),
                None if order == list(range(len(members))) else order)
        return self._axis_groups[axes]

    @property
    def is_member(self) -> bool:
        """Whether this process holds an entry of the mesh."""
        return bool((self.ranks == self.rank).any())

    @property
    def root(self) -> int:
        """The rank of the mesh's first entry."""
        return int(self.ranks.flat[0])

    @property
    def spans_ranks(self) -> bool:
        return len(set(self.ranks.flat)) > 1

    def local_positions(self, axes: AxisNames) -> list[int]:
        """Positions along the flattened ``axes`` (in their order) of this
        rank's entries, sorted."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        along = [self.axis_names.index(a) for a in axes]
        other = [i for i in range(len(self.axis_names)) if i not in along]
        n = math.prod(self.devices.shape[i] for i in along)
        mine = self.ranks.transpose(along + other).reshape(n, -1) == self.rank
        return [i for i in range(n) if mine[i].any()]

    def physical_device(self) -> torch.device:
        """The one physical device this process's entries name.  Raises for
        a local mesh over several physical devices (one rank per device is
        the launcher's job), and on a rank that holds no entry."""
        if self.ranked:
            mine = {d for d, r in zip(self.devices.flat, self.ranks.flat)
                    if int(r) == self.rank}
            if not mine:
                raise ValueError(f"rank {self.rank} holds no entry of {self!r}")
            if len(mine) > 1:
                raise NotImplementedError(
                    f"rank {self.rank} holds entries on {sorted(map(str, mine))}: a rank "
                    "drives one device; give each device a rank of its own")
            return mine.pop()
        devs = set(self.flat())
        if len(devs) != 1:
            raise NotImplementedError(
                f"a mesh over {len(devs)} physical devices ({sorted(map(str, devs))}) in "
                f"one process needs process groups: launch one rank per device "
                f"(torchrun --nproc-per-node "
                f"{len(devs)}, repro_torch.launch.mesh.init_ranks) and build the mesh "
                "from dist.plan.RankDevice entries")
        return devs.pop()

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.flat() == other.flat() and self.ranked == other.ranked
                and bool((self.ranks == other.ranks).all()))

    def __repr__(self) -> str:
        if self.ranked:
            return (f"Mesh({self.shape}, ranks={sorted(set(self.ranks.flat.tolist()))}, "
                    f"devices={sorted(set(map(str, self.flat())))})")
        return f"Mesh({self.shape}, devices={sorted(set(map(str, self.flat())))})"


class AbstractMesh:
    """Axis names and sizes without devices: what the sharding rules and
    ``launch.mesh.make_plan`` read (the reference's ``AbstractMesh``)."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(str(a) for a in axis_names)
        self.devices = np.empty(tuple(int(s) for s in axis_sizes), dtype=object)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def abstract_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> AbstractMesh:
    """A mesh of the given shape with no devices behind it."""
    return AbstractMesh(axis_sizes, axis_names)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Mesh + axis assignment for dp/fsdp/tp/ep parallelism."""

    mesh: Any  # Mesh or AbstractMesh
    dp: tuple[str, ...] = ("data",)
    fsdp: tuple[str, ...] = ("data",)
    tp: AxisNames = "model"
    ep: tuple[str, ...] = ("data",)

    def axis_size(self, axes: AxisNames) -> int:
        """Total number of shards over ``axes`` (a name or tuple of names)."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.mesh.shape[a] for a in axes)

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.dp)

    @property
    def fsdp_size(self) -> int:
        return self.axis_size(self.fsdp)

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp)

    @property
    def ep_size(self) -> int:
        return self.axis_size(self.ep)


_ACTIVE: contextvars.ContextVar[ShardingPlan | None] = contextvars.ContextVar(
    "repro_torch_dist_active_plan", default=None)


def current_plan() -> ShardingPlan | None:
    """The innermost active plan, or None outside every ``use_plan``."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_plan(plan: ShardingPlan) -> Iterator[ShardingPlan]:
    """Activate ``plan`` for the dynamic extent of the block; the previous
    plan is restored on exit, also on exceptions."""
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)


# ---------------------------------------------------------------------------
# collectives over a mesh's groups
# ---------------------------------------------------------------------------

#: the active recorders of :func:`record_collectives`.  A list, not a
#: context variable: the backward on the card runs on autograd's own thread
_RECORDERS: list = []


@contextlib.contextmanager
def record_collectives(fn) -> Iterator[Any]:
    """For the block's extent, on any thread, call ``fn(kind,
    operand_bytes, result_bytes, ranks)`` for each collective the helpers
    below issue: ``kind`` the reference's HLO name (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``) or ``broadcast``;
    the bytes of the call's input and output buffers; the group's global
    ranks."""
    _RECORDERS.append(fn)
    try:
        yield fn
    finally:
        _RECORDERS.remove(fn)


def _record(kind: str, operand: torch.Tensor, result: torch.Tensor, group) -> None:
    if not _RECORDERS:
        return
    ranks = tuple(dist.get_process_group_ranks(group) if group is not None
                  else range(dist.get_world_size()))
    for fn in list(_RECORDERS):
        fn(kind, operand.numel() * operand.element_size(),
           result.numel() * result.element_size(), ranks)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> dict[torch.dtype, list[int]]:
    out: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor], group, n: int) -> list[torch.Tensor]:
    """The mean of ``tensors`` over the ``n`` ranks of ``group``, in each
    tensor's own type: one all-reduce (sum) per dtype over the tensors
    flattened into one buffer, then a division by ``n``.  Returns views of
    the reduced buffers, shaped like the inputs."""
    out: list[torch.Tensor | None] = [None] * len(tensors)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        all_reduce_sum_(flat, group)
        flat.div_(n)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


@torch.no_grad()
def all_reduce_sum_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` over ``group``'s ranks, in place (one all-reduce)."""
    _record("all-reduce", tensor, tensor, group)
    dist.all_reduce(tensor, group=group)
    return tensor


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int, group) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s (a global rank):
    one broadcast per dtype over the tensors flattened into one buffer."""
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _record("broadcast", flat, flat, group)
        dist.broadcast(flat, src=src, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            tensors[i].copy_(part.view(tensors[i].shape))


def broadcast_object(obj: Any, src: int, group, device: torch.device) -> Any:
    """Rank ``src``'s ``obj`` (picklable; a small host value) on every rank
    of ``group``; its bytes travel on ``device`` under NCCL, on the CPU
    under gloo."""
    box = [obj]
    dist.broadcast_object_list(
        box, src=src, group=group,
        device=device if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return box[0]


# ---------------------------------------------------------------------------
# collectives along a dim, over one axis group (the sharded state)
# ---------------------------------------------------------------------------


def _axes(axes: AxisNames) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _inverse(order: list[int]) -> list[int]:
    inv = [0] * len(order)
    for k, g in enumerate(order):
        inv[g] = k
    return inv


@torch.no_grad()
def all_gather_dim(tensors: Sequence[torch.Tensor], dims: Sequence[int], mesh,
                   axes: AxisNames) -> list[torch.Tensor]:
    """Each tensor whole along ``dims[i]``: the ``n`` shards over ``axes``
    laid end to end in shard order; one ``all_gather_into_tensor`` per
    dtype.  Contiguous results."""
    group, n, order = mesh.axis_group(_axes(axes))
    if n == 1:
        return list(tensors)
    out: list = [None] * len(tensors)
    for idx in _by_dtype(tensors).values():
        moved = [tensors[i].movedim(dims[i], 0) for i in idx]
        flat = torch.cat([m.reshape(-1) for m in moved])
        buf = flat.new_empty(n * flat.numel())
        _record("all-gather", flat, buf, group)
        dist.all_gather_into_tensor(buf, flat, group=group)
        rows = buf.view(n, -1)
        if order is not None:
            rows = rows[order]
        for i, m, part in zip(idx, moved, rows.split([m.numel() for m in moved], dim=1)):
            out[i] = part.reshape(n * m.shape[0], *m.shape[1:]).movedim(0, dims[i]).contiguous()
    return out


@torch.no_grad()
def reduce_scatter_dim(tensors: Sequence[torch.Tensor], dims: Sequence[int], mesh,
                       axes: AxisNames, mean: bool = True) -> list[torch.Tensor]:
    """This rank's shard along ``dims[i]`` of each tensor summed (or
    averaged) over the ``n`` ranks along ``axes``; one
    ``reduce_scatter_tensor`` per dtype."""
    group, n, order = mesh.axis_group(_axes(axes))
    if n == 1:
        return list(tensors)
    out: list = [None] * len(tensors)
    for idx in _by_dtype(tensors).values():
        moved = [tensors[i].movedim(dims[i], 0) for i in idx]
        rows = torch.cat([m.reshape(n, -1) for m in moved], dim=1)
        if order is not None:  # row g goes to the group's g-th rank
            rows = rows[_inverse(order)]
        part = rows.new_empty(rows.shape[1])
        _record("reduce-scatter", rows, part, group)
        dist.reduce_scatter_tensor(part, rows.contiguous().view(-1), group=group)
        if mean:
            part.div_(n)
        for i, m, piece in zip(idx, moved, part.split([m.numel() // n for m in moved])):
            out[i] = piece.view(m.shape[0] // n, *m.shape[1:]).movedim(0, dims[i]).contiguous()
    return out


@torch.no_grad()
def all_to_all_dim0(x: torch.Tensor, mesh, axes: AxisNames) -> torch.Tensor:
    """``x`` holds ``n`` chunks along dim 0, chunk ``k`` for shard ``k``
    along ``axes``; returns chunk ``k`` from shard ``k`` (one
    ``all_to_all_single``)."""
    group, n, order = mesh.axis_group(_axes(axes))
    if n == 1:
        return x.clone()
    rows = x.reshape(n, -1)
    if order is not None:
        rows = rows[_inverse(order)]
    out = torch.empty_like(rows)
    _record("all-to-all", rows, out, group)
    dist.all_to_all_single(out, rows.contiguous(), group=group)
    if order is not None:
        out = out[order]
    return out.reshape(x.shape)


def _shard_index(mesh, axes: tuple[str, ...]) -> int:
    """This rank's shard position along ``axes``, in their order."""
    c = mesh.coords()
    k = 0
    for a in axes:
        k = k * mesh.shape[a] + c[a]
    return k


def _slice_own(t: torch.Tensor, dim: int, mesh, axes: AxisNames) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` over ``axes`` (no exchange)."""
    axes = _axes(axes)
    k = _shard_index(mesh, axes)
    n = math.prod(mesh.shape[a] for a in axes)
    return t.narrow(dim, k * (t.shape[dim] // n), t.shape[dim] // n).contiguous()


class _GatherShards(torch.autograd.Function):
    """Forward: gathers each shard whole, round by round (one axis group a
    round).  Backward: the rounds in reverse; over data-parallel axes the
    gradient is reduce-scattered as a mean (the ranks saw different
    samples); over the others each rank keeps its own slice (they computed
    the same gradient), or, in a summed round, the gradient is
    reduce-scattered as a sum (each rank used its part of the whole: a
    tensor-parallel rank's KV head)."""

    @staticmethod
    def forward(ctx, mesh, dp, rounds, *shards):
        ctx.mesh, ctx.dp, ctx.rounds = mesh, dp, rounds
        out = list(shards)
        for (axes, _), members in rounds:
            idx = [i for i, _ in members]
            whole = all_gather_dim([out[i] for i in idx], [d for _, d in members], mesh, axes)
            for i, w in zip(idx, whole):
                out[i] = w
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, dp = ctx.mesh, set(ctx.dp)
        g = list(grads)
        for (axes, summed), members in reversed(ctx.rounds):
            idx = [i for i, _ in members]
            dims = [d for _, d in members]
            if set(axes) <= dp:
                parts = reduce_scatter_dim([g[i] for i in idx], dims, mesh, axes, mean=True)
            elif set(axes) & dp:
                raise NotImplementedError(
                    f"a dim sharded over {axes}, partly data-parallel ({sorted(dp)})")
            elif summed:
                parts = reduce_scatter_dim([g[i] for i in idx], dims, mesh, axes, mean=False)
            else:
                parts = [_slice_own(g[i], d, mesh, axes) for i, d in zip(idx, dims)]
            for i, p in zip(idx, parts):
                g[i] = p
        return (None, None, None, *g)


def gather_shards(shards: Sequence[torch.Tensor], dims: Sequence[Sequence[tuple[int, Any]]],
                  mesh, dp: Sequence[str], summed: Sequence[bool] | None = None
                  ) -> list[torch.Tensor]:
    """Every shard whole, under autograd: ``dims[i]`` lists ``(dim, axes)``
    of shard ``i``'s sharded dims.  One all-gather per axis group and dtype
    (the groups in mesh order), and the reverse reduce-scatters or slices in
    the backward (:class:`_GatherShards`); ``dp`` names the data-parallel
    axes.  ``summed[i]``: shard ``i``'s gradient is summed over its other
    axes, not sliced (each rank there used only a part of the whole leaf);
    such shards gather in rounds of their own."""
    rounds: dict[tuple[tuple[str, ...], bool], list] = {}
    for i, entries in enumerate(dims):
        for d, axes in entries:
            part = bool(summed[i]) if summed is not None else False
            rounds.setdefault((_axes(axes), part), []).append((i, d))
    if not rounds:
        return list(shards)
    order = sorted(rounds, key=lambda k: ([mesh.axis_names.index(a) for a in k[0]], k[1]))
    return list(_GatherShards.apply(mesh, tuple(dp), tuple((k, tuple(rounds[k])) for k in order),
                                    *shards))


# ---------------------------------------------------------------------------
# tensor-parallel compute: Megatron's f and g over a mesh's tp group
# ---------------------------------------------------------------------------

#: all-reduces issued by :func:`copy_to_group` and :func:`reduce_from_group`
#: (calls and operand bytes), from any thread
_TP_COUNTS = {"calls": 0, "bytes": 0}


def tensor_parallel_counts() -> dict[str, int]:
    """``{"calls", "bytes"}``: the tensor-parallel all-reduces since the last
    :func:`reset_tensor_parallel_counts` (forward and backward)."""
    return dict(_TP_COUNTS)


def reset_tensor_parallel_counts() -> None:
    _TP_COUNTS.update(calls=0, bytes=0)


def _tp_all_reduce(x: torch.Tensor, group, counts: dict | None = None) -> torch.Tensor:
    """A contiguous copy of ``x`` summed over ``group``; counted, and in
    ``counts`` too when given."""
    y = x.clone(memory_format=torch.contiguous_format)
    for c in (_TP_COUNTS,) if counts is None else (_TP_COUNTS, counts):
        c["calls"] += 1
        c["bytes"] += y.numel() * y.element_size()
    return all_reduce_sum_(y, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, counts):
        ctx.group, ctx.counts = group, counts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tp_all_reduce(g, ctx.group, ctx.counts), None, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _tp_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, mesh, axes: AxisNames, counts: dict | None = None
                  ) -> torch.Tensor:
    """``x`` (the same on every rank along ``axes``) as it is; its gradient
    summed over those ranks (each computed the part its products use), that
    all-reduce counted in ``counts`` (``{"calls", "bytes"}``) too when
    given.  An identity on one rank."""
    group, n, _ = mesh.axis_group(_axes(axes))
    return x if n == 1 else _CopyToGroup.apply(x, group, counts)


def reduce_from_group(x: torch.Tensor, mesh, axes: AxisNames) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` along ``axes`` (one all-reduce);
    its gradient passes to each rank as it is.  An identity on one rank."""
    group, n, _ = mesh.axis_group(_axes(axes))
    return x if n == 1 else _ReduceFromGroup.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_to_all_dim0(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_dim0(g.contiguous(), ctx.mesh, ctx.axes), None, None


def all_to_all(x: torch.Tensor, mesh, axes: AxisNames) -> torch.Tensor:
    """:func:`all_to_all_dim0` under autograd: the backward sends each
    chunk's gradient back where the chunk came from (the same exchange)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _AllToAll.apply(x, mesh, axes)
    return all_to_all_dim0(x, mesh, axes)


@torch.no_grad()
def permute_blocks_dim0(x: torch.Tensor, perm: Sequence[int], mesh, axes: AxisNames,
                        counts: dict | None = None) -> torch.Tensor:
    """``x`` holds this shard's ``m`` blocks along dim 0 of a whole of
    ``n m`` blocks in shard order (shard ``k`` holds blocks ``[k m, (k+1)
    m)``, ``n`` shards along ``axes``); returns blocks ``perm[k m : (k+1)
    m]`` of the whole, in that order, for this shard ``k``.  One
    ``all_to_all_single`` with split sizes: a block goes only to the shard
    that takes it, and one a shard takes of its own stays put.  Counted in
    ``counts`` (``{"calls", "bytes"}``: the bytes sent) when given."""
    axes = _axes(axes)
    group, n, order = mesh.axis_group(axes)
    m = len(perm) // n
    blocks = x.reshape(m, -1)
    if n == 1:
        return blocks[list(perm)].reshape(x.shape)
    me = _shard_index(mesh, axes)
    # slot i of the whole's new layout takes block perm[i]; both sides list a
    # pair's blocks in slot order
    sends = [[perm[i] % m for i in range(k * m, (k + 1) * m) if perm[i] // m == me]
             for k in range(n)]
    recvs = [[i - me * m for i in range(me * m, (me + 1) * m) if perm[i] // m == k]
             for k in range(n)]
    by_pos = list(range(n)) if order is None else _inverse(order)  # group position -> shard
    out = blocks.new_empty(blocks.shape)
    for i in recvs[me]:  # its own blocks stay
        out[i] = blocks[perm[me * m + i] % m]
    send = torch.cat([blocks[sends[k]].reshape(-1) for k in by_pos if k != me])
    recv = blocks.new_empty(sum(len(recvs[k]) for k in range(n) if k != me) * blocks.shape[1])
    size = blocks.shape[1]
    _record("all-to-all", send, recv, group)
    if counts is not None:
        counts["calls"] += 1
        counts["bytes"] += send.numel() * send.element_size()
    dist.all_to_all_single(recv, send,
                           output_split_sizes=[0 if k == me else len(recvs[k]) * size
                                               for k in by_pos],
                           input_split_sizes=[0 if k == me else len(sends[k]) * size
                                              for k in by_pos], group=group)
    got = iter(recv.view(-1, size))
    for k in by_pos:
        if k != me:
            for i in recvs[k]:
                out[i] = next(got)
    return out.reshape(x.shape)


class _PermuteBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, mesh, axes, counts, back_counts):
        ctx.mesh, ctx.axes, ctx.counts = mesh, axes, back_counts
        ctx.inverse = _inverse(list(perm))
        return permute_blocks_dim0(x, perm, mesh, axes, counts)

    @staticmethod
    def backward(ctx, g):
        return (permute_blocks_dim0(g.contiguous(), ctx.inverse, ctx.mesh, ctx.axes,
                                    ctx.counts), None, None, None, None, None)


def permute_blocks(x: torch.Tensor, perm: Sequence[int], mesh, axes: AxisNames,
                   counts: dict | None = None, back_counts: dict | None = None
                   ) -> torch.Tensor:
    """:func:`permute_blocks_dim0` under autograd: the backward sends each
    block's gradient back to the shard that held the block (the inverse
    permutation), counted in ``back_counts``."""
    perm = tuple(int(p) for p in perm)
    if x.requires_grad and torch.is_grad_enabled():
        return _PermuteBlocks.apply(x, perm, mesh, axes, counts, back_counts)
    return permute_blocks_dim0(x, perm, mesh, axes, counts)


# ---------------------------------------------------------------------------
# the residual stream split over tp: a sublayer's entry and exit, the slice
# ---------------------------------------------------------------------------

#: the residual stream's collectives in tensor-parallel training, by kind
#: (:func:`residual_counts`): the sublayer entries' all-gathers and, behind
#: a split sublayer, their backward's reduce-scatters; the exits'
#: reduce-scatters and their backward's all-gathers; the slices' backward
#: all-gathers
RESIDUAL_KINDS = ("entry_all_gather", "entry_reduce_scatter", "exit_reduce_scatter",
                  "exit_all_gather", "slice_all_gather")
_RES_COUNTS: dict[str, dict[str, int]] = {k: {"calls": 0, "bytes": 0} for k in RESIDUAL_KINDS}


def residual_counts() -> dict[str, dict[str, int]]:
    """``{kind: {"calls", "bytes"}}`` of :data:`RESIDUAL_KINDS` since the
    last :func:`reset_residual_counts`, each call by the bytes of the whole
    tensor (a gather's output, a reduce-scatter's input); a remat recompute
    issues and counts the forward's again."""
    return {k: dict(v) for k, v in _RES_COUNTS.items()}


def reset_residual_counts() -> None:
    for v in _RES_COUNTS.values():
        v.update(calls=0, bytes=0)


def _residual(kind: str, x: torch.Tensor, mesh, axes: AxisNames) -> torch.Tensor:
    """One of the residual's collectives along ``x``'s last dim over
    ``axes``, counted by ``kind``: the ``*_all_gather`` kinds join the
    ranks' columns, the others reduce-scatter the sum to the rank's."""
    if kind.endswith("all_gather"):
        out = whole = all_gather_dim([x], [x.dim() - 1], mesh, axes)[0]
    else:
        whole, out = x, reduce_scatter_dim([x], [x.dim() - 1], mesh, axes, mean=False)[0]
    _RES_COUNTS[kind]["calls"] += 1
    _RES_COUNTS[kind]["bytes"] += whole.numel() * whole.element_size()
    return out


class _ResidualEntry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, summed):
        ctx.mesh, ctx.axes, ctx.summed = mesh, axes, summed
        return _residual("entry_all_gather", x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _residual("entry_reduce_scatter", g, ctx.mesh, ctx.axes)
        else:
            g = _slice_own(g, g.dim() - 1, ctx.mesh, ctx.axes)
        return g, None, None, None


class _ResidualExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _residual("exit_reduce_scatter", y, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _residual("exit_all_gather", g, ctx.mesh, ctx.axes), None, None


class _ResidualSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _slice_own(x, x.dim() - 1, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _residual("slice_all_gather", g, ctx.mesh, ctx.axes), None, None


def residual_entry(x: torch.Tensor, mesh, axes: AxisNames, summed: bool) -> torch.Tensor:
    """A sublayer's entry: this rank's columns ``x`` (..., d/n) of the
    residual joined whole (..., d) by one all-gather over ``axes``.  Its
    backward is :func:`gather_shards`' rule for one axis group: ``summed``
    (every consumer of the whole uses a part of it: a split sublayer's
    column products) reduce-scatters the ranks' partial gradients as a sum;
    else (the consumers' gradient is whole and alike on every rank: a
    sublayer that computes whole) each rank keeps its own columns.  An
    identity on one rank."""
    if mesh.axis_group(_axes(axes))[1] == 1:
        return x
    return _ResidualEntry.apply(x, mesh, axes, bool(summed))


def residual_exit(y: torch.Tensor, mesh, axes: AxisNames) -> torch.Tensor:
    """A split sublayer's exit: the ranks' partial outputs ``y`` (..., d)
    summed and this rank's columns (..., d/n) kept, one reduce-scatter over
    ``axes`` (``reduce_from_group``'s all-reduce, its other columns left on
    their ranks); the backward all-gathers the columns' gradient.  An
    identity on one rank."""
    if mesh.axis_group(_axes(axes))[1] == 1:
        return y
    return _ResidualExit.apply(y, mesh, axes)


def residual_slice(x: torch.Tensor, mesh, axes: AxisNames) -> torch.Tensor:
    """This rank's columns of ``x`` (..., d), whole and alike on every rank
    along ``axes`` (a whole sublayer's output, a whole embedding); the
    backward all-gathers the columns' gradient.  An identity on one rank."""
    if mesh.axis_group(_axes(axes))[1] == 1:
        return x
    return _ResidualSlice.apply(x, mesh, axes)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def scale_grad(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x`` as it is; its gradient times ``factor``."""
    return _ScaleGrad.apply(x, factor)
