"""Divisibility-aware PartitionSpec inference for parameter, state, batch
and cache trees.

Counterpart of ``repro/dist/sharding.py``, with the reference's rules.  A
tree here is a mapping from ``/``-joined paths (the reference's tree paths,
``interop.layout`` names them for the port's parameters) to shapes or to
anything with ``.shape``; a rule returns one :class:`P` per path, the
port's PartitionSpec: a tuple with one entry per dim, each an axis name, a
tuple of axis names, or None.  Rules are SUFFIX rules, so ``params/...``,
``opt_state/momentum/...`` and ``div_state/grad_sum/...`` leaves shard like
the parameters they mirror; stacked block parameters carry a leading
repeat axis, so rules address TRAILING dims.

Every axis assignment goes through :func:`_fit_axes`, the largest-product
subset of the candidate mesh axes that divides the dim: an indivisible dim
degrades to replication, and a multi-axis group like ``("pod", "data")``
factorises.

  column-parallel kernels  (.., d_in, d_out)   d_in -> fsdp, d_out -> tp
  row-parallel kernels     (.., d_in, d_out)   d_in -> tp,   d_out -> fsdp
  lm_head kernel           (d, V)              V -> tp, d replicated
  embedding                (V, d)              V -> fsdp, d -> tp
  MoE expert weights       (.., E, d, ff)      E -> ep, contraction dim
                                               replicated, other -> tp
  Mamba channel params     (.., d_inner, ..)   d_inner -> tp
  norms / biases / scalars                     replicated

Batch leaves shard their leading dim over dp.  KV-cache leaves shard batch
over dp (falling back to the sequence dim for batch-1 decode) and kv-heads
over tp (falling back to head_dim when kv_heads < tp size).

:func:`shardings_of` maps the specs to DTensor placements over the plan's
mesh axes.

The specs are also what the training state holds at run time.  On a rank
mesh with one entry per rank (``dist.plan.Mesh.one_entry_per_rank``) each
rank keeps, of every leaf, exactly the shard the reference's
``NamedSharding(mesh, spec)`` gives its device: :func:`local_slices` (the
offset along each sharded dim is the rank's position along the entry's
axes, in the entry's order), :func:`shard` / :func:`unshard` for one leaf,
:func:`shard_tree` / :func:`unshard_tree` for a tree keyed by the
reference's paths.  :func:`state_layout` reads the specs of a model's
parameters through ``interop.layout`` (a port tensor's dims are the
reference leaf's, transposed or permuted, one slice of a stacked leaf):
the :class:`StateLayout` it returns is attached to the model
(``model.shard_layout``, :func:`layout_of`) and to the diversity state, and
the parameters, momenta and ``grad_sum`` hold their shards.  A local mesh,
whose entries share one device, keeps whole leaves, and so does a plan that
shards nothing (the paper's small models match no rule): no layout then.
The forward gathers a block's shards on entry (:func:`gathered`, the
autograd all-gather of ``dist.plan.gather_shards``).

Tensor-parallel compute: on a plan whose tp axes span T > 1 ranks,
:func:`tp_split` says which sublayers of a block the training stack splits
(attention heads, dense-FFN and expert widths, Megatron-style; attention
context-parallel where T does not divide the heads but divides their
widths and the length; a Mamba mixer's ``d_inner`` channels) and which
compute whole on every tp rank; the shards stay those of the specs above.
A split block's entry gathers the fsdp axes only and keeps its split
leaves' tp dim resident (:meth:`TpSplit.role`, :meth:`StateLayout.gather`);
a leaf each tp rank uses only a part of (the one KV head a group of ranks
shares, a replicated bias) is gathered whole with its gradient summed over
tp.  :func:`tensor_parallel` gives a rank its place on the tp axes and the
two all-reduces (``dist.plan.copy_to_group``, ``reduce_from_group``).
Serving splits the same way (:func:`serving_split`, which keeps
context-parallel attention and the Mamba mixers whole;
:func:`serving_kv_heads`: the KV heads a tp rank computes are the ones its
pool, rings and dense cache hold).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Iterator, Mapping, Sequence

import torch

from repro_torch.dist.plan import (AxisNames, ShardingPlan, all_gather_dim, all_reduce_mean,
                                   all_reduce_sum_, copy_to_group, gather_shards,
                                   reduce_from_group)


class P(tuple):
    """A PartitionSpec: one entry per dim (an axis name, a tuple of axis
    names, or None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _shape(leaf: Any) -> tuple[int, ...]:
    return tuple(int(d) for d in (leaf.shape if hasattr(leaf, "shape") else leaf))


def _fit_axes(dim: int, axes: AxisNames, plan: ShardingPlan):
    """Largest-product subset of ``axes`` whose shard count divides ``dim``:
    a single axis name, a tuple of names (order kept), or None when nothing
    divides.  Ties prefer the earliest subset."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a is not None)
    best: tuple[str, ...] = ()
    best_prod = 1
    n = len(axes)
    for mask in range(1, 1 << n):
        subset = tuple(axes[i] for i in range(n) if (mask >> i) & 1)
        prod = math.prod(plan.mesh.shape[a] for a in subset)
        if prod > best_prod and dim > 0 and dim % prod == 0:
            best, best_prod = subset, prod
    if not best:
        return None
    return best[0] if len(best) == 1 else best


def fit_axes(dim: int, axes: AxisNames, plan: ShardingPlan):
    """The axes a dim of size ``dim`` shards over among ``axes`` (every
    rule's choice, :func:`_fit_axes`): a name, a tuple of names, or None."""
    return _fit_axes(dim, axes, plan)


# kernels whose OUTPUT dim carries tp (input dim carries fsdp)
_COLUMN_PARALLEL = (
    "attn/q/kernel",
    "attn/k/kernel",
    "attn/v/kernel",
    "ffn/w_gate/kernel",
    "ffn/w_up/kernel",
    "ffn/w_in/kernel",
    "mamba/in_proj/kernel",
    "mamba/dt_proj/kernel",
    "frontend/kernel",
)

# kernels whose INPUT dim carries tp (output dim carries fsdp)
_ROW_PARALLEL = (
    "attn/o/kernel",
    "ffn/w_out/kernel",
    "mamba/out_proj/kernel",
)

# Mamba per-channel params: the trailing-dims position of d_inner
_MAMBA_CHANNEL = {
    "mamba/A_log": -2,
    "mamba/x_proj/kernel": -2,
    "mamba/D": -1,
    "mamba/conv_kernel": -1,
    "mamba/conv_bias": -1,
}

# MoE expert tensors (E, d_in, d_out): expert axis -> ep, the other matmul
# dim -> tp
_MOE_EXPERT = {
    "ffn/w_gate": (-3, -1),
    "ffn/w_up": (-3, -1),
    "ffn/w_out": (-3, -2),
}


def _param_entries(path: str, shape: tuple[int, ...], plan: ShardingPlan) -> list:
    nd = len(shape)
    ent: list = [None] * nd

    def fit(i: int, axes: AxisNames) -> None:
        if -nd <= i < nd:
            ent[i] = _fit_axes(shape[i], axes, plan)

    for suffix, (ep_i, tp_i) in _MOE_EXPERT.items():
        if path.endswith(suffix):
            fit(ep_i, plan.ep)
            fit(tp_i, plan.tp)
            return ent
    for suffix, tp_i in _MAMBA_CHANNEL.items():
        if path.endswith(suffix):
            fit(tp_i, plan.tp)
            return ent
    if path.endswith("lm_head/kernel"):
        fit(-1, plan.tp)
        return ent
    if path.endswith("embed/embedding"):
        fit(-2, plan.fsdp)
        fit(-1, plan.tp)
        return ent
    if any(path.endswith(s) for s in _COLUMN_PARALLEL) and nd >= 2:
        fit(-2, plan.fsdp)
        fit(-1, plan.tp)
        return ent
    if any(path.endswith(s) for s in _ROW_PARALLEL) and nd >= 2:
        fit(-2, plan.tp)
        fit(-1, plan.fsdp)
        return ent
    return ent  # norms, biases, router, scalar counters: replicated


def infer_pspecs(tree: Mapping[str, Any], plan: ShardingPlan) -> dict[str, P]:
    """A :class:`P` per path of a parameter or whole-train-state tree."""
    return {path: P(*_param_entries(path, _shape(leaf), plan)) for path, leaf in tree.items()}


def batch_pspecs(specs: Mapping[str, Any], plan: ShardingPlan) -> dict[str, P]:
    """Input batches shard their leading (sample) dim over the dp axes."""
    out = {}
    for path, leaf in specs.items():
        shape = _shape(leaf)
        if not shape:
            out[path] = P()
            continue
        ent: list = [None] * len(shape)
        ent[0] = _fit_axes(shape[0], plan.dp, plan)
        out[path] = P(*ent)
    return out


def cache_pspecs(cache: Mapping[str, Any], plan: ShardingPlan) -> dict[str, P]:
    """KV/SSM decode-cache sharding.

    KV leaves are (..., B, S, KV, hd): batch -> dp, but a batch-1 cache
    falls back to sharding the sequence dim over dp; kv_heads -> tp, falling
    back to head_dim when the head count is smaller than the tp degree.
    Mamba state leaves shard batch -> dp and d_inner -> tp.  A serve block
    pool leaf (repeats, num_blocks, block, kv, hd) rides the k/v rule: the
    block axis lands on dp and kv heads on tp."""
    out = {}
    for path, leaf in cache.items():
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0:
            out[path] = P()
            continue
        ent: list = [None] * nd
        last = path.rsplit("/", 1)[-1]
        if last in ("k", "v") and nd >= 4:
            b_i, s_i, kv_i, hd_i = nd - 4, nd - 3, nd - 2, nd - 1
            dp = _fit_axes(shape[b_i], plan.dp, plan)
            if dp is not None:
                ent[b_i] = dp
            else:
                ent[s_i] = _fit_axes(shape[s_i], plan.dp, plan)
            tp = _fit_axes(shape[kv_i], plan.tp, plan)
            if tp is not None:
                ent[kv_i] = tp
            else:
                ent[hd_i] = _fit_axes(shape[hd_i], plan.tp, plan)
        elif last == "h" and nd >= 3:  # (..., B, d_inner, d_state)
            ent[nd - 3] = _fit_axes(shape[nd - 3], plan.dp, plan)
            ent[nd - 2] = _fit_axes(shape[nd - 2], plan.tp, plan)
        elif last == "conv" and nd >= 3:  # (..., B, K-1, d_inner)
            ent[nd - 3] = _fit_axes(shape[nd - 3], plan.dp, plan)
            ent[nd - 1] = _fit_axes(shape[nd - 1], plan.tp, plan)
        out[path] = P(*ent)
    return out


def placements(spec: P, plan: ShardingPlan) -> tuple:
    """DTensor placements over the plan's mesh axes (in axis order) for one
    spec: ``Shard(d)`` on every mesh axis that dim ``d`` names,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(plan.mesh.axis_names)
    for d, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            out[plan.mesh.axis_names.index(axis)] = Shard(d)
    return tuple(out)


def shardings_of(pspecs: Mapping[str, P], plan: ShardingPlan) -> dict[str, tuple]:
    """DTensor placements on the plan's mesh for a spec tree."""
    return {path: placements(spec, plan) for path, spec in pspecs.items()}


# ---------------------------------------------------------------------------
# shards at run time
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_slices(shape: Sequence[int], spec: Sequence, mesh_shape: Mapping[str, int],
                 coords: Mapping[str, int]) -> tuple[slice, ...]:
    """The slices of a leaf of ``shape`` that the entry at ``coords`` holds
    under ``spec``: along a dim sharded over axes ``(a, b)`` it holds chunk
    ``coords[a] * size(b) + coords[b]`` of ``size(a) * size(b)``."""
    out = []
    for i, dim in enumerate(shape):
        axes = _entry_axes(spec[i]) if i < len(spec) else ()
        n, k = 1, 0
        for a in axes:
            n *= mesh_shape[a]
            k = k * mesh_shape[a] + coords[a]
        size = dim // n
        out.append(slice(k * size, (k + 1) * size))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Sequence, plan: ShardingPlan) -> tuple[int, ...]:
    """The shard shape of a leaf (every rank's: the specs divide evenly)."""
    return tuple(int(d) // plan.axis_size(_entry_axes(spec[i]) or None) if i < len(spec)
                 else int(d) for i, d in enumerate(shape))


def _sharded_dims(spec: Sequence) -> list[tuple[int, tuple[str, ...]]]:
    return [(i, _entry_axes(e)) for i, e in enumerate(spec) if _entry_axes(e)]


def shard(tensor: torch.Tensor, spec: Sequence, plan: ShardingPlan) -> torch.Tensor:
    """This rank's shard of a whole leaf (a contiguous copy; the tensor
    itself when ``spec`` shards nothing)."""
    if not _sharded_dims(spec):
        return tensor
    mesh = plan.mesh
    return tensor[local_slices(tensor.shape, spec, mesh.shape, mesh.coords())].contiguous()


@torch.no_grad()
def unshard(tensor: torch.Tensor, spec: Sequence, plan: ShardingPlan) -> torch.Tensor:
    """The whole leaf from every rank's shard (an all-gather over each
    sharded dim's axis group; a collective over them)."""
    for d, axes in _sharded_dims(spec):
        tensor = all_gather_dim([tensor], [d], plan.mesh, axes)[0]
    return tensor


def shard_tree(tree: Mapping[str, torch.Tensor], plan: ShardingPlan) -> dict:
    """:func:`shard` of every leaf of a tree keyed by the reference's paths,
    under :func:`infer_pspecs`."""
    specs = infer_pspecs(tree, plan)
    return {path: shard(t, specs[path], plan) for path, t in tree.items()}


def unshard_tree(tree: Mapping[str, torch.Tensor], shapes: Mapping[str, Sequence[int]],
                 plan: ShardingPlan) -> dict:
    """The whole tree of :func:`shard_tree`'s shards (``shapes``: the whole
    leaves' shapes, which the specs are inferred from)."""
    specs = infer_pspecs(shapes, plan)
    return {path: unshard(t, specs[path], plan) for path, t in tree.items()}


def shards_state(plan: ShardingPlan | None) -> bool:
    """Whether ``plan``'s mesh holds sharded state: a rank mesh with one
    entry per rank, this rank among them."""
    return (plan is not None and getattr(plan.mesh, "ranked", False)
            and plan.mesh.one_entry_per_rank and plan.mesh.is_member)


#: the port dim of each of the reference leaf's dims, by ``interop`` form
_FORM_PERM = {"t": (1, 0), "hwio": (2, 3, 1, 0)}


def param_pspecs(model: torch.nn.Module, plan: ShardingPlan) -> dict[str, P]:
    """A :class:`P` per parameter of ``model`` (by ``named_parameters``
    name), over the port tensor's own dims: the reference leaf's spec
    (``interop.layout``: its path, and its shape stacked over the repeats)
    carried through the transpose or the HWIO permutation, the stacked axis
    dropped.  Whole shapes, also of a sharded model."""
    from repro_torch.interop import layout  # interop imports the models

    shapes = full_shapes(model)
    out = {}
    for leaf in layout(model):
        shape = shapes[leaf.names[0]]
        # the reference's dim j is the port tensor's dim perm[j]
        perm = _FORM_PERM.get(leaf.form, tuple(range(len(shape))))
        ref_shape = tuple(shape[j] for j in perm)
        if leaf.stacked:
            ref_shape = (len(leaf.names),) + ref_shape
        ent = _param_entries(leaf.path, ref_shape, plan)
        if leaf.stacked:
            ent = ent[1:]
        port = [None] * len(shape)
        for j, e in enumerate(ent):
            port[perm[j]] = e
        for n in leaf.names:
            out[n] = P(*port)
    return out


# ---------------------------------------------------------------------------
# tensor-parallel compute
# ---------------------------------------------------------------------------

#: a block's leaves (port names within the block) by the sublayer that
#: splits them: their tp dim stays resident in a split block
_TP_RESIDENT = {
    "attn": ("attn.q.weight", "attn.o.weight"),
    "kv": ("attn.k.weight", "attn.v.weight"),
    "ffn": ("ffn.w_gate.weight", "ffn.w_up.weight", "ffn.w_in.weight", "ffn.w_out.weight",
            "ffn.w_gate", "ffn.w_up", "ffn.w_out"),
    "mamba": ("mamba.in_proj.weight", "mamba.conv_kernel", "mamba.conv_bias",
              "mamba.x_proj.weight", "mamba.dt_proj.weight", "mamba.A_log", "mamba.D",
              "mamba.out_proj.weight"),
}
_TP_BIASES = ("attn.q.bias", "attn.k.bias", "attn.v.bias")


@dataclasses.dataclass(frozen=True)
class TpSplit:
    """What of one block the training stack splits over ``size`` tp ranks.

    ``attn``: "local" (each rank its ``H/T`` query heads and ``KV/T`` KV
    heads), "shared" (``H/T`` query heads over KV head ``rank // (T/KV)``,
    the k/v leaves gathered whole), "context" (Ulysses-style, where T does
    not divide the heads: each rank projects its ``H hd/T`` and ``KV hd/T``
    columns, one all-to-all trades the q columns for the rank's ``S/T``
    query rows of every head, one all-gather over tp joins k and v whole,
    and the out all-to-all trades back before the rank's rows of ``o``), or
    None.  ``ffn``: "dense" or "moe" (each rank its ``ff/T`` columns of the
    FFN or of every expert), or None.  ``ssm``: "channels" (a Mamba mixer
    on the rank's ``d_inner/T`` channels, ``models/ssm.py::
    mamba_apply_tp``), or None.  ``whole``: the sublayers that compute
    whole on every tp rank ("attn" where neither the heads nor their
    widths and the length divide, "mamba" where ``d_inner`` does not
    divide, "dense" or "moe" where ``ff`` does not divide, "moe_ep")."""

    size: int
    attn: str | None = None
    ffn: str | None = None
    whole: tuple[str, ...] = ()
    ssm: str | None = None

    def kv_heads(self, kv: int, rank: int) -> tuple[int, int]:
        """``(first, count)`` of the ``kv`` KV heads tp rank ``rank``
        computes: its ``kv/T`` when "local", the one it shares when
        "shared", every head "context" (its query rows see them all) and
        when attention computes whole."""
        if self.attn == "local":
            n = kv // self.size
            return rank * n, n
        if self.attn == "shared":
            return rank // (self.size // kv), 1
        return 0, kv

    def role(self, name: str) -> str | None:
        """A block leaf's role (``name`` within the block): "resident" (its
        tp dim stays on the rank), "partial" (gathered whole over tp, each
        rank using a part: its gradient is summed over tp), or None (the
        gather's default).  A replicated bias is "partial" under every
        split: sliced by heads "local" and "shared", by columns "context",
        by channels (``dt_proj``'s) "channels"; every other Mamba leaf is
        "resident" there."""
        if self.ssm is not None:
            if name in _TP_RESIDENT["mamba"]:
                return "resident"
            if name == "mamba.dt_proj.bias":
                return "partial"
        if self.attn is not None:
            if name in _TP_RESIDENT["attn"]:
                return "resident"
            if name in _TP_RESIDENT["kv"]:
                return "resident" if self.attn in ("local", "context") else "partial"
            if name in _TP_BIASES:
                return "partial"
        if self.ffn is not None and name in _TP_RESIDENT["ffn"]:
            return "resident"
        return None


def tp_split(cfg, pos: int, plan: ShardingPlan | None, seq: int | None = None) -> TpSplit:
    """The split of the block at pattern position ``pos`` on ``plan``'s tp
    axes (T ranks; arithmetic on ``cfg``, the plan and the training call's
    length ``seq``, None where the caller has none).  Attention splits by
    heads when ``H % T == 0`` and ``KV % T == 0`` ("local") or ``T % KV ==
    0`` ("shared"); else context-parallel ("context") when T divides ``H
    hd``, ``KV hd`` and ``seq`` (the reference's ``attn_q`` spec: qwen2-7b's
    28/4 and internvl2-1b's 14/2 heads at T 16); a Mamba mixer by
    channels ("channels") when ``d_inner % T == 0`` (the reference's specs
    put ``d_inner`` on tp); a dense FFN, or a MoE FFN on ``moe_apply``,
    when ``ff % T == 0``.  ``moe_impl="ep"`` over several expert ranks
    computes whole, as does a sublayer whose widths do not divide.  Serving
    takes :func:`serving_split`."""
    t = plan.tp_size if plan is not None and plan.tp else 1
    if t == 1:
        return TpSplit(1)
    attn = ffn = ssm = None
    whole = []
    if cfg.pattern[pos] == "mamba":
        if cfg.ssm_expand * cfg.d_model % t == 0:
            ssm = "channels"
        else:
            whole.append("mamba")
    else:
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        if h % t == 0 and (kv % t == 0 or t % kv == 0):
            attn = "local" if kv % t == 0 else "shared"
        elif h * hd % t == 0 and kv * hd % t == 0 and (seq is None or seq % t == 0):
            attn = "context"
        else:
            whole.append("attn")
    if cfg.d_ff > 0:
        kind = cfg.ffn_kind(pos)
        if kind == "moe" and cfg.moe_impl == "ep" and plan.ep_size > 1:
            whole.append("moe_ep")
        elif cfg.d_ff % t == 0:
            ffn = kind
        else:
            whole.append(kind)
    return TpSplit(t, attn, ffn, tuple(whole), ssm)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on a plan's tp axes: ``rank`` of ``size``, and the
    all-reduces that bracket a split sublayer over the axes' group."""

    mesh: Any
    axes: tuple[str, ...]
    size: int
    rank: int

    def copy(self, x: torch.Tensor, counts: dict | None = None) -> torch.Tensor:
        """``dist.plan.copy_to_group``: in front of the column-parallel
        products (its backward's all-reduce counted in ``counts`` too)."""
        return copy_to_group(x, self.mesh, self.axes, counts)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``dist.plan.reduce_from_group``: after the row-parallel ones."""
        return reduce_from_group(x, self.mesh, self.axes)

    @property
    def group(self):
        return self.mesh.group(self.axes)


def tp_rank(plan: ShardingPlan | None, coords: Mapping[str, int] | None = None) -> int:
    """The position of the entry at ``coords`` (this rank's by default)
    along ``plan``'s tp axes, in their order; 0 without tp axes."""
    axes = _entry_axes(plan.tp) if plan is not None else ()
    if not axes:
        return 0
    coords = plan.mesh.coords() if coords is None else coords
    k = 0
    for a in axes:
        k = k * plan.mesh.shape[a] + coords[a]
    return k


def tensor_parallel(layout: "StateLayout | None") -> TensorParallel | None:
    """Where a sharded state's compute splits over tp: its plan's tp axes
    when they span several ranks, else None (no layout, or T = 1)."""
    if layout is None or not layout.plan.tp or layout.plan.tp_size == 1:
        return None
    return TensorParallel(layout.mesh, _entry_axes(layout.plan.tp), layout.plan.tp_size,
                          tp_rank(layout.plan, layout.coords))


def serving_split(cfg, pos: int, plan: ShardingPlan | None) -> TpSplit:
    """:func:`tp_split` for serving: "context" attention computes whole
    (counted in ``whole``), since a decode step has one query row per
    sequence to split and context-parallel prefill is ROADMAP.md Queue A 5's
    later item; so does a Mamba mixer, whose per-slot state holds every
    channel (Mamba channels when serving: a later Queue A 5 item); every
    other split as in training."""
    split = tp_split(cfg, pos, plan)
    if split.attn == "context":
        split = dataclasses.replace(split, attn=None, whole=("attn",) + split.whole)
    if split.ssm is not None:
        split = dataclasses.replace(split, ssm=None, whole=("mamba",) + split.whole)
    return split


def serving_kv_heads(cfg, pos: int, plan: ShardingPlan | None, rank: int | None = None
                     ) -> tuple[int, int]:
    """``(first, count)``: the KV heads of pattern position ``pos`` that tp
    rank ``rank`` of ``plan`` (default: this rank's, :func:`tp_rank`)
    computes when serving, and so holds in its block pool, rings and dense
    cache (arithmetic on ``cfg`` and the plan only).  By
    :func:`serving_split`: every head where attention computes whole (T =
    1, heads that do not divide, a Mamba position); ``[t KV/T, (t+1) KV/T)`` "local" (the
    reference's ``cache_pspecs`` rule, kv heads over tp); head ``t //
    (T/KV)`` whole "shared" (the reference shards ``head_dim`` there and
    holds ``KV/T`` of a head a rank: the port holds T/KV times as much, so
    that the paged-decode and chunk kernels read whole scores)."""
    split = serving_split(cfg, pos, plan)
    if split.attn is None:
        return 0, cfg.num_kv_heads
    return split.kv_heads(cfg.num_kv_heads, tp_rank(plan) if rank is None else int(rank))


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """One parameter's place in a :class:`StateLayout`: its name, whole
    shape, ``(dim, axes)`` of each sharded dim, and whether it is a MoE
    expert tensor (whose expert dim stays resident under ``moe_ep``)."""

    name: str
    shape: tuple[int, ...]
    dims: tuple[tuple[int, tuple[str, ...]], ...]
    expert: bool

    @property
    def spec(self) -> P:
        ent: list = [None] * len(self.shape)
        for d, axes in self.dims:
            ent[d] = axes[0] if len(axes) == 1 else axes
        return P(*ent)


class StateLayout:
    """Where each parameter-shaped leaf of a training state is sharded, on
    one rank of a rank mesh.  Leaves are in ``named_parameters`` order (the
    momenta's and ``grad_sum``'s order too).  ``ep_resident``: under
    ``moe_impl="ep"`` the experts stay on their ranks and the tokens move
    (``models/moe_ep.py``), so a block's gather leaves their expert dim
    alone.  Shared, never copied (``copy.deepcopy`` returns it)."""

    def __init__(self, plan: ShardingPlan, leaves: Sequence[LeafShard],
                 ep_resident: bool = False):
        self.plan = plan
        self.mesh = plan.mesh
        self.leaves = list(leaves)
        self.by_name = {leaf.name: leaf for leaf in self.leaves}
        self.ep_resident = bool(ep_resident)
        self.coords = self.mesh.coords()
        dp = set(plan.dp)
        #: per leaf, the data-parallel axes of several ranks its gather's
        #: backward does not reduce over (the step all-reduces the gradient
        #: over them)
        self.rest: list[tuple[str, ...]] = []
        for leaf in self.leaves:
            covered = {a for _, axes in leaf.dims for a in axes}
            self.rest.append(tuple(a for a in self.mesh.axis_names
                                   if a in dp and a not in covered and self.mesh.shape[a] > 1))

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        n = sum(1 for leaf in self.leaves if leaf.dims)
        return f"StateLayout({n} of {len(self.leaves)} leaves sharded on {self.mesh!r})"

    # -- shapes ----------------------------------------------------------------
    def local_shape(self, name: str) -> tuple[int, ...]:
        leaf = self.by_name[name]
        return local_shape(leaf.shape, leaf.spec, self.plan)

    def resident(self, leaf: LeafShard, role: str | None = None, ep: bool = True
                 ) -> tuple[tuple[int, tuple[str, ...]], ...]:
        """The sharded dims a block's gather leaves alone: an expert tensor's
        expert dim under ``ep_resident`` (unless ``ep`` is False), and the
        tp dim of a leaf whose role in a split block is "resident"
        (:meth:`TpSplit.role`; raises when the leaf is not sharded over all
        the tp axes)."""
        keep: tuple = ()
        if ep and self.ep_resident and leaf.expert:
            keep = tuple((d, axes) for d, axes in leaf.dims if axes == tuple(self.plan.ep))
        if role == "resident":
            tp = _entry_axes(self.plan.tp)
            mine = tuple((d, axes) for d, axes in leaf.dims if axes == tp)
            if not mine:
                raise ValueError(f"{leaf.name} is split over tp {tp} but sharded {leaf.dims}")
            keep += mine
        return keep

    # -- data ------------------------------------------------------------------
    def shard(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole leaf named ``name``."""
        return shard(tensor, self.by_name[name].spec, self.plan)

    def unshard(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        """The whole leaf ``name`` from the shards (a collective); a whole
        tensor comes back as it is."""
        leaf = self.by_name[name]
        if tuple(tensor.shape) == leaf.shape:
            return tensor
        return unshard(tensor, leaf.spec, self.plan)

    def gather(self, names: Sequence[str], tensors: Sequence[torch.Tensor],
               keep_resident: bool = True, roles: Mapping[str, str | None] | None = None
               ) -> list[torch.Tensor]:
        """The tensors whole under autograd (``dist.plan.gather_shards``):
        the sharded ones that are still shards (a whole tensor, as in the
        exact tier's per-sample pass, passes through), all in one gather per
        axis group and dtype; expert dims stay resident under
        ``ep_resident`` unless ``keep_resident`` is False.  ``roles`` (a
        split block's, :meth:`TpSplit.role` by name): a "resident" leaf
        keeps its tp dim; a "partial" one is gathered whole with its
        gradient summed over tp, and one the specs leave whole over tp (a
        bias) passes through ``copy_to_group``."""
        out = list(tensors)
        roles = roles or {}
        tp = _entry_axes(self.plan.tp)
        pick, dims, summed, copied = [], [], [], []
        for i, (n, t) in enumerate(zip(names, tensors)):
            leaf = self.by_name.get(n)
            if leaf is None:
                continue
            role = roles.get(n)
            if role == "partial" and not any(axes == tp for _, axes in leaf.dims):
                copied.append(i)
            if not leaf.dims or tuple(t.shape) == leaf.shape:
                continue
            keep = self.resident(leaf, role, ep=keep_resident)
            todo = [e for e in leaf.dims if e not in keep]
            if todo:
                pick.append(i)
                dims.append(todo)
                summed.append(role == "partial")
        if pick:
            whole = gather_shards([tensors[i] for i in pick], dims, self.mesh, self.plan.dp,
                                  summed)
            for i, w in zip(pick, whole):
                out[i] = w
        for i in copied:
            out[i] = copy_to_group(out[i], self.mesh, tp)
        return out

    # -- gradients and norms ---------------------------------------------------
    @torch.no_grad()
    def finish_grads(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Gradient shards (each rank's own samples' where the gather's
        backward did not average them) into the global microbatch mean: an
        all-reduce mean over the data-parallel axes each leaf's gather did
        not cover (one per axis group and dtype), and for resident experts a
        division by the expert ranks (their tokens' gradients came back
        summed over the ranks that sent them).  Nothing over tp, which is
        not a data axis: under tensor-parallel compute a split leaf's
        gradient is already its shard's, and a partial leaf's came back
        summed over tp (``TpSplit.role``)."""
        out = list(grads)
        by_rest: dict[tuple[str, ...], list[int]] = {}
        for i, (leaf, rest) in enumerate(zip(self.leaves, self.rest)):
            if self.resident(leaf):
                out[i] = out[i] / self.plan.ep_size
            elif rest:
                by_rest.setdefault(rest, []).append(i)
        for rest, idx in by_rest.items():
            n = self.plan.axis_size(rest)
            red = all_reduce_mean([out[i] for i in idx], self.mesh.group(rest), n)
            for i, r in zip(idx, red):
                out[i] = r
        return out

    def owned(self, i: int) -> bool:
        """Whether this rank counts leaf ``i``'s shard in a norm: it holds
        position 0 on every axis the leaf is not sharded over (so each
        element counts once over the mesh; a leaf replicated over tp, the
        same on every tp rank under split compute too, counts on tp rank
        0)."""
        covered = {a for _, axes in self.leaves[i].dims for a in axes}
        return all(self.coords[a] == 0 for a in self.mesh.axis_names if a not in covered)

    @torch.no_grad()
    def sq_norm(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The squared L2 norm of the whole tree from its shards: per leaf
        the float32 norm squared, the leaves this rank does not own zeroed,
        summed, then summed over the mesh (one all-reduce)."""
        norms = torch.stack([torch.linalg.vector_norm(x, dtype=torch.float32)
                             for x in tensors]).square()
        mask = torch.tensor([self.owned(i) for i in range(len(tensors))],
                            dtype=torch.float32, device=norms.device)
        total = (norms * mask).sum()
        return all_reduce_sum_(total, self.mesh.group(self.mesh.axis_names))

    def numel(self) -> int:
        """Elements of the parameters this rank holds."""
        return sum(math.prod(self.local_shape(leaf.name)) for leaf in self.leaves)


def state_layout(model: torch.nn.Module, plan: ShardingPlan | None) -> StateLayout | None:
    """The layout of ``model``'s parameters (whole shapes) on ``plan``; None
    when ``plan`` holds no sharded state (:func:`shards_state`) or its
    specs shard nothing."""
    if not shards_state(plan):
        return None
    from repro_torch.models.moe import MoE

    experts = {f"{name}.{p}" for name, mod in model.named_modules() if isinstance(mod, MoE)
               for p in ("w_gate", "w_up", "w_out")}
    leaves = []
    full = full_shapes(model)
    specs = param_pspecs(model, plan)
    for name, shape in full.items():  # named_parameters order
        leaves.append(LeafShard(name, shape, tuple(_sharded_dims(specs[name])),
                                name in experts))
    if not any(leaf.dims for leaf in leaves):
        return None
    cfg = getattr(model, "cfg", None)
    ep = cfg is not None and getattr(cfg, "moe_impl", None) == "ep" and plan.ep_size > 1
    return StateLayout(plan, leaves, ep_resident=ep)


def layout_of(model: Any) -> StateLayout | None:
    """The :class:`StateLayout` a model's parameters are sharded by (None
    for whole parameters)."""
    return getattr(model, "shard_layout", None)


def full_shapes(model: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    """Every parameter's whole shape (its shard's under a layout)."""
    lay = layout_of(model)
    if lay is not None:
        return {leaf.name: leaf.shape for leaf in lay.leaves}
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


@contextlib.contextmanager
def gathered(module: torch.nn.Module, layout: StateLayout | None, prefix: str = "",
             keep_resident: bool = True, split: TpSplit | None = None
             ) -> Iterator[torch.nn.Module]:
    """``module`` with its sharded parameters swapped for whole tensors
    (gathered under autograd, one call per axis group and dtype) for the
    block's extent; ``prefix`` is the module's name in the layout's model,
    ``keep_resident`` as in :meth:`StateLayout.gather`.  ``split`` (the
    training stack's, on a tp plan): the block's split leaves keep their
    tp dim, its partial ones are gathered for a sum (:meth:`TpSplit.role`).
    No layout: the module as it is."""
    if layout is None:
        yield module
        return
    names, owners, tensors, roles = [], [], [], {}
    for name, p in module.named_parameters():
        leaf = layout.by_name.get(prefix + name)
        role = split.role(name) if split is not None else None
        if leaf is not None and (leaf.dims or role == "partial"):
            names.append(prefix + name)
            roles[prefix + name] = role
            mod, _, attr = name.rpartition(".")
            owners.append((module.get_submodule(mod), attr))
            tensors.append(p)
    whole = layout.gather(names, tensors, keep_resident, roles)
    saved = []
    try:
        for (mod, attr), w in zip(owners, whole):
            saved.append((mod, attr, mod._parameters[attr]))
            mod._parameters[attr] = w
        yield module
    finally:
        for mod, attr, p in reversed(saved):
            mod._parameters[attr] = p
