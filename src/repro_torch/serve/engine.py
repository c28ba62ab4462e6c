"""ServeEngine — continuous-batching prefill/decode over a paged KV block pool.

Counterpart of ``repro/serve/engine.py`` on one device, with the same host
logic token for token: the ``Scheduler`` (admission queue, slot refill at
every step boundary, per-slot EOS/max-token retirement), the ``ServePolicy``
boundary (retire -> observe -> resize -> admit), the ``BlockPool`` host
accounting with reservations and chain-hashed prefix sharing, per-request
block tables, and chunked prefill interleaved with decode (one chunk per
pending prompt per boundary).  A config with sliding-window layers (gemma2)
carries their rings per slot and in each prefill job's row, and adopts
shared prefix blocks only on full-prompt hits, whose cached row holds the
rings; a config whose every layer is paged also adopts a partial prefix.
Prompts are tokens, as in the reference: an embedding-input config is
refused (it serves through ``transformer.prefill_step`` and
``decode_step``).

What differs from the reference:

  * eager PyTorch on ``device`` (default ``"cuda"``, which raises without a
    Hopper card) when no plan is given; under a plan (``use_plan``, or the
    live rung of ``elastic=``) on the device its mesh names for this
    process (``Mesh.physical_device``).  The pool, the per-slot lengths
    and the block copies of copy-on-write are updated in place, the
    counterpart of the reference's buffer donation.  Attention runs
    through ``kernels/attention.py``.
  * no compilation: the reference's AOT compile cache becomes accounting of
    the distinct program keys the engine uses, each carrying the rung as
    the reference's do, so ``ServeStats`` keeps its keys and ``compiles ==
    len(set(zip(buckets, rungs)))`` still holds (``compile_s`` stays 0).
  * the categorical sampler seeds a ``torch.Generator`` from
    ``(seed, rid, pos)``: per-request deterministic whatever the slot layout,
    but not the reference's ``jax.random`` stream.  Greedy sampling carries
    token identity across the two packages.

Elastic serving and plans.  ``elastic=MeshLadder(...)`` follows the live
slot bucket up and down the ladder (``rung_for_batch``) at the boundary
that resizes the bucket, with a ``reshard`` span and run-log event, as the
reference does; ``elastic=`` under an ambient plan is ambiguous and
raises.  A local rung (every entry a ``torch.device`` of this process, the
default eight virtual devices of the card) keeps whole leaves on its one
physical device, so a rung change moves no byte.  On a rank rung
(``dist.plan.rank_devices``) that shards:

  * the parameters are this rank's shards by the reference's rules
    (``elastic.reshard.place``: ``fsdp = ep =`` the data axis, ``tp =`` the
    model axes), and ``decode_step``/``prefill_chunk`` gather one block at
    a time; a rung change gathers over the source rung and slices for the
    destination, and a rank outside the destination keeps the whole model
    and waits, running the host engine all the same;
  * the slot cache's rows follow ``dist.sharding.cache_pspecs``: a batch
    axis the data axis divides is split into contiguous rows a rank, which
    that rank decodes (free lanes included, with its slice of the tokens
    and tables); otherwise (a bucket the rung's width does not divide)
    every rank decodes every row.  ``len`` stays whole.  At a resize and a
    rung change the rows move whole: gathered over the source, sliced for
    the destination;
  * every token the engine records is agreed over the ladder's control
    group (an all-reduce of each rank's own rows; the rung's first rank
    speaks for rows it computes with the others, ranks outside the rung
    contribute nothing), and so is the policy's decision, so every rank's
    ``Scheduler``, ``BlockPool`` and policy take the same decisions and
    issue the same collectives in the same order.

Tensor-parallel serving: on a rank rung or plan whose tp axes (the
ladder's ``model_axes``, a ``(data, model)`` plan) span T > 1 ranks, each
block splits over them as ``models/transformer.py`` describes (a rank's
query heads, KV heads and FFN columns, two all-reduces a layer; the
embedding and the head from their tp shards), and the pool, the slot
cache's rings and dense caches, the prefill rows and the cached prompt
rows hold only the rank's KV heads (``dist.sharding.serving_kv_heads`` on
the ladder's widest rung: ``MeshLadder`` keeps the model axes, so a rank
keeps its tp coordinate, and its heads, on every rung).  That is the
reference's ``cache_pspecs`` kv-heads rule, but where T ranks share a KV
head: the port holds that head whole on each of them (the reference
splits its ``head_dim``; ROADMAP.md Queue C 3).  The rows of a data row
group are decoded by each of its T ranks alike, so only tp coordinate 0
of each group contributes them to the token agreement, and the state a
rank that enters a rung takes comes from the first rank of its own tp
coordinate, over the data axes.

Two layouts differ from the reference's (ROADMAP.md Queue A 5): the
pool's block axis stays whole on every rank of a data row (each decode
step all-gathers the rows' newly written K/V entries over the data axes,
``rows x layers x 2 x kv x hd`` elements of the rank's heads, so the pools
of a tp coordinate stay equal; the reference puts its block axis on dp),
and a prefill chunk (one row) runs on every data row of the rung (the
reference falls back to the sequence axis).  ``moe_impl="ep"`` is refused
on ranks (Queue A 5): serving gathers the experts over the data axes.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.adapt.signals import Clock, ThroughputWindow
from repro_torch.ckpt.checkpoint import _unflatten, tree_flatten_with_paths
from repro_torch.configs.base import ModelConfig
from repro_torch.core.batch_policy import bucket
from repro_torch.dist import sharding
from repro_torch.dist.plan import (all_gather_dim, all_reduce_sum_, broadcast_, broadcast_object,
                                   current_plan, process_rank)
from repro_torch.elastic.ladder import MeshLadder
from repro_torch.elastic.reshard import place
from repro_torch.models import transformer as tf
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import runlog as runlog_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.serve.blocks import BlockPool, chain_keys
from repro_torch.serve.policy import (
    FifoPolicy,
    QueuedRequest,
    ServePolicy,
    ServeSignals,
    make_serve_policy,
)
from repro_torch.serve.scheduler import Admission, Request, Result, Scheduler, slots_for

SAMPLERS = ("greedy", "categorical")


def padded_prompt_len(n: int, granule: int) -> int:
    """Smallest pow2 prompt bucket (``granule * 2^i``) holding ``n`` tokens.

    Prompts are LEFT-padded to their own bucket independently of what they
    are batched with, so a request's padding — and therefore its tokens —
    never depends on its co-scheduled neighbours.  Prefix sharing hashes the
    PADDED stream for the same reason."""
    return bucket(max(int(n), 1), max(int(granule), 1), "pow2",
                  m_min=max(int(n), 1))


def _axis(t: torch.Tensor) -> int:
    """Batch axis of a per-slot state leaf: 0 for the ``len`` vector, 1
    after the repeats axis for every layer leaf."""
    return 0 if t.dim() == 1 else 1


def _gather_rows(cache: dict, idx: torch.Tensor) -> dict:
    """Re-index the batch axis: ``new[i] = old[idx[i]]`` (compaction,
    growth, any slot permutation)."""
    return {key: _gather_rows(x, idx) if isinstance(x, dict)
            else x.index_select(_axis(x), idx) for key, x in cache.items()}


def _copy_block(pages: dict, src: int, dst: int) -> None:
    """Device side of copy-on-write: duplicate pool block ``src`` into
    ``dst`` across every paged position (block axis 1), in place."""
    for leaf in pages.values():
        for x in leaf.values():
            x[:, dst] = x[:, src]


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


@dataclasses.dataclass
class _BlockState:
    """Host bookkeeping for one request's slice of the pool."""

    tokens: np.ndarray  # the PADDED prompt (plen,)
    plen: int
    budget: int
    nb_prompt: int  # prompt blocks (plen // block_size)
    total_need: int  # worst-case blocks (prompt + decode budget)
    keys: list  # chain keys of the padded prompt ([] with sharing off)
    table: list[int] = dataclasses.field(default_factory=list)
    reserved: int = 0  # outstanding pool credits
    shared: int = 0  # blocks adopted from the prefix registry
    pos: int = 0  # tokens resident on device (mirror of cache["len"])
    ent: dict | None = None  # full-prompt cache hit staged by the gate


@dataclasses.dataclass
class _PrefillJob:
    """A prompt mid-load: one chunk advances per boundary."""

    rid: int
    off: int  # next chunk's first position (block-aligned)
    row: dict  # carried per-request state ({"len": (1,)} and the rings)
    stepped: bool = False


class ServeStats(metrics_lib.StatsView):
    """Observable serving behaviour, with the reference's ``as_dict()`` keys.

    ``compiles`` counts distinct decode program keys ``(bucket, rung)``, so
    ``compiles == len(set(zip(buckets, rungs)))``; ``bucket_hits``/
    ``bucket_misses`` count decode lookups (one per decode step).
    ``prefill_compiles`` counts distinct (chunk, prior-block bucket, rung)
    prefill keys, ``aux_compiles`` the insert/gather/sample/cow keys.  Eager
    PyTorch compiles nothing, so ``compile_s`` stays 0.  ``slot_steps`` is
    the total decoded lanes; ``tokens`` counts tokens delivered to requests;
    ``prefills`` counts requests whose prompt became resident (shared-prefix
    instant hits included); ``prefill_chunks`` counts chunks actually run;
    ``shared_prefill_hits``/``shared_blocks`` count full-prompt hits and
    adopted pool blocks; ``pool_blocks``/``peak_blocks`` give the pool
    capacity and the peak live block count.  ``tokens_per_sec`` is the
    windowed rate (``adapt.signals.ThroughputWindow``).  ``donate`` is True:
    the state is updated in place.
    """

    _COUNTERS = (
        "compiles", "bucket_hits", "bucket_misses", "prefill_compiles",
        "aux_compiles", "steps", "slot_steps", "tokens", "prefills",
        "prefill_chunks", "shared_prefill_hits", "shared_blocks",
        "reshards", "resizes",
    )
    _GAUGES = (
        "cow_copies", "pool_blocks", "peak_blocks", "block_size",
        "retired", "compile_s", "dispatch_wall_s", "tokens_per_sec",
    )

    def __init__(self, pool_blocks: int = 0, block_size: int = 0, *,
                 registry: metrics_lib.Registry | None = None):
        self.donate = True
        self.buckets: list[int] = []
        self.rungs: list = []
        self._init_metrics("serve.engine", registry)
        self.pool_blocks = pool_blocks
        self.block_size = block_size

    def as_dict(self) -> dict:
        d = {f: getattr(self, f) for f in (
            "compiles", "bucket_hits", "bucket_misses", "prefill_compiles",
            "aux_compiles", "steps", "slot_steps", "tokens", "prefills",
            "prefill_chunks", "shared_prefill_hits", "shared_blocks",
            "cow_copies", "pool_blocks", "peak_blocks", "block_size",
            "retired", "reshards", "resizes", "compile_s",
            "dispatch_wall_s", "tokens_per_sec",
        )}
        d["donate"] = self.donate
        d["buckets"] = list(self.buckets)
        d["rungs"] = list(self.rungs)
        return d


class ServeEngine:
    """Continuous-batching serving of a ported model over a paged KV cache.

    ``submit``/``step`` is the streaming interface; ``generate(requests)``
    submits everything, drains, and collects.  The engine takes ``params``
    over: it moves them to its device and, on a rank rung that shards,
    keeps this rank's shards of them in place (``elastic.reshard.place``)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: tf.Transformer,
        *,
        device: str | torch.device | None = None,
        max_slots: int = 8,
        max_seq: int = 1024,
        sampler: str = "greedy",
        temperature: float = 1.0,
        seed: int = 0,
        slot_granule: int = 1,
        prompt_granule: int = 8,
        shrink_patience: int = 2,
        block_size: int | None = None,
        pool_blocks: int | None = None,
        prefill_chunk: int = 0,
        prefix_sharing: bool = True,
        policy: ServePolicy | str | None = None,
        tracer=None,
        runlog=None,
        obs_window: int = 16,
        elastic: MeshLadder | None = None,
    ):
        if elastic is not None and not isinstance(elastic, MeshLadder):
            raise TypeError(f"elastic= takes a MeshLadder, got {type(elastic).__name__}")
        plan = current_plan()
        if elastic is not None and plan is not None:
            raise ValueError(
                "ServeEngine(elastic=...) under an ambient dist plan is "
                "ambiguous: the ladder owns the sharding plan per rung — "
                "drop the use_plan context (or the elastic ladder)"
            )
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
        if cfg.input_mode != "tokens" or not cfg.causal:
            raise ValueError(
                f"ServeEngine serves causal token-prompt configs, not {cfg.name!r} "
                f"(input_mode {cfg.input_mode!r}, causal {cfg.causal}); an "
                f"embedding-input decoder serves through transformer.prefill_step "
                f"and decode_step")
        self._elastic = elastic
        self._plan = plan
        self._rung = elastic.rungs[0] if elastic is not None else None
        mesh = elastic.full.plan.mesh if elastic is not None else (
            plan.mesh if plan is not None else None)
        #: whether the engine runs over ranks (a ladder or plan of RankDevice entries)
        self._ranked = mesh is not None and mesh.ranked
        if mesh is None:
            self.device = resolve_device(DEFAULT_DEVICE if device is None else device)
        else:
            self.device = mesh.physical_device()
            if device is not None and not _same_device(torch.device(device), self.device):
                raise ValueError(f"device={device} but the plan's mesh runs this process "
                                 f"on {self.device}")
        if self._ranked and cfg.moe_impl == "ep":
            raise NotImplementedError(
                "moe_impl='ep' while serving over ranks is not ported (ROADMAP.md "
                "Queue A 5): serve with the experts gathered whole (moe_impl='gspmd')")
        if self._ranked:
            # the group every rank's tokens and the policy's decisions are agreed over
            self._control = elastic.control() if elastic is not None else (
                mesh.group(mesh.axis_names), mesh.group_ranks(mesh.axis_names))
        # the KV heads this rank serves: its tp coordinate's on the widest rung
        widest = elastic.full.plan if elastic is not None else plan
        self._kv_heads = tf.serving_kv_heads(cfg, widest)
        self._tp_rank = sharding.tp_rank(widest) if sharding.shards_state(widest) else 0
        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.sampler = sampler
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.prompt_granule = int(prompt_granule)
        self.prefix_sharing = bool(prefix_sharing)
        self.block_size = int(block_size) if block_size else self.prompt_granule
        if self.prompt_granule % self.block_size:
            raise ValueError(
                f"prompt_granule {self.prompt_granule} must be a multiple of "
                f"block_size {self.block_size} (prompts pad to whole blocks)"
            )
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk and self.prefill_chunk % self.block_size:
            raise ValueError(
                f"prefill_chunk {self.prefill_chunk} must be a multiple of "
                f"block_size {self.block_size}"
            )
        self.sched = Scheduler(self.max_slots, granule=slot_granule)
        self.params = params.to(self.device)
        if self._live_plan is not None:
            self.params = place(self.params, self._live_plan)
        self._cache: dict | None = None
        self._bucket = 0
        # grow immediately, shrink only once the smaller target has held for
        # ``shrink_patience`` consecutive boundaries
        self.shrink_patience = int(shrink_patience)
        self._shrink_streak = 0
        if policy is None:
            policy = FifoPolicy()
        elif isinstance(policy, str):
            policy = make_serve_policy(policy)
        self.policy = policy
        self._slot_budget: int | None = None  # persists until a decision moves it
        self._adm_order: list[int] | None = None  # this boundary's ordering
        self._programs: set[tuple] = set()
        # -- the paged pool -------------------------------------------------
        # table capacity: logical positions may run past max_seq by the
        # prompt's padding slack, < max(granule, max_seq/2) on the pow2 lattice
        span = self.max_seq + max(self.prompt_granule, self.max_seq // 2)
        self._n_max = -(-span // self.block_size)
        self._paged = tf.paged_positions(self.cfg)
        # a partial chain match only covers full-attention state (it lives in
        # the pool); configs with rings share only on full-prompt hits
        self._row_trivial = len(self._paged) == self.cfg.period
        if pool_blocks is None:
            # pow2 default: worst-case credits for every slot + the sentinel
            pool_blocks = padded_prompt_len(1 + self.max_slots * self._n_max, 1)
        self.pool = BlockPool(int(pool_blocks), self.block_size)
        self._pages = tf.init_pages(self.cfg, int(pool_blocks), self.block_size,
                                    device=self.device, kv_heads=self._kv_heads)
        self._req_blocks: dict[int, _BlockState] = {}
        self._jobs: list[_PrefillJob] = []
        self._prompt_cache: collections.OrderedDict = collections.OrderedDict()
        self._prompt_cache_cap = 256
        self.stats = ServeStats(pool_blocks=self.pool.num_blocks,
                                block_size=self.block_size)
        self._thru = ThroughputWindow()
        self.tracer = tracer if tracer is not None else trace_lib.NULL
        self.runlog = runlog if runlog is not None else runlog_lib.NULL
        self.pool.tracer = self.tracer
        #: emit a ``serve_window`` run-log event every this many decode steps
        self.obs_window = int(obs_window)

    # -- plumbing ------------------------------------------------------------
    @property
    def _live_plan(self):
        return self._rung.plan if self._rung is not None else self._plan

    @property
    def _rung_token(self):
        return self._rung.index if self._rung is not None else None

    @property
    def rung(self):
        """The live elastic ladder rung (None outside elastic mode)."""
        return self._rung

    @property
    def busy(self) -> bool:
        return self.sched.has_work

    @property
    def _active(self) -> bool:
        """Whether this process computes on the live rung (every process
        does off ranks; a rank outside a rank rung waits)."""
        plan = self._live_plan
        return plan is None or not plan.mesh.ranked or plan.mesh.is_member

    @property
    def _speaks(self) -> bool:
        """Whether this process's tokens count for rows every rank of the
        rung computes alike: off ranks always; on ranks the rung's first."""
        return not self._ranked or (self._active
                                    and process_rank() == self._live_plan.mesh.root)

    def _agree(self, toks, n: int) -> np.ndarray:
        """The ``n`` tokens every rank records: ``toks`` off ranks; on ranks
        the sum over the control group of each rank's contribution (its own
        entries, zeros elsewhere; ``None`` contributes nothing: so at most
        one rank contributes any entry)."""
        if not self._ranked:
            return np.asarray(toks)
        buf = torch.zeros(n, dtype=torch.int64)
        if toks is not None:
            buf.copy_(torch.from_numpy(np.asarray(toks, np.int64)))
        group = self._control[0]
        if dist.get_backend(group) == "nccl":
            buf = buf.to(self.device)
        all_reduce_sum_(buf, group)
        return buf.cpu().numpy()

    # -- the rows of a rank rung --------------------------------------------
    def _splits(self) -> bool:
        plan = self._live_plan
        return self._ranked and sharding.shards_state(plan) and plan.dp_size > 1

    def _row_range(self, bucket: int) -> tuple[int, int]:
        """The slots ``[lo, hi)`` this rank decodes: its contiguous share when
        the rung's data axes divide ``bucket`` (the batch rule of
        ``cache_pspecs``), else every slot."""
        if not (self._splits() and bucket):
            return 0, bucket
        plan = self._live_plan
        entry = sharding.fit_axes(bucket, plan.dp, plan)
        if entry is None:
            return 0, bucket
        rows = sharding.local_slices((bucket,), (entry,), plan.mesh.shape,
                                     plan.mesh.coords())[0]
        return rows.start, rows.stop

    def _row_axes(self, tree: dict, bucket: int) -> dict[str, tuple[str, ...]]:
        """``{path: data axes}`` of the slot-cache leaves whose batch rows
        are split on the live rung: ``cache_pspecs`` of the whole leaves
        (``bucket`` rows), its batch entries over the data axes kept (the
        port keeps every other dim whole)."""
        if not (self._splits() and bucket):
            return {}
        plan = self._live_plan
        shapes = {}
        for path, t in tree_flatten_with_paths(tree):
            shape = list(t.shape)
            shape[_axis(t)] = bucket
            shapes[path] = tuple(shape)
        out = {}
        for path, spec in sharding.cache_pspecs(shapes, plan).items():
            e = spec[0 if len(shapes[path]) == 1 else 1]
            axes = (e,) if isinstance(e, str) else tuple(e or ())
            if axes and set(axes) <= set(plan.dp):
                out[path] = axes
        return out

    def _local_rows(self, whole: dict, bucket: int) -> dict:
        """This rank's rows of a whole slot cache (the counterpart of the
        reference's ``_place_cache`` of the slot cache: the leaves ``_row_axes``
        splits; the others as they are)."""
        axes = self._row_axes(whole, bucket)
        if not axes:
            return whole
        lo, hi = self._row_range(bucket)
        return _unflatten(whole, iter(t.narrow(_axis(t), lo, hi - lo).contiguous()
                                      if p in axes else t
                                      for p, t in tree_flatten_with_paths(whole)))

    def _whole_rows(self, local: dict, bucket: int) -> dict:
        """The whole slot cache from every rank's rows (an all-gather over
        the rung's data axes; a collective over them)."""
        axes = self._row_axes(local, bucket)
        if not axes:
            return local
        leaves = dict(tree_flatten_with_paths(local))
        by_axes: dict = {}
        for p, a in axes.items():
            by_axes.setdefault(a, []).append(p)
        for a, paths in by_axes.items():
            whole = all_gather_dim([leaves[p] for p in paths], [_axis(leaves[p]) for p in paths],
                                   self._live_plan.mesh, a)
            leaves.update(zip(paths, whole))
        return _unflatten(local, iter(leaves.values()))

    def _fresh_cache(self, bucket: int) -> dict:
        """A zeroed whole slot cache of ``bucket`` rows."""
        cache = tf.init_cache(self.cfg, bucket, self.max_seq, skip=self._paged,
                              device=self.device, kv_heads=self._kv_heads)
        cache["len"] = torch.zeros((bucket,), dtype=torch.int32, device=self.device)
        return cache

    def _from_root(self, tensors: list[torch.Tensor]) -> None:
        """Overwrite ``tensors`` with those of the live rung's first rank of
        this rank's tp coordinate, over the rung's data axes (the ranks that
        just entered it receive; under tp the tp ranks hold different KV
        heads, so each coordinate has its own root)."""
        plan = self._live_plan
        mesh = plan.mesh
        broadcast_(tensors, mesh.group_ranks(plan.dp)[0], mesh.group(plan.dp))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample(self, logits: torch.Tensor, rids, pos) -> torch.Tensor:
        """Next token per row of ``logits`` (R, 1, V); ``rids``/``pos`` are
        host sequences (request id, position after this token's input)."""
        if self.sampler == "greedy":
            return logits[:, -1, :].argmax(dim=-1)
        # per-row generators seeded from (engine seed, request id, position):
        # a request's stream never depends on its slot or its neighbours
        out = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
        probs = torch.softmax(logits[:, -1, :].float() / self.temperature, dim=-1)
        for i, (rid, p) in enumerate(zip(rids, pos)):
            if rid < 0:  # a free lane: nothing consumes its token
                continue
            seed = np.random.SeedSequence([self.seed, int(rid), int(p)])
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))
            out[i] = torch.multinomial(probs[i], 1, generator=gen)[0]
        return out

    def _program(self, key: tuple, kind: str = "aux") -> None:
        """Account for the program ``key`` the way the reference's compile
        cache does: the first use of a key counts as a build."""
        if key in self._programs:
            if kind == "decode":
                self.stats.bucket_hits += 1
            return
        self._programs.add(key)
        if kind == "decode":
            self.stats.bucket_misses += 1
            self.stats.compiles += 1
            self.stats.buckets.append(self._bucket)
            self.stats.rungs.append(self._rung_token)
        elif kind == "prefill":
            self.stats.prefill_compiles += 1
        else:
            self.stats.aux_compiles += 1

    # -- elastic -------------------------------------------------------------
    def _ensure_rung(self) -> bool:
        """Move the parameters onto the ladder rung for the live slot count
        (no-op off-ladder or on an unchanged rung); on ranks, the ranks that
        enter the rung take the pool, the prefill rows and the cached prompt
        rows from its first rank.  Returns whether ranks entered."""
        if self._elastic is None:
            return False
        rung = self._elastic.rung_for_batch(max(self._bucket, 1))
        if rung.index == self._rung.index:
            return False
        src = self._rung
        grew = self._ranked and bool(set(rung.plan.mesh.ranks.ravel().tolist())
                                     - set(src.plan.mesh.ranks.ravel().tolist()))
        with self.tracer.span("reshard", scope="serve", src=src.index,
                              dst=rung.index, dp=rung.dp):
            self._rung = rung
            self.params = place(self.params, rung.plan)
            if grew and self._active:
                rows = [t for _, t in tree_flatten_with_paths(self._pages)]
                for job in self._jobs:
                    rows += [t for _, t in tree_flatten_with_paths(job.row)]
                for ent in self._prompt_cache.values():
                    rows += [t for _, t in tree_flatten_with_paths(ent["row"])]
                self._from_root(rows)
        if self.runlog.enabled:
            self.runlog.emit("reshard", scope="serve", src=src.index,
                             dst=rung.index, dp=rung.dp, step=self.stats.steps)
        self.stats.reshards += 1
        return grew

    def _resize(self, target: int) -> None:
        """Track the scheduler's pow2 slot capacity: grow/shrink the per-slot
        state, compacting live rows via the scheduler's gather map (the POOL
        never resizes; tables follow their requests), then follow with the
        rung transition.  On ranks the rows move whole: gathered over the
        source rung, re-indexed, sliced for the destination."""
        if target == self._bucket:
            return
        idx = self.sched.resize(target)
        old = self._bucket
        self._bucket = target
        if target == 0:
            self._cache = None  # the pool (and its cached prefixes) persists
            return
        self.stats.resizes += 1
        if self._cache is None:
            self._ensure_rung()
            self._cache = self._local_rows(self._fresh_cache(target), target) \
                if self._active else {}
            return
        self._program(("gather", old, target, self._rung_token))
        cache = None
        if self._active:
            cache = _gather_rows(self._whole_rows(self._cache, old),
                                 self._tensor(np.asarray(idx, np.int64)))
        grew = self._ensure_rung()
        if not self._active:  # outside the rung: the rows stay with it
            self._cache = {}
            return
        if grew:
            if cache is None:  # just entered: the rows come from the first rank
                cache = self._fresh_cache(target)
            self._from_root([t for _, t in tree_flatten_with_paths(cache)])
        self._cache = self._local_rows(cache, target)

    # -- admission -----------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Queue a request; returns its id (``result(rid)`` after drain)."""
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        plen = padded_prompt_len(len(prompt), self.prompt_granule)
        if plen > self.max_seq:
            raise ValueError(
                f"prompt of {len(prompt)} tokens pads to {plen} > max_seq "
                f"{self.max_seq}"
            )
        # headroom from the TRUE prompt length: pad columns cost table
        # entries, not budget
        budget = min(int(request.max_new_tokens), self.max_seq - len(prompt) + 1)
        padded = np.zeros(plen, np.int32)
        if len(prompt):
            padded[plen - len(prompt):] = prompt  # left-pad
        nb_prompt = plen // self.block_size
        total_need = nb_prompt + -(-(budget - 1) // self.block_size)
        if total_need > self.pool.num_blocks - 1:
            raise ValueError(
                f"request needs {total_need} pool blocks but the pool holds "
                f"{self.pool.num_blocks - 1}; raise pool_blocks"
            )
        rid = self.sched.submit(request, budget=budget)
        self._req_blocks[rid] = _BlockState(
            tokens=padded, plen=plen, budget=budget, nb_prompt=nb_prompt,
            total_need=total_need,
            keys=chain_keys(padded, self.block_size) if self.prefix_sharing else [],
        )
        return rid

    def _shared_prefix(self, bs: _BlockState):
        """(adoptable prefix block ids, full-prompt cache entry or None).

        A full-chain match is an instant admission only while the prompt
        cache still holds the end-of-prompt row + logits AND the registry
        still maps the whole chain to the entry's blocks; otherwise fall
        back to a partial match capped at nb_prompt - 1, valid only for a
        config whose every position is paged: a ring's state is not in the
        pool, so such a config shares only on full-prompt hits."""
        if not self.prefix_sharing or not bs.keys:
            return [], None
        ent = self._prompt_cache.get(bs.keys[-1])
        if ent is not None:
            ids = self.pool.match(bs.keys)
            if len(ids) == bs.nb_prompt and ids == ent["ids"]:
                self._prompt_cache.move_to_end(bs.keys[-1])
                return ids, ent
            del self._prompt_cache[bs.keys[-1]]  # stale: blocks evicted
        if not self._row_trivial:
            return [], None
        return self.pool.match(bs.keys[:bs.nb_prompt - 1]), None

    def _gate(self, rid: int, request: Request) -> bool:
        """Admission gate AND claim: a passing gate adopts the shared prefix,
        reserves the rest and allocates the prompt blocks before the
        scheduler gates the next queue head in the same pass."""
        bs = self._req_blocks[rid]
        ids, ent = self._shared_prefix(bs)
        if not self.pool.feasible(ids, bs.total_need):
            return False
        for b in ids:
            self.pool.retain(b)
        self.pool.reserve(bs.total_need - len(ids))
        bs.reserved = bs.total_need - len(ids)
        bs.shared = len(ids)
        bs.table = list(ids)
        while len(bs.table) < bs.nb_prompt:
            bs.table.append(self.pool.alloc(reserved=True))
            bs.reserved -= 1
        bs.ent = ent
        self.stats.shared_blocks += len(ids)
        self.stats.peak_blocks = self.pool.peak_live
        return True

    def _begin(self, adm: Admission) -> None:
        """Start an admitted request: replay a full-prompt cache hit or start
        a chunked prefill job."""
        bs = self._req_blocks[adm.rid]
        ent, bs.ent = bs.ent, None
        if self.runlog.enabled:
            self.runlog.emit("serve_admit", rid=adm.rid, prompt_len=bs.plen,
                             budget=bs.budget, shared=bs.shared,
                             full_hit=ent is not None)
        with self.tracer.span("admit", rid=adm.rid, prompt_len=bs.plen,
                              shared=bs.shared):
            if ent is not None:
                self._admit_shared(adm, bs, ent)
            else:
                self._jobs.append(_PrefillJob(
                    rid=adm.rid, off=bs.shared * self.block_size,
                    row=self._fresh_row(bs.shared * self.block_size),
                ))

    def _fresh_row(self, off: int) -> dict:
        """Zeroed per-request prefill carry (``len`` and the rings) starting
        at position ``off`` (> 0 when a shared prefix was adopted)."""
        row = tf.init_cache(self.cfg, 1, self.max_seq, skip=self._paged,
                            device=self.device, kv_heads=self._kv_heads)
        row["len"] = torch.full((1,), off, dtype=torch.int32, device=self.device)
        return row

    def _admit_shared(self, adm: Admission, bs: _BlockState, ent: dict) -> None:
        """Full-prompt cache hit: replay the cached end-of-prompt logits
        through the sampler (keyed by THIS request's rid) and insert the
        cached row.  Zero prefill compute."""
        self._program(("sample", self._rung_token))
        tok = self._sample(ent["logits"], [adm.rid], [bs.plen]).cpu().numpy() \
            if self._speaks else None
        tok = self._agree(tok, 1)
        self._insert(adm.slot, ent["row"])
        bs.pos = bs.plen
        self.stats.prefills += 1
        self.stats.shared_prefill_hits += 1
        self._count_token(1)
        if self.sched.record(adm.slot, int(tok[0])):
            self._release(adm.rid)

    def _insert(self, slot: int, row: dict) -> None:
        """Write one single-request row (nested ring and Mamba leaves
        included) into slot ``slot``, in place; a leaf whose rows are split
        takes it only on the rank holding the slot."""
        self._program(("insert", self._bucket, self._rung_token))
        if not self._active:
            return
        lo, hi = self._row_range(self._bucket)
        axes = self._row_axes(self._cache, self._bucket)
        src = dict(tree_flatten_with_paths(row))
        for path, full in tree_flatten_with_paths(self._cache):
            if path not in axes:
                full.narrow(_axis(full), slot, 1).copy_(src[path].to(full.dtype))
            elif lo <= slot < hi:
                full.narrow(_axis(full), slot - lo, 1).copy_(src[path].to(full.dtype))

    def _count_token(self, n: int) -> None:
        self.stats.tokens += n
        self._thru.add(float(n))
        rate = self._thru.rate()
        if rate is not None:
            self.stats.tokens_per_sec = rate

    # -- the policy boundary -------------------------------------------------
    def _signals(self) -> ServeSignals:
        """Snapshot the queue/slot/pool state for ``policy.observe``."""
        sch = self.sched
        now = sch.clock()
        return ServeSignals(
            queue_depth=sch.pending,
            live=sch.live,
            capacity=sch.capacity,
            tokens_per_sec=self._thru.rate(now=now),
            free_blocks=self.pool.free,
            reserved_blocks=self.pool.reserved,
            queued=tuple(
                QueuedRequest(rid=rid, tenant=req.tenant,
                              priority=req.priority,
                              age=max(now - t, 0.0),
                              prompt_len=len(req.prompt))
                for rid, req, t in sch.queued()
            ),
            step=self.stats.steps,
        )

    def _observe_policy(self) -> None:
        """The boundary's policy phase: build signals, let the policy decide,
        apply the admission ordering, the persistent slot-budget cap and the
        shrink patience; applied changes mirror into a ``serve_policy``
        run-log event."""
        self._adm_order = None
        sig = self._signals()
        clock = Clock(epoch=0, step=self.stats.steps, boundary="tick")
        if self.tracer.enabled:
            with self.tracer.span("observe", scope="serve",
                                  step_num=self.stats.steps):
                d = self.policy.observe(sig, clock)
        else:
            d = self.policy.observe(sig, clock)
        if self._ranked:  # the first rank's decision (a policy may read clocks)
            group, ranks = self._control
            d = broadcast_object(d, ranks[0], group, self.device)
        if d is None:
            return
        reordered = False
        if d.order is not None:
            order = tuple(d.order)
            if order != tuple(q.rid for q in sig.queued):
                self._adm_order = list(order)
                reordered = True
        changed = reordered
        if d.slot_budget is not None and int(d.slot_budget) != self._slot_budget:
            self._slot_budget = int(d.slot_budget)
            changed = True
        if (d.shrink_patience is not None
                and int(d.shrink_patience) != self.shrink_patience):
            self.shrink_patience = int(d.shrink_patience)
            changed = True
        if changed and self.runlog.enabled:
            self.runlog.emit(
                "serve_policy", step=self.stats.steps,
                reason=d.reason or type(self.policy).__name__,
                reordered=reordered, slot_budget=self._slot_budget,
                shrink_patience=self.shrink_patience,
                queue_depth=sig.queue_depth,
            )

    def _target_slots(self) -> int:
        """The scheduler's pow2 slot target, clamped under the policy's slot
        budget (at least ``max(live, 1)``: a budget throttles admission but
        never evicts live requests or stalls the drain)."""
        target = self.sched.target_slots()
        if self._slot_budget is None:
            return target
        cap = max(self._slot_budget, self.sched.live, 1)
        need = min(self.sched.live + self.sched.pending, cap)
        return min(target, slots_for(need, self.sched.granule, self.max_slots))

    # -- chunked prefill -----------------------------------------------------
    def _run_chunk(self, job: _PrefillJob) -> None:
        """Advance one prompt by one block-aligned chunk.  The prior-context
        table is padded to a pow2 block count, so the program key is
        ``(chunk, prior bucket, rung)``."""
        bs = self._req_blocks[job.rid]
        c = bs.plen - job.off
        if self.prefill_chunk:
            c = min(c, self.prefill_chunk)
        nbp_real = job.off // self.block_size
        nbp = padded_prompt_len(nbp_real, 1) if nbp_real else 0
        ptab = np.zeros((nbp,), np.int64)
        ptab[:nbp_real] = bs.table[:nbp_real]
        wtab = np.asarray(bs.table[nbp_real:(job.off + c) // self.block_size], np.int64)
        self._program(("pfchunk", c, nbp, self._rung_token), kind="prefill")
        logits = None
        if self._active:  # every rank of the rung runs the one row
            toks = self._tensor(bs.tokens[None, job.off:job.off + c].astype(np.int64))
            args = (self.params, job.row, self._pages, {"tokens": toks}, job.off,
                    self._tensor(ptab), self._tensor(wtab))
            tr = self.tracer
            if tr.enabled:
                with tr.span("prefill_chunk", rid=job.rid, off=job.off, chunk=c,
                             rung=self._rung_token):
                    logits, job.row, self._pages = tf.prefill_chunk(self.cfg, *args)
            else:
                logits, job.row, self._pages = tf.prefill_chunk(self.cfg, *args)
        job.off += c
        self.stats.prefill_chunks += 1
        if job.off == bs.plen:
            # only the FINAL chunk's token is consumed
            tok = self._sample(logits, [job.rid], [bs.plen]).cpu().numpy() \
                if self._speaks else None
            self._finish_job(job, int(self._agree(tok, 1)[0]), logits)

    def _finish_job(self, job: _PrefillJob, tok: int, logits: torch.Tensor | None) -> None:
        """Final chunk done: register the prompt chain, cache the
        end-of-prompt state for future full-prompt hits, insert the row, and
        record token 1."""
        bs = self._req_blocks[job.rid]
        self._jobs.remove(job)
        bs.pos = bs.plen
        if self.prefix_sharing and bs.keys:
            for key, bid in zip(bs.keys, bs.table[:bs.nb_prompt]):
                self.pool.register(key, bid)  # first writer wins
            ids = self.pool.match(bs.keys)
            if len(ids) == bs.nb_prompt:
                self._prompt_cache[bs.keys[-1]] = {
                    "ids": ids, "row": job.row, "logits": logits,
                }
                while len(self._prompt_cache) > self._prompt_cache_cap:
                    self._prompt_cache.popitem(last=False)
        slot = self.sched.slot_of(job.rid)
        self._insert(slot, job.row)
        self.stats.prefills += 1
        self._count_token(1)
        if self.sched.record(slot, tok):
            self._release(job.rid)

    def _prefill_work(self) -> None:
        """Admissions + one chunk per pending prompt, repeated while instant
        retirements (EOS/budget at token 1) keep freeing slots."""
        for job in self._jobs:
            job.stepped = False
        while True:
            adms = self.sched.admit(gate=self._gate, order=self._adm_order)
            for adm in adms:
                self._begin(adm)
            pending = [j for j in self._jobs if not j.stepped]
            if not pending:
                if not adms:
                    return
                continue
            for job in pending:
                job.stepped = True
                self._run_chunk(job)

    # -- block tables --------------------------------------------------------
    def _release(self, rid: int) -> None:
        """Retirement: drop the request's block refs and return unspent
        reservation credits."""
        bs = self._req_blocks.pop(rid)
        for b in bs.table:
            self.pool.release(b)
        if bs.reserved:
            self.pool.unreserve(bs.reserved)
            bs.reserved = 0
        if self.runlog.enabled:
            self.runlog.emit("serve_retire", rid=rid, pos=bs.pos,
                             live_blocks=self.pool.live)
        self.stats.peak_blocks = self.pool.peak_live
        self.stats.cow_copies = self.pool.cow_copies

    def _decode_tables(self, running) -> np.ndarray:
        """(bucket, n_max) block tables for this decode step.  Rows of
        non-running lanes stay all-sentinel, so their garbage writes land in
        block 0.  Extends each running request's table for the token about to
        be written, spending reserved credits; copy-on-write guards the
        (unreachable: prompts pad to whole blocks) case of a shared write
        block."""
        arr = np.zeros((self._bucket, self._n_max), np.int32)
        for slot, rid in running:
            bs = self._req_blocks[rid]
            wi = bs.pos // self.block_size
            while len(bs.table) <= wi:
                bs.table.append(self.pool.alloc(reserved=True))
                bs.reserved -= 1
            if not self.pool.writable(bs.table[wi]):
                new = self.pool.cow(bs.table[wi])
                self._program(("cow", self._rung_token))
                if self._active:
                    _copy_block(self._pages, bs.table[wi], new)
                bs.table[wi] = new
                self.stats.cow_copies = self.pool.cow_copies
            arr[slot, :len(bs.table)] = bs.table
        self.stats.peak_blocks = self.pool.peak_live
        return arr

    # -- the serving step ----------------------------------------------------
    def step(self) -> bool:
        """One boundary (policy observe -> resize -> admit/prefill chunks)
        plus one decode step over the slot table.  Returns False once fully
        drained."""
        sch = self.sched
        if not sch.has_work:
            # a drained engine starts the next trace fresh
            self._shrink_streak = 0
            return False
        self._observe_policy()
        target = self._target_slots()
        if 0 < target < self._bucket:
            self._shrink_streak += 1
            if self._shrink_streak <= self.shrink_patience:
                target = self._bucket  # ride out a transient dip
        else:
            self._shrink_streak = 0
        if target != self._bucket:
            self._shrink_streak = 0
        self._resize(target)
        self._prefill_work()
        self.stats.retired = sch.retired  # prefill-instant retirements count
        running = sch.running_slots()
        if not running:  # nothing decoding (drained, or all mid-prefill)
            return True
        toks = sch.next_tokens().astype(np.int64)
        rids = sch.slot_rids()
        pos = np.zeros(self._bucket, np.int64)
        for slot, rid in running:
            pos[slot] = self._req_blocks[rid].pos + 1
        tables = self._decode_tables(running)
        self._program(("decode", self._bucket, self._rung_token), kind="decode")
        tr = self.tracer
        t0 = time.perf_counter()
        if tr.enabled:
            with tr.span("decode", bucket=self._bucket, rung=self._rung_token,
                         live=len(running), step_num=self.stats.steps):
                nxt = self._decode(running, toks, rids, pos, tables)
        else:
            nxt = self._decode(running, toks, rids, pos, tables)
        self.stats.dispatch_wall_s += time.perf_counter() - t0
        self.stats.steps += 1
        self.stats.slot_steps += self._bucket
        for slot, rid in running:
            self._req_blocks[rid].pos += 1
            if sch.record(slot, int(nxt[slot])):
                self._release(rid)
        self._count_token(len(running))
        self.stats.retired = sch.retired
        if (self.runlog.enabled and self.obs_window
                and self.stats.steps % self.obs_window == 0):
            self.runlog.emit(
                "serve_window", step=self.stats.steps, tokens=self.stats.tokens,
                tokens_per_sec=self.stats.tokens_per_sec, live=len(running),
                live_blocks=self.pool.live, bucket=self._bucket,
                rung=self._rung_token,
            )
        return True

    def _decode(self, running, toks: np.ndarray, rids: np.ndarray, pos: np.ndarray,
                tables: np.ndarray) -> np.ndarray:
        """One decode step over the bucket: the (B,) tokens every rank
        records.  On a rank rung that splits the rows, this rank decodes its
        own (with its slice of the tokens, tables and lengths) and the rows'
        new pool entries are gathered; the per-step host transfer is one
        (B,) vector.  The T tp ranks of a data row decode its rows alike:
        tp coordinate 0 alone contributes them."""
        b = self._bucket
        if not self._active:
            return self._agree(None, b)
        lo, hi = self._row_range(b)
        view = dict(self._cache)
        view["len"] = self._cache["len"][lo:hi]
        logits, _, self._pages = tf.decode_step(
            self.cfg, self.params, view, self._tensor(toks[lo:hi, None]),
            pages=self._pages, tables=self._tensor(tables[lo:hi]),
        )
        self._cache["len"] = self._cache["len"] + 1
        out = np.zeros(b, np.int64)
        out[lo:hi] = self._sample(logits, rids[lo:hi], pos[lo:hi]).cpu().numpy()
        split = hi - lo < b
        if split:
            self._share_entries(running, tables, lo, hi)
        mine = (split and self._tp_rank == 0) or self._speaks
        return self._agree(out if mine else None, b)

    def _share_entries(self, running, tables: np.ndarray, lo: int, hi: int) -> None:
        """Every rank of the rung writes the K/V entries the other ranks'
        rows just wrote into their pools: one all-gather of each rank's
        rows' entries over the data axes, within the rank's tp coordinate
        (its KV heads; free lanes read from block 0 and are dropped), so the
        pools of a tp coordinate stay equal but for the sentinel block's
        garbage."""
        leaves = [x for entry in self._pages.values() for x in (entry["k"], entry["v"])]
        if not leaves:
            return
        blk = self.block_size
        wb = np.zeros(self._bucket, np.int64)
        off = np.zeros(self._bucket, np.int64)
        for slot, rid in running:
            p = self._req_blocks[rid].pos  # the position this step wrote
            wb[slot], off[slot] = tables[slot, p // blk], p % blk
        i_wb, i_off = self._tensor(wb[lo:hi]), self._tensor(off[lo:hi])
        mine = torch.stack([x[:, i_wb, i_off] for x in leaves])  # (2P, R, rows, KV, hd)
        plan = self._live_plan
        whole = all_gather_dim([mine], [2], plan.mesh,
                               sharding.fit_axes(self._bucket, plan.dp, plan))[0]
        others = [slot for slot, _ in running if not lo <= slot < hi]
        if others:
            idx = self._tensor(np.asarray(others, np.int64))
            o_wb, o_off = self._tensor(wb[others]), self._tensor(off[others])
            for x, w in zip(leaves, whole):
                x[:, o_wb, o_off] = w[:, idx]

    def drain(self) -> None:
        while self.step():
            pass
        self.pool.check()  # drained: conservation + zero leaked blocks

    def result(self, rid: int) -> Result:
        return self.sched.result(rid)

    def generate(self, requests: list[Request]) -> list[Result]:
        """Submit, drain, and collect — results in request order."""
        rids = [self.submit(r) for r in requests]
        self.drain()
        return [self.sched.result(rid) for rid in rids]
