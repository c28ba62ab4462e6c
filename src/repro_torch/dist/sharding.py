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
mesh axes.  Parameters stay replicated at run time: the rules are what a
sharded state and a dry run read.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

from repro_torch.dist.plan import AxisNames, ShardingPlan


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
