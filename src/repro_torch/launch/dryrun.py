"""Multi-pod dry run: plan every (arch x shape) cell on the production H100
meshes from a traced step of the port, and record its memory, FLOPs,
collectives and roofline per device.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's SPMD program over 512 placeholder host devices and
reads XLA's analyses.  The port runs one rank's program eagerly, so its
plan traces that program: inside :func:`fake_world` (a fake process group
of the mesh's size) it builds the rank mesh, the plan (``launch.mesh.
make_plan``) and the traced rank's shard of the state (``dist.sharding.
state_layout``), then runs that rank's step on fake tensors
(``FakeTensorMode``, device "cpu") under ``utils.hlo.TraceCounter``.  No
device runs anything and no card is touched; what is counted is what the
traced rank would dispatch.  That is rank 0, but for a train cell whose
attention runs context-parallel (:func:`traced_rank`): there the last tp
rank, whose query rows see the most keys under causality (rank 0's share
of the score tiles is the smallest), and the record names it:

  train    ``make_train_step`` (the step ``StepEngine.for_lm`` builds), sgd
           with momentum 0.9 at the reference's ``opt_dtype`` rule, the
           moment tier: one microbatch at the rank's share of the global
           microbatch, then the update.  Every count is extrapolated to
           ``num_micro`` microbatches from the trace's split around the
           microbatch (``utils.hlo.extrapolate``); the record says so.
  prefill  ``prefill_step`` on the rank's rows (``batch_pspecs``), the MoE
           tokens in the reference's groups (the rank routes its share),
           the dense cache at the rank's KV heads.
  decode   ``decode_step`` over the cache as the port holds it on the rank:
           its batch rows split over the data axes where ``cache_pspecs``
           splits them, its KV heads (``dist.sharding.serving_kv_heads``),
           every other dim whole (``serve/engine.py``); the reference's
           layout is recorded beside it.

The traced lane is the reference's: ``attn_impl="auto"`` takes the plain
flash lane (``models/attention.py::flash_attention``) above the threshold,
as the reference's dry run reaches its XLA flash lane; the kernel lane's
wrappers take their plain (materialising) versions on host tensors, a
different program.  A train cell's blocks split over the mesh's ``model``
axis as the training stack splits them (``dist.sharding.tp_split``: each tp
rank its heads and FFN widths, an all-gather in and a reduce-scatter out
of each sublayer over the model group), and so do its input and head
(``models/transformer.py``: each rank looks up its ``d/T`` embedding
columns, or computes its ``d/T`` frontend columns, its residual shard;
where T divides V the cross-entropy is vocab-parallel on the rank's
``V/T`` head rows, one all-gather of the logsumexps a microbatch, the
head's dx summed by the final norm's entry).  Where T
does not divide the heads but divides their widths and the length
(qwen2-7b's 28/4 and internvl2-1b's 14/2 heads at T 16), attention runs
context-parallel as the reference's ``attn_q``/``attn_kv`` specs lay it
out: each rank projects its ``H hd/T`` and ``KV hd/T`` columns, one
all-to-all trades the q columns for its ``S/T`` query rows of every head,
one all-gather joins k and v, and the out all-to-all trades back before
its rows of ``o``.  A Mamba mixer whose ``d_inner`` T divides runs on the
rank's ``d_inner/T`` channels (``models/ssm.py::mamba_apply_tp``: one
exchange of ``in_proj``'s rows over tp, ``x_proj``'s partial summed over
tp, its rows of ``out_proj`` and one all-reduce).  What does not split
runs whole on every tp rank.  The residual stream splits too, by
``d_model`` columns over the model axis wherever T divides ``d_model``
(``dist.sharding.residual_split``; every config at T 16), the reference's
``residual`` activation spec ``P(dp, None, tp)``: each rank holds its
``d/T`` columns between sublayers, each sublayer's entry all-gathers them
before its norm and its exit reduce-scatters the row-parallel output (an
all-reduce's bytes in two collectives), so remat keeps ``(B, S, d/T)`` of
each layer's input a rank; the record's ``memory.remat_kept_bytes`` counts
what the traced microbatch hands ``checkpoint`` (``transformer.
remat_counts``).
Prefill and decode (serving) split the same way (each rank computes its
``V/T`` logits, then one all-gather over tp), and hold the rank's KV heads only: ``KV/T`` of them, or where T ranks
share a KV head that one whole (T/KV times the reference's layout, which
splits ``head_dim`` there); context-parallel attention computes whole when
serving (``dist.sharding.serving_split``), and so does the residual stream
(the reference installs no ``residual`` spec for prefill or decode).
``act_specs_for`` has no counterpart: the split is arithmetic on the config
and the plan, not a table of specs.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--out runs/dryrun_torch]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs import (ARCH_NAMES, SHAPES, cell_supported, get_config,
                                 input_specs)
from repro_torch.dist import sharding
from repro_torch.dist.plan import Mesh, RankDevice, ShardingPlan, abstract_mesh
from repro_torch.launch.mesh import make_plan
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.train.state import init_state
from repro_torch.train.step import make_train_step
from repro_torch.utils import hlo as hlo_lib
from repro_torch.utils import pytree as ptu
from repro_torch.utils.logging import get_logger

log = get_logger("dryrun")

GIB = 1 << 30

# Per-cell tuning knobs of the reference's perf iteration: (arch, shape) ->
# overrides.
CELL_TUNING: dict[tuple[str, str], dict] = {
    # FSDP weight re-gathers scale with the accumulation length: 4
    # microbatches cut the reference's collective term by a third
    ("llama3-405b", "train_4k"): {"num_micro": 4},
    # larger SSM chunks: fewer chunk-scan boundaries
    ("falcon-mamba-7b", "train_4k"): {"config": {"ssm_chunk": 1024}},
}


def dryrun_config(arch: str):
    """The production-run variant of an arch config (bf16, remat; the
    reference's ``scan_layers`` has no counterpart: the stack is a loop)."""
    return get_config(arch).replace(
        remat=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        flash_q_block=256,
        flash_kv_block=1024,
    )


def _micro_plan(cfg, shape, plan) -> tuple[int, int]:
    """(num_micro, micro_global_batch) for a train cell: pick ~1 sequence per
    dp shard for giant models, more for small ones."""
    dp = plan.dp_size
    b = shape.global_batch
    # 1 sequence/shard for giant dense models, big-E MoE, and hybrids (whose
    # mamba chunk scans carry (B, L, d_inner, d_state) working sets)
    heavy = (
        cfg.d_model >= 6144
        or cfg.num_experts >= 64
        or ("mamba" in cfg.pattern and cfg.num_experts > 0)
    )
    seqs_per_shard = 1 if heavy else 4
    micro = min(b, dp * seqs_per_shard)
    while b % micro != 0:
        micro //= 2
    micro = max(micro, 1)
    return b // micro, micro


def opt_dtype_of(cfg) -> torch.dtype:
    """The reference's optimizer-state type rule: bf16 for giant models."""
    return torch.bfloat16 if cfg.d_model >= 6144 or cfg.num_experts >= 64 else torch.float32


def prefill_groups(cfg, tokens: int, dp: int) -> int:
    """The reference's MoE routing groups for a prefill of ``tokens``: a
    single group over 1M tokens builds a huge dispatch buffer, so about 8192
    tokens a group, a multiple of the dp width."""
    if not cfg.num_experts:
        return 1
    groups = max(dp, tokens // 8192)
    while tokens % groups != 0 or groups % dp != 0:
        groups -= 1
    return max(groups, dp)


def active_params(cfg, specs) -> float:
    """Parameter count weighted by activation fraction (MoE experts count
    top_k/E) — the N in MODEL_FLOPS = 6*N*D."""
    total = 0.0
    for path, leaf in ptu.tree_flatten_with_paths(specs):
        n = float(np.prod(leaf.shape))
        if cfg.num_experts and (
            path.endswith("ffn/w_gate") or path.endswith("ffn/w_up")
            or path.endswith("ffn/w_out")
        ):
            n *= cfg.top_k / cfg.num_experts
        if path.endswith("embed/embedding"):
            continue  # lookup, not matmul
        total += n
    return total


# ---------------------------------------------------------------------------
# the fake world and the rank mesh
# ---------------------------------------------------------------------------


def traced_rank(cfg, shape, multi_pod: bool, param_bytes: int) -> int:
    """The rank a cell traces: 0, but for a train cell whose attention runs
    context-parallel on the production mesh's plan (``dist.sharding.
    tp_split`` "context"), the last tp rank at the first data coordinates
    (``T - 1``: the mesh's last axis, ``model``, is its fastest)."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    plan = make_plan(abstract_mesh((2, 16, 16) if multi_pod else (16, 16), axes),
                     param_bytes=param_bytes)
    if shape.kind != "train" or not any(
            sharding.tp_split(cfg, p, plan, shape.seq_len).attn == "context"
            for p in range(cfg.period)):
        return 0
    return plan.tp_size - 1


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A fake default process group of ``n`` ranks, this process rank
    ``rank``: collectives on fake tensors return outputs of the right shape
    and talk to no one.  Raises when a default group exists already; tears
    its own group (and every group built over it) down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group exists already; the dry "
                           "run needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank_mesh(shape, axes) -> Mesh:
    """A rank mesh of ``shape`` over the default group's ranks in order,
    each on the CPU (rank ``i`` at flat position ``i``, the last axis
    fastest)."""
    entries = np.empty(math.prod(shape), dtype=object)
    for r in range(entries.size):
        entries[r] = RankDevice(r, "cpu")
    return Mesh(entries.reshape(shape), axes)


def one_device() -> ShardingPlan:
    """The plan of a single device: nothing sharded, no collective."""
    return ShardingPlan(mesh=abstract_mesh((1, 1), ("data", "model")))


def production_mesh(multi_pod: bool) -> Mesh:
    """The reference's ``(16, 16)`` ``(data, model)`` mesh, or ``(2, 16,
    16)`` ``(pod, data, model)``, over the fake world's ranks."""
    if multi_pod:
        return rank_mesh((2, 16, 16), ("pod", "data", "model"))
    return rank_mesh((16, 16), ("data", "model"))


def _fake_params(model: nn.Module, layout) -> None:
    """Swap every parameter of a ``meta`` model for a fake tensor on the
    CPU of its shard's shape (under the active fake mode), attach the
    layout."""
    shapes = sharding.full_shapes(model) if layout is None else None
    for prefix, mod in model.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            full = f"{prefix}.{name}" if prefix else name
            shape = shapes[full] if layout is None else layout.local_shape(full)
            mod._parameters[name] = nn.Parameter(
                torch.empty(shape, dtype=p.dtype, device="cpu"), requires_grad=False)
    model.shard_layout = layout


def _local(t: torch.Tensor, spec, plan) -> torch.Tensor:
    """A fake tensor of this rank's shard of a leaf shaped like ``t``."""
    return torch.empty(sharding.local_shape(t.shape, spec, plan), dtype=t.dtype)


def _nbytes_local(tree: dict, specs: dict, plan) -> int:
    return sum(math.prod(sharding.local_shape(t.shape, specs[p], plan)) * t.element_size()
               for p, t in ptu.tree_flatten_with_paths(tree))


# ---------------------------------------------------------------------------
# tracing one rank's program
# ---------------------------------------------------------------------------


def state_bytes(model: nn.Module, plan: ShardingPlan, opt_dtype: torch.dtype | None) -> int:
    """Bytes a rank holds of the training state (``opt_dtype`` given) or of
    the parameters alone (None), reckoned from the shard shapes the state's
    layout holds (``sharding.param_pspecs``): each parameter's shard in its
    type, and for the state a momentum and a ``grad_sum`` shard in
    ``opt_dtype`` and the three float32 diversity scalars.  Any plan, on a
    mesh of ranks or an abstract one."""
    specs = sharding.param_pspecs(model, plan)
    total = 0
    for name, p in model.named_parameters():
        n = math.prod(sharding.local_shape(p.shape, specs[name], plan))
        total += n * p.element_size()
        if opt_dtype is not None:
            total += 2 * n * torch.empty((), dtype=opt_dtype).element_size()
    return total + (3 * 4 if opt_dtype is not None else 0)


def _held_bytes(state) -> int:
    """Bytes of the training state this rank holds: its shards of the
    parameters, momenta and ``grad_sum``, and the diversity scalars."""
    tensors = list(state.params.parameters()) + list(state.opt_state.momentum) + \
        ptu.leaves(state.div_state.grad_sum) + \
        [state.div_state.sq_norm_sum, state.div_state.mb_count, state.div_state.sample_count]
    return sum(t.numel() * t.element_size() for t in tensors)


def trace_train(cfg, plan: ShardingPlan | None, micro_global: int, seq: int, num_micro: int,
                opt_dtype: torch.dtype, moe_groups: int = 1) -> dict:
    """Rank ``plan.mesh.rank``'s training step of ``num_micro``
    microbatches of ``micro_global`` sequences of ``seq`` tokens, traced
    (one microbatch, extrapolated) on fake tensors: ``{"analysis",
    "state_bytes"}``.  ``plan`` None: one device (:func:`one_device`),
    whole state, no collective."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    plan = plan or one_device()
    ranked = getattr(plan.mesh, "ranked", False)
    model = tf.param_specs(cfg)
    layout = sharding.state_layout(model, plan)
    counter = hlo_lib.TraceCounter()
    marks: dict[int, dict] = {}
    with FakeTensorMode(), counter:
        _fake_params(model, layout)
        optimizer = sgd(momentum=0.9, state_dtype=opt_dtype)
        state = init_state(model, optimizer, opt_dtype)
        held = _held_bytes(state)
        step = make_train_step(cfg, optimizer, 1, dp_size=plan.dp_size, moe_groups=moe_groups,
                               plan=plan if ranked else None, diversity_on=True,
                               on_microbatch=lambda j: marks.__setitem__(j, counter.snapshot()))
        key = "tokens" if cfg.input_mode == "tokens" else "embeddings"
        x = (torch.zeros(micro_global, seq, dtype=torch.int32) if key == "tokens" else
             torch.zeros(micro_global, seq, cfg.d_model, dtype=getattr(torch, cfg.compute_dtype)))
        batch = {key: x, "targets": torch.zeros(micro_global, seq, dtype=torch.int32)}
        counter.reset_counts()
        tf.reset_remat_counts()
        step(state, batch, 0.1)
        end = counter.snapshot()
    snap = hlo_lib.extrapolate(marks[0], marks[1], end, num_micro)
    return {"analysis": counter.analysis(snap), "state_bytes": held,
            "remat_kept_bytes": tf.remat_counts()["bytes"]}


def trace_prefill(cfg, plan: ShardingPlan | None, batch: int, seq: int) -> dict:
    """Rank ``plan.mesh.rank``'s ``prefill_step`` of its rows of a
    ``(batch, seq)`` prompt batch, traced on fake tensors (``plan`` None:
    one device); its dense cache holds the rank's KV heads."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    plan = plan or one_device()
    specs = input_specs(cfg, SHAPES["prefill_32k"], batch_override=batch,
                        seq_override=seq)["batch"]
    counter = hlo_lib.TraceCounter()
    groups = prefill_groups(cfg, batch * seq, plan.dp_size)
    model = tf.param_specs(cfg)
    with FakeTensorMode(), counter:
        _fake_params(model, sharding.state_layout(model, plan))
        rows = sharding.batch_pspecs(specs, plan)
        local = {k: _local(v, rows[k], plan) for k, v in specs.items()}
        share = next(iter(local.values())).shape[0]
        local_groups = max(1, groups * share // batch) if cfg.num_experts else 1
        counter.reset_counts()
        _, cache = tf.prefill_step(cfg, model, local, moe_groups=local_groups)
        cache_bytes = sum(t.numel() * t.element_size()
                          for _, t in ptu.tree_flatten_with_paths(cache))
    whole_cache = tf.cache_specs(cfg, batch, seq)
    ref_bytes = _nbytes_local(whole_cache, sharding.cache_pspecs(
        dict(ptu.tree_flatten_with_paths(whole_cache)), plan), plan)
    return {"analysis": counter.analysis(), "cache_bytes": cache_bytes if cfg.causal else 0,
            "cache_bytes_reference_layout": ref_bytes if cfg.causal else 0,
            "moe_groups": groups}


def trace_decode(cfg, plan: ShardingPlan | None, batch: int, seq: int) -> dict:
    """Rank ``plan.mesh.rank``'s ``decode_step`` of one token for its rows
    of a batch over a ``seq``-token cache at its KV heads, traced on fake
    tensors (``plan`` None: one device)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    plan = plan or one_device()
    specs = input_specs(cfg, SHAPES["decode_32k"], batch_override=batch, seq_override=seq)
    cache_specs = dict(ptu.tree_flatten_with_paths(specs["cache"]))
    ref = sharding.cache_pspecs(cache_specs, plan)
    # the rows a rank holds, as the port keeps a cache (serve/engine.py):
    # the batch split where cache_pspecs splits it, every other dim whole
    rows = sharding.fit_axes(batch, plan.dp, plan)
    counter = hlo_lib.TraceCounter()
    model = tf.param_specs(cfg)
    with FakeTensorMode(), counter:
        _fake_params(model, sharding.state_layout(model, plan))
        cache = {"len": torch.zeros((), dtype=torch.int32)}
        kv = tf.serving_kv_heads(cfg, plan)
        for path, t in cache_specs.items():
            if path != "len":  # (repeats, B, ...): the rows are dim 1
                pos, leaf = path.split("/")
                shape = sharding.local_shape(t.shape, (None, rows), plan)
                if leaf in ("k", "v"):  # (.., KV, hd): the rank's KV heads
                    shape = shape[:-2] + (kv, shape[-1])
                cache.setdefault(pos, {})[leaf] = torch.empty(shape, dtype=t.dtype)
        tokens = _local(specs["tokens"], (rows,), plan)
        cache_bytes = sum(t.numel() * t.element_size()
                          for _, t in ptu.tree_flatten_with_paths(cache))
        counter.reset_counts()
        tf.decode_step(cfg, model, cache, tokens)
    return {"analysis": counter.analysis(), "cache_bytes": cache_bytes,
            "cache_bytes_reference_layout": _nbytes_local(specs["cache"], ref, plan)}


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------


def _attn_impl_traced(cfg, shape) -> str:
    if shape.kind == "decode":
        return "decode_attention (plain)" if "attn" in "".join(cfg.pattern) else "none"
    if not any(k.startswith("attn") for k in cfg.pattern):
        return "none"
    return attn_lib.resolve_impl(cfg, shape.seq_len)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str | None,
             tuning_override: dict | None = None) -> dict:
    shape = SHAPES[shape_name]
    cfg = dryrun_config(arch)
    ok, why = cell_supported(arch, shape_name, cfg.causal)
    record: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "kind": shape.kind,
    }
    if not ok:
        record.update(status="skipped", reason=why)
        _save(record, out_dir)
        return record

    params_specs = tf.param_specs(cfg)
    param_bytes = ptu.tree_bytes(params_specs)
    tuning = dict(CELL_TUNING.get((arch, shape_name), {}))
    if tuning_override:
        tuning.update(tuning_override)
    if "config" in tuning:
        cfg = cfg.replace(**tuning["config"])
    chips = 512 if multi_pod else 256
    rank = traced_rank(cfg, shape, multi_pod, param_bytes)
    t0 = time.time()
    try:
        with fake_world(chips, rank):
            mesh = production_mesh(multi_pod)
            plan = make_plan(mesh, param_bytes=param_bytes)
            info: dict = {}
            if shape.kind == "train":
                num_micro, micro = _micro_plan(cfg, shape, plan)
                num_micro = tuning.get("num_micro", num_micro)
                micro = shape.global_batch // num_micro
                opt_dtype = opt_dtype_of(cfg)
                res = trace_train(cfg, plan, micro, shape.seq_len, num_micro, opt_dtype,
                                  moe_groups=plan.dp_size if cfg.num_experts else 1)
                info = {"num_micro": num_micro, "micro_global": micro,
                        "opt_dtype": str(opt_dtype).replace("torch.", ""),
                        "traced": "one microbatch and the update; counts extrapolated "
                                  f"to {num_micro} microbatches"}
                memory = {"state_bytes": res["state_bytes"],
                          "remat_kept_bytes": res["remat_kept_bytes"]}
            elif shape.kind == "prefill":
                res = trace_prefill(cfg, plan, shape.global_batch, shape.seq_len)
                info = {"moe_groups": res["moe_groups"]}
                memory = {k: res[k] for k in ("cache_bytes", "cache_bytes_reference_layout")}
            else:
                res = trace_decode(cfg, plan, shape.global_batch, shape.seq_len)
                memory = {k: res[k] for k in ("cache_bytes", "cache_bytes_reference_layout")}
            reckoned = state_bytes(params_specs, plan,
                                   opt_dtype_of(cfg) if shape.kind == "train" else None)
            if shape.kind != "train":
                memory["state_bytes"] = reckoned
            elif memory["state_bytes"] != reckoned:
                raise RuntimeError(f"the traced state holds {memory['state_bytes']} bytes, "
                                     f"its layout {reckoned}")
            plan_rec = {"dp": plan.dp, "fsdp": plan.fsdp, "tp": plan.tp, "ep": plan.ep}
        analysis = res["analysis"]
        terms = hlo_lib.roofline_terms(analysis["flops"], analysis["hbm_bytes_adjusted"],
                                       analysis["collectives"]["total_time_s"])
        terms["memory_unadjusted_s"] = analysis["hbm_bytes"] / hlo_lib.HBM_BW
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        mf = hlo_lib.model_flops(active_params(cfg, params_specs), tokens,
                                 "train" if shape.kind == "train" else "infer")
        global_flops = analysis["flops"] * chips
        peak = analysis["peak_bytes"]
        memory.update(peak_bytes=peak, hbm_per_device_gib=round(peak / GIB, 3),
                      fits_80gb=peak <= hlo_lib.HBM_CAPACITY)
        record.update(
            status="ok",
            trace_s=round(time.time() - t0, 1),
            chips=chips,
            param_bytes=param_bytes,
            plan=plan_rec,
            tuning=info,
            traced_rank=rank,
            attn_impl_traced=_attn_impl_traced(cfg, shape),
            activations=activations(cfg, shape.kind, plan, rank),
            memory=memory,
            cost={
                "flops_per_device": analysis["flops"],
                "flops_by_op": analysis["flops_by_op"],
                "hbm_bytes_per_device": analysis["hbm_bytes"],
                "hbm_bytes_adjusted": analysis["hbm_bytes_adjusted"],
                "convert_bytes": analysis["convert_bytes"],
                "elementwise_bytes": analysis["elementwise_bytes"],
                "ops_dispatched": analysis["ops"],
                "model_flops_global": mf,
                "useful_flops_ratio": (mf / global_flops) if global_flops else 0.0,
            },
            collectives=analysis["collectives"],
            roofline=terms,
            hardware=hlo_lib.HARDWARE,
        )
        log.info("%s x %s [%s]: traced %.1fs, %.2f GiB/dev, dominant=%s",
                 arch, shape_name, record["mesh"], record["trace_s"],
                 memory["hbm_per_device_gib"], terms["dominant"])
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        log.error("%s x %s FAILED: %s", arch, shape_name, record["error"])
    _save(record, out_dir)
    return record


def activations(cfg, kind: str, plan: ShardingPlan, rank: int = 0) -> str:
    """The record's account of how a cell's activations lie over the
    mesh: the split sublayers, the residual stream (split by columns in
    training where :func:`dist.sharding.residual_split` says so, else
    whole), the input and the head, context-parallel attention on a traced
    rank past 0, the serving cache."""
    residual = ("the residual stream split by d_model columns over the model axis "
                "(P(dp, None, tp): remat keeps each layer's (B, S, d/T))"
                if kind == "train" and sharding.residual_split(cfg, plan)
                else "the residual stream whole")
    return ("heads and FFN widths split over the model axis (dist.sharding.tp_split), "
            + residual + "; the embedding's d and the head's V over tp"
            + ("; attention context-parallel where tp does not divide the heads: each "
               "rank's S/T query rows of every head, k/v gathered whole over tp (the "
               "reference's attn_q / attn_kv)" if rank else "")
            + ("" if kind == "train" else ", the cache at the rank's KV heads"))


def summary(rec: dict) -> str:
    """One line of a cell's record."""
    head = f"{rec['arch']} x {rec['shape']} [{rec['mesh']}]"
    if rec["status"] == "skipped":
        return f"SKIP {head}: {rec['reason']}"
    if rec["status"] != "ok":
        return f"FAIL {head}: {rec['error']}"
    m, r, c = rec["memory"], rec["roofline"], rec["cost"]
    cache = (f", cache {m['cache_bytes'] / GIB:.2f} GiB (reference layout "
             f"{m['cache_bytes_reference_layout'] / GIB:.2f})" if "cache_bytes" in m else "")
    traced = (f", traced rank {rec['traced_rank']} (the last tp rank: the most attention "
              f"rows under causality)" if rec.get("traced_rank") else "")
    return (f"OK   {head} {m['hbm_per_device_gib']} GiB/dev (state "
            f"{m['state_bytes'] / GIB:.2f}{cache}), fits_80gb={m['fits_80gb']}, "
            f"dominant={r['dominant']}, bound {r['step_time_lower_bound_s']:.4g} s, "
            f"useful {c['useful_flops_ratio']:.3f}{traced}")


def _save(record: dict, out_dir: str | None):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{record['arch']}__{record['shape']}__{record['mesh']}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--num-micro", type=int, default=None)
    args = ap.parse_args()

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    tuning = {"num_micro": args.num_micro} if args.num_micro else None
    cells = []
    if args.all:  # every arch, at --shape alone when given
        for arch in ARCH_NAMES:
            for shape in SHAPES if args.shape is None else (args.shape,):
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape))

    failures = 0
    t0 = time.time()
    for multi in meshes:
        for arch, shape in cells:
            rec = run_cell(arch, shape, multi, args.out, tuning)
            print(summary(rec), flush=True)
            failures += rec["status"] == "error"
    print(f"{len(meshes) * len(cells)} cells in {time.time() - t0:.0f} s", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
