"""The port's dry run (``launch/dryrun.py``, ``utils/hlo.py``) against the
reference's, on the CPU.

  * the shape table, ``cell_supported`` over all 10 x 4 cells and
    ``input_specs``' shapes and types equal the reference's;
  * ``transformer.param_specs`` leaf by leaf through ``interop.layout``
    (paths, shapes, types) and ``active_params`` exactly, for the ten full
    configs at the dry run's types;
  * the per-device training state bytes on both production meshes, for the
    ten full configs, equal the bytes of the reference's ``infer_pspecs``
    on ``repro.dist.plan.abstract_mesh`` (the reference's ``step`` counter,
    an int32 the port keeps on the host, aside), and ``_micro_plan`` equals
    the reference's;
  * the trace counter's FLOPs against ``repro.utils.hlo.analyze_hlo`` of the
    single-device compiled step, exactly: reduced yi-6b, qwen2-7b,
    dbrx-132b, falcon-mamba-7b and hubert-xlarge train steps (sgd with
    momentum, the moment tier, remat) and a yi-6b ``decode_step``.  Three
    gaps are named and asserted at their exact size: with one cross-entropy
    chunk XLA inlines the one-trip loops and merges the backward's
    recompute of the logits with the forward's product (the port computes
    it twice); the reference's backward contracts the router's logit
    gradient once per use of the logits (dx and dW twice a layer), where
    autograd sums the two first; XLA rewrites the scan's outer product (a
    contraction of size 1) into an elementwise multiply, which a count of
    dots leaves out;
  * tensor-parallel compute: ``dist.sharding.tp_split`` for the ten full
    configs at T 16, one case per config; and on a fake ``(data 1, model
    4)`` world rank 0's traced FLOPs for a reduced yi-6b train microbatch
    equal the split layers' count divided by 4, plus the head (whole at
    vocab 251, a quarter at 256) and the replicated-KV terms (two ranks
    share each KV head), exactly; the residual stream split by columns
    there: the traced step's checkpointed layer inputs are ``layers x B S
    (d/4)`` values (``remat_kept_bytes`` and a ``saved_tensors_hooks``
    count), a quarter of one device's, and the record's ``activations``
    names the split;
  * the reference's mini dry run (``tests/test_dryrun_mini.py``) on a
    ``(2, 2, 2)`` plan in a fake world of 8: reduced qwen2-7b, kimi-k2 and
    jamba train, yi-6b decode; FLOPs and peak above 0, collectives for
    train, the traced state equal to its reckoning; and one production
    cell through ``run_cell``.

The fake-world collectives are held against 2 gloo ranks in
``tests/test_torch_dryrun_ranks.py``.
"""

import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_supported as jcell_supported
from repro.configs import get_config as jget
from repro.configs import input_specs as jinput_specs
from repro.configs.base import ENCODER_ONLY_ARCHS as JENCODER_ONLY
from repro.configs.base import FULL_ATTENTION_ARCHS as JFULL_ATTENTION
from repro.dist import sharding as jsharding
from repro.dist.plan import ShardingPlan as JShardingPlan
from repro.dist.plan import abstract_mesh as jabstract_mesh
from repro.launch.mesh import make_plan as jmake_plan
from repro.models import transformer as jtf
from repro.optim import sgd as jsgd
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro.utils import pytree as jptu
from repro.utils.hlo import HloProgram, analyze_hlo
from repro_torch.configs import (ARCH_NAMES, ENCODER_ONLY_ARCHS, FULL_ATTENTION_ARCHS, SHAPES,
                                 cell_supported, get_config, input_specs)
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding
from repro_torch.dist.plan import ShardingPlan, abstract_mesh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as lmesh
from repro_torch.models import transformer as tf
from repro_torch.utils import pytree as ptu

torch.set_num_threads(2)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DRYRUN_TYPES = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat=True)


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's ``launch/dryrun.py``: imported once JAX has its
    devices (its first line writes ``XLA_FLAGS``, which then reaches no
    backend of this process), and ``XLA_FLAGS`` put back for the
    processes that later tests spawn."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _specs(arch: str):
    """(port config, its meta model, reference config, its param specs) of
    a full config at the dry run's types."""
    cfg = get_config(arch).replace(**DRYRUN_TYPES)
    jcfg = jget(arch).replace(**DRYRUN_TYPES)
    return cfg, tf.param_specs(cfg), jcfg, jtf.param_specs(jcfg)


# ---------------------------------------------------------------------------
# the shape table and the stand-ins
# ---------------------------------------------------------------------------


def test_shape_table_and_cells_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    assert FULL_ATTENTION_ARCHS == JFULL_ATTENTION and ENCODER_ONLY_ARCHS == JENCODER_ONLY
    assert set(ARCH_NAMES) == set(JARCH_NAMES)
    skipped = 0
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            got = cell_supported(arch, shape, get_config(arch).causal)
            assert got == jcell_supported(arch, shape, jget(arch).causal), (arch, shape)
            skipped += not got[0]
    assert skipped == 8  # six full-attention archs at long_500k, hubert's two decodes


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for name, shape in SHAPES.items():
        for kw in ({}, {"batch_override": 3, "seq_override": 40}):
            got = ptu.tree_flatten_with_paths(input_specs(cfg, shape, **kw))
            want = jptu.tree_flatten_with_paths(jinput_specs(jcfg, JSHAPES[name], **kw))
            assert [p for p, _ in got] == [p for p, _ in want], (name, kw)
            for (path, t), (_, j) in zip(got, want):
                assert t.device.type == "meta"
                assert (tuple(t.shape), _dtype(t)) == (tuple(j.shape), str(j.dtype)), path


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference_leaf_by_leaf(arch):
    """Every reference leaf, by its path, with its stacked shape and type;
    the whole tree's bytes."""
    _, model, _, jspecs = _specs(arch)
    got = dict(ptu.tree_flatten_with_paths(model))
    want = dict(jptu.tree_flatten_with_paths(jspecs))
    assert sorted(got) == sorted(want)
    for path, j in want.items():
        assert (tuple(got[path].shape), _dtype(got[path])) == (tuple(j.shape), str(j.dtype)), path
    assert all(p.device.type == "meta" for p in model.parameters())
    assert ptu.tree_bytes(model) == jptu.tree_bytes(jspecs)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_active_params_match_reference(arch, jdryrun):
    cfg, model, jcfg, jspecs = _specs(arch)
    assert dryrun.active_params(cfg, model) == jdryrun.active_params(jcfg, jspecs)


# ---------------------------------------------------------------------------
# per-device state bytes on the production meshes
# ---------------------------------------------------------------------------


def _local_bytes(shape, spec, sizes: dict, itemsize: int) -> int:
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        n *= d // math.prod(sizes[a] for a in axes)
    return n * itemsize


@pytest.mark.parametrize("mesh", MESHES, ids=list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_state_bytes_match_reference(arch, mesh, jdryrun):
    """The training state's bytes a device holds: the port's reckoning from
    its layout's shard shapes against the reference's ``infer_pspecs`` specs
    on ``repro.dist.plan.abstract_mesh``, with the plan's roles from the
    reference's ``make_plan``.  The reference's ``step`` counter (an int32
    on the device) is the one leaf the port keeps on the host."""
    cfg, model, jcfg, jspecs = _specs(arch)
    shape, axes = MESHES[mesh]
    param_bytes = ptu.tree_bytes(model)
    plan = lmesh.make_plan(abstract_mesh(shape, axes), param_bytes=param_bytes)
    # the reference's rule reads mesh.devices.size, which jax's AbstractMesh
    # lacks: its roles come from the port's abstract mesh, its specs from jax's
    roles = jmake_plan(abstract_mesh(shape, axes), param_bytes=param_bytes)
    jmesh = jabstract_mesh(shape, axes)
    jplan = JShardingPlan(mesh=jmesh, dp=roles.dp, fsdp=roles.fsdp, tp=roles.tp, ep=roles.ep)
    assert (plan.dp, plan.fsdp, plan.tp, plan.ep) == (jplan.dp, jplan.fsdp, jplan.tp, jplan.ep)
    big = jcfg.d_model >= 6144 or jcfg.num_experts >= 64
    jopt = jnp.bfloat16 if big else jnp.float32
    assert dryrun.opt_dtype_of(cfg) == (torch.bfloat16 if big else torch.float32)
    state = jax.eval_shape(lambda p: jinit_state(p, jsgd(momentum=0.9, state_dtype=jopt),
                                                 div_dtype=jopt), jspecs)
    specs = jsharding.infer_pspecs(state, jplan)
    sizes = dict(zip(axes, shape))
    want = 0
    leaves = jptu.tree_flatten_with_paths(state)
    spec_leaves = jax.tree.leaves(specs,
                                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    for (path, leaf), spec in zip(leaves, spec_leaves):
        b = _local_bytes(leaf.shape, spec, sizes, jnp.dtype(leaf.dtype).itemsize)
        if path == "step":
            assert b == 4
            continue
        want += b
    assert dryrun.state_bytes(model, plan, dryrun.opt_dtype_of(cfg)) == want
    train = SHAPES["train_4k"]
    assert dryrun._micro_plan(cfg, train, plan) == jdryrun._micro_plan(jcfg, JSHAPES["train_4k"],
                                                                       jplan)


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO count
# ---------------------------------------------------------------------------


def _reference_step_hlo(jcfg, b: int, s: int) -> str:
    opt = jsgd(momentum=0.9)
    state = jax.eval_shape(lambda p: jinit_state(p, opt), jtf.param_specs(jcfg))
    key = "tokens" if jcfg.input_mode == "tokens" else "embeddings"
    x = (jax.ShapeDtypeStruct((b, s), jnp.int32) if key == "tokens"
         else jax.ShapeDtypeStruct((b, s, jcfg.d_model), jnp.float32))
    batch = {key: x, "targets": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    step = jax.jit(jmake_train_step(jcfg, opt, 1))
    return step.lower(state, batch, jax.ShapeDtypeStruct((), jnp.float32)).compile().as_text()


def _dots(text: str, result: str) -> int:
    """Dot instructions of the HLO whose result type is ``result``."""
    prog = HloProgram(text)
    return sum(1 for c in prog.computations.values() for ins in c.instrs
               if ins.opcode == "dot" and ins.type_str.split("{")[0] == result)


def _gap(arch: str, cfg, b: int, s: int) -> tuple[int, str]:
    """The named FLOP gap (port minus reference) of a train step, exactly."""
    t = b * s
    if s == cfg.xent_chunk:
        return 2 * t * cfg.d_model * cfg.vocab_size, f"f32[{t},{cfg.vocab_size}]"
    if cfg.num_experts:
        return -cfg.num_layers * 2 * (2 * t * cfg.d_model * cfg.num_experts), \
            f"f32[{cfg.d_model},{cfg.num_experts}]"
    if "mamba" in cfg.pattern:
        d_inner = cfg.ssm_expand * cfg.d_model
        return cfg.num_layers * 2 * t * d_inner * cfg.ssm_state, ""
    return 0, ""


@pytest.mark.parametrize("arch,s", [("yi-6b", 64), ("yi-6b", 128), ("qwen2-7b", 128),
                                    ("dbrx-132b", 128), ("falcon-mamba-7b", 128),
                                    ("hubert-xlarge", 128)])
def test_train_step_flops_match_reference_hlo(arch, s):
    """Tolerance: exact, after the named gap (module docstring)."""
    b = 2
    cfg = get_config(arch, reduced=True).replace(remat=True)
    jcfg = jget(arch, reduced=True).replace(remat=True)
    text = _reference_step_hlo(jcfg, b, s)
    want = analyze_hlo(text)["flops"]
    got = dryrun.trace_train(cfg, None, b, s, 1, torch.float32)["analysis"]
    gap, dots = _gap(arch, cfg, b, s)
    assert got["flops"] - want == gap
    assert got["flops"] > 0 and got["peak_bytes"] > 0 and not got["collectives"]["by_kind"]
    if arch == "yi-6b":
        # the logits' product: once with one chunk (merged), forward and
        # recompute with two; the port's forward, recompute, dx and dW either way
        assert _dots(text, f"f32[{b * cfg.xent_chunk},{cfg.vocab_size}]") == \
            (1 if s == cfg.xent_chunk else 2)
        assert got["flops_by_op"]["addmm"] == 2 * b * s * cfg.d_model * cfg.vocab_size
    if arch == "dbrx-132b":
        assert _dots(text, dots) == 2  # the router's dW, once per use of the logits


def test_decode_and_prefill_flops_match_reference_hlo():
    """yi-6b's ``decode_step`` over a 64-token cache and its ``prefill_step``
    of 64 tokens: exact."""
    cfg, jcfg = get_config("yi-6b", reduced=True), jget("yi-6b", reduced=True)
    params = jtf.param_specs(jcfg)
    tok = jax.ShapeDtypeStruct((2, 1), jnp.int32)
    text = jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c, t)).lower(
        params, jtf.cache_specs(jcfg, 2, 64), tok).compile().as_text()
    got = dryrun.trace_decode(cfg, None, 2, 64)
    assert got["analysis"]["flops"] == analyze_hlo(text)["flops"]
    assert got["cache_bytes"] == got["cache_bytes_reference_layout"] == ptu.tree_bytes(
        tf.cache_specs(cfg, 2, 64))
    batch = {"tokens": jax.ShapeDtypeStruct((2, 64), jnp.int32)}
    text = jax.jit(lambda p, x: jtf.prefill_step(jcfg, p, x)).lower(params, batch) \
        .compile().as_text()
    assert dryrun.trace_prefill(cfg, None, 2, 64)["analysis"]["flops"] == \
        analyze_hlo(text)["flops"]


# ---------------------------------------------------------------------------
# tensor-parallel compute
# ---------------------------------------------------------------------------

# (attention, Mamba mixer, FFN, whole) of each pattern position's tp_split
# at T 16
TP16 = {
    "yi-6b": {("shared", None, "dense", ())},
    "qwen2-7b": {("context", None, "dense", ())},  # 28 heads: context-parallel
    "llama3-405b": {("shared", None, "dense", ())},
    "gemma2-27b": {("local", None, "dense", ())},
    "internvl2-1b": {("context", None, "dense", ())},  # 14 heads: context-parallel
    "dbrx-132b": {("shared", None, "moe", ())},
    "kimi-k2-1t-a32b": {("shared", None, "moe", ())},
    "falcon-mamba-7b": {(None, "channels", None, ())},  # d_inner 8192: 512 a rank
    "jamba-v0.1-52b": {("shared", None, "dense", ()), (None, "channels", "moe", ()),
                       (None, "channels", "dense", ())},
    "hubert-xlarge": {("local", None, "dense", ())},
}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_tp_split_of_the_full_configs_at_16(arch):
    cfg = get_config(arch)
    plan = ShardingPlan(mesh=abstract_mesh((16, 16), ("data", "model")))
    got = {sharding.tp_split(cfg, p, plan) for p in range(cfg.period)}
    assert {(s.attn, s.ssm, s.ffn, s.whole) for s in got} == TP16[arch]
    assert all(s.size == 16 and s.residual for s in got)  # 16 divides every d_model
    assert sharding.tp_split(cfg, 0, ShardingPlan(mesh=abstract_mesh((16, 1), (
        "data", "model")))) == sharding.TpSplit(1)
    if cfg.moe_impl != "ep" and cfg.num_experts:  # moe_impl="ep" over 16 expert ranks: whole
        pos = next(p for p in range(cfg.period) if cfg.ffn_kind(p) == "moe")
        ep = sharding.tp_split(cfg.replace(moe_impl="ep"), pos, plan)
        assert ep.ffn is None and "moe_ep" in ep.whole


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_serving_split_keeps_the_mamba_mixers_whole(arch):
    """At T 16 training splits every Mamba mixer by channels; serving keeps
    each whole, counted in ``whole`` (its per-slot state holds every
    channel), and splits the rest as training does."""
    cfg = get_config(arch)
    plan = ShardingPlan(mesh=abstract_mesh((16, 16), ("data", "model")))
    for p in range(cfg.period):
        train, serve = sharding.tp_split(cfg, p, plan), sharding.serving_split(cfg, p, plan)
        if cfg.pattern[p] == "mamba":
            assert train.ssm == "channels" and "mamba" not in train.whole
            assert serve.ssm is None and serve.whole == ("mamba",) + train.whole
            assert serve.role("mamba.in_proj.weight") is None
            assert serve.role("mamba.dt_proj.bias") is None
        else:  # serving keeps the residual stream whole
            assert serve == dataclasses.replace(train, residual=False)


def test_tp_split_keeps_a_mixer_whole_where_the_channels_do_not_divide():
    """falcon-mamba-7b at d_model 36 (d_inner 72) on ``(16, 16)``: 16 does
    not divide the channels, so the mixer computes whole, counted in
    ``whole``, and no Mamba leaf is resident; at T 8 (72 = 8 x 9) it
    splits."""
    cfg = get_config("falcon-mamba-7b").replace(d_model=36)
    split = sharding.tp_split(cfg, 0, ShardingPlan(mesh=abstract_mesh((16, 16), (
        "data", "model"))))
    assert (split.size, split.ssm, split.whole) == (16, None, ("mamba",))
    assert all(split.role(n) is None for n in ("mamba.in_proj.weight", "mamba.A_log",
                                                "mamba.dt_proj.bias"))
    split = sharding.tp_split(cfg, 0, ShardingPlan(mesh=abstract_mesh((2, 8), (
        "data", "model"))))
    assert (split.size, split.ssm, split.whole) == (8, "channels", ())
    assert split.role("mamba.in_proj.weight") == "resident"
    assert split.role("mamba.dt_proj.bias") == "partial"


def test_tp_trace_records_the_context_exchanges():
    """Reduced qwen2-7b at 3/1 heads of hd 16 on 4 tp ranks (attention
    context-parallel): the traced step records per layer two all-to-alls
    of ``B S H hd/T`` float32 values in the forward and two in the
    backward, one k/v all-gather, and one reduce-scatter of k and v's
    gradient (summed over tp) beside the split residual's four (the
    sublayers' exits and their entries' summed backward, each of the whole
    ``B S d``); the dry run traces the last tp rank, whose
    rows see the most keys, and its FLOPs exceed rank 0's."""
    b, s, t = 2, 32, 4
    cfg = get_config("qwen2-7b", reduced=True).replace(num_heads=3, num_kv_heads=1,
                                                        d_model=48)
    hd = cfg.resolved_head_dim

    def trace(rank):
        with dryrun.fake_world(t, rank):
            mesh = dryrun.rank_mesh((1, t), ("data", "model"))
            plan = ShardingPlan(mesh=mesh, dp=("data",), fsdp=("data",), tp="model",
                                ep=("data",))
            assert sharding.tp_split(cfg, 0, plan, s).attn == "context"
            return dryrun.trace_train(cfg, plan, b, s, 1, torch.float32)["analysis"]

    last, first = trace(t - 1), trace(0)
    coll = last["collectives"]["by_kind"]
    layers = cfg.num_layers
    assert coll["all-to-all"]["count"] == 4 * layers
    assert coll["all-to-all"]["operand_bytes"] == 4 * layers * b * s * 3 * hd // t * 4
    # a layer's k/v gradient, and the split residual's: the attention's and
    # the FFN's exits in the forward, their entries' sums in the backward
    assert coll["reduce-scatter"]["count"] == 5 * layers
    assert coll["reduce-scatter"]["operand_bytes"] == layers * (
        2 * b * s * hd * 4 + 4 * b * s * cfg.d_model * 4)
    assert last["flops"] > first["flops"]
    full = get_config("qwen2-7b")
    assert dryrun.traced_rank(full, dryrun.SHAPES["train_4k"], False, 0) == 15
    assert dryrun.traced_rank(full, dryrun.SHAPES["prefill_32k"], False, 0) == 0
    assert dryrun.traced_rank(get_config("yi-6b"), dryrun.SHAPES["train_4k"], True, 0) == 0


def _tp_trace_flops(vocab: int):
    """Reduced yi-6b at ``vocab`` on 4 tp ranks: rank 0's traced FLOPs of
    a 2-layer train microbatch, and the one-device trace's split into a
    layer's, the rest's (the embedding and the head) and k and v's."""
    b, s = 2, 64
    cfg = get_config("yi-6b", reduced=True).replace(remat=True, vocab_size=vocab)

    def flops(layers, plan=None):
        return dryrun.trace_train(cfg.replace(num_layers=layers), plan, b, s, 1,
                                  torch.float32)["analysis"]["flops"]

    one, two = flops(1), flops(2)
    layer, rest = two - one, 2 * one - two  # a layer's and the embedding's and head's
    # k and v: forward, remat recompute, dx, dW, at every KV head on one device
    kv = 4 * 2 * (2 * b * s * cfg.d_model * cfg.num_kv_heads * cfg.resolved_head_dim)
    with dryrun.fake_world(4):
        mesh = dryrun.rank_mesh((1, 4), ("data", "model"))
        plan = ShardingPlan(mesh=mesh, dp=("data",), fsdp=("data",), tp="model", ep=("data",))
        assert sharding.tp_split(cfg, 0, plan) == sharding.TpSplit(4, "shared", "dense",
                                                                    residual=True)
        got = flops(2, plan)
    # a rank computes 1 of the 2 KV heads: kv / 2 = kv / 4 (its share) + kv / 4
    assert layer % 4 == 0 and kv % 4 == 0
    return got, layer, rest, kv, 4 * 2 * b * s * cfg.d_model * vocab


def test_tp_trace_keeps_the_ranks_residual_columns():
    """Reduced yi-6b under remat on a fake ``(data 1, model 4)`` world: the
    traced train step's checkpointed layer inputs are each layer's ``(B,
    S, d/4)`` columns of the residual, ``layers x B S (d/4)`` float32
    values in all (``remat_kept_bytes``, from ``transformer.remat_counts``;
    and a ``saved_tensors_hooks`` count of the fake tensors autograd keeps
    outside the remat regions), a quarter of one device's trace; the
    record's ``activations`` name the split for training and the whole
    residual for serving."""
    b, s, t = 2, 32, 4
    cfg = get_config("yi-6b", reduced=True).replace(remat=True)
    cols = (b, s, cfg.d_model // t)
    saved = []

    def pack(x):
        saved.append((tuple(x.shape), x.untyped_storage().nbytes()))
        return x

    with dryrun.fake_world(t):
        mesh = dryrun.rank_mesh((1, t), ("data", "model"))
        plan = ShardingPlan(mesh=mesh, dp=("data",), fsdp=("data",), tp="model", ep=("data",))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            kept = dryrun.trace_train(cfg, plan, b, s, 1, torch.float32)["remat_kept_bytes"]
        train, serve = (dryrun.activations(cfg, kind, plan) for kind in ("train", "prefill"))
    layer_bytes = math.prod(cols) * 4
    assert kept == cfg.num_layers * layer_bytes
    assert [n for shape, n in saved if shape == cols] == [layer_bytes] * cfg.num_layers
    assert dryrun.trace_train(cfg, None, b, s, 1, torch.float32)["remat_kept_bytes"] \
        == t * kept
    assert "residual stream split by d_model columns" in train
    assert "residual stream whole" in serve


def test_tp_trace_keeps_the_residual_whole_where_t_does_not_divide_d_model():
    """Reduced falcon-mamba-7b at d_model 36 (d_inner 72) under remat on a
    fake ``(data 1, model 8)`` world: 8 divides the channels and not
    ``d_model``, so the mixers split while the residual stays whole on the
    rank (``tp_whole`` "residual" a layer, nothing falls back silently):
    remat keeps each layer's whole ``(B, S, d)``, the residual issues none
    of its collectives, and the mixers' exits are all-reduces."""
    from repro_torch.dist.plan import reset_residual_counts, residual_counts
    from repro_torch.models import ssm

    b, s, t = 2, 32, 8
    cfg = get_config("falcon-mamba-7b", reduced=True).replace(d_model=36, remat=True)
    with dryrun.fake_world(t):
        mesh = dryrun.rank_mesh((1, t), ("data", "model"))
        plan = ShardingPlan(mesh=mesh, dp=("data",), fsdp=("data",), tp="model", ep=("data",))
        assert not sharding.residual_split(cfg, plan)
        assert sharding.tp_split(cfg, 0, plan).ssm == "channels"
        tf.reset_tp_counts()
        reset_residual_counts()
        kept = dryrun.trace_train(cfg, plan, b, s, 1, torch.float32)["remat_kept_bytes"]
        counts, res, mixers = tf.tp_counts(), residual_counts(), ssm.collective_counts()
    layers = cfg.num_layers
    assert kept == layers * b * s * cfg.d_model * 4
    assert counts["tp_whole"]["residual"] == layers and "residual" not in counts["tp_split"]
    assert counts["tp_split"]["mamba"] == layers
    assert not any(v["calls"] for v in res.values()), res
    assert mixers["out_proj_all_reduce"]["calls"] == layers


def test_tp_trace_flops_split_over_the_model_axis():
    """Reduced yi-6b (4 query heads over 2 KV heads) on 4 tp ranks: each
    rank one query head and the KV head it shares with one other rank; at
    its vocab of 251 the head computes whole on every rank."""
    got, layer, rest, kv, _ = _tp_trace_flops(251)
    assert got == rest + 2 * (layer // 4 + kv // 4)


def test_tp_trace_flops_split_the_head_over_the_model_axis():
    """The same at vocab 256: each rank computes its 64 head rows, so the
    head's four products (the logits, their recompute in the backward, dx
    and dW, each ``2 b s d V``) come to a quarter each."""
    got, layer, rest, kv, head = _tp_trace_flops(256)
    assert got == rest - (head - head // 4) + 2 * (layer // 4 + kv // 4)


# the serving KV heads of rank t of 16 by ``serving_kv_heads`` at the first
# attention position: every head, "local" (KV/16 = 1 each) or the head 16/KV
# ranks share
SERVE16 = {"yi-6b": "shared", "qwen2-7b": "whole", "llama3-405b": "shared",
           "gemma2-27b": "local", "internvl2-1b": "whole", "dbrx-132b": "shared",
           "kimi-k2-1t-a32b": "shared", "falcon-mamba-7b": "whole",
           "jamba-v0.1-52b": "shared", "hubert-xlarge": "local"}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serving_kv_heads_of_the_full_configs_at_16(arch):
    """``serving_kv_heads`` of each tp rank of 16: every head where attention
    computes whole (qwen2's 28 and internvl2's 14 heads, a Mamba
    position), one head each where 16 divides the KV heads, else the one
    head ``t // (16 / KV)`` whole; pure arithmetic, as ``tp_split``."""
    cfg = get_config(arch)
    plan = ShardingPlan(mesh=abstract_mesh((16, 16), ("data", "model")))
    pos = next((p for p in range(cfg.period) if cfg.pattern[p] != "mamba"), 0)
    got = [sharding.serving_kv_heads(cfg, pos, plan, t) for t in range(16)]
    kv = cfg.num_kv_heads
    want = {"whole": [(0, kv)] * 16, "local": [(t * kv // 16, kv // 16) for t in range(16)],
            "shared": [(t // (16 // max(kv, 1)), 1) for t in range(16)]}[SERVE16[arch]]
    assert got == want
    if "mamba" in cfg.pattern:
        assert sharding.serving_kv_heads(cfg, cfg.pattern.index("mamba"), plan, 3) == (0, kv)
    assert sharding.serving_kv_heads(cfg, pos, None) == (0, kv)


def test_serving_cache_holds_one_shared_head():
    """Reduced yi-6b (4 query heads over 2 KV heads) on a fake ``(data 1,
    model 4)`` world: two ranks share each KV head and each holds it whole,
    so ``trace_decode``'s and ``trace_prefill``'s caches are one head's
    exactly (k and v float32, and ``len``); the reference's layout splits
    ``head_dim`` over the 4 ranks, half as much."""
    cfg = get_config("yi-6b", reduced=True)
    b, s = 2, 64
    one_head = 2 * cfg.num_layers * b * s * cfg.resolved_head_dim * 4
    with dryrun.fake_world(4):
        mesh = dryrun.rank_mesh((1, 4), ("data", "model"))
        plan = ShardingPlan(mesh=mesh, dp=("data",), fsdp=("data",), tp="model", ep=("data",))
        assert sharding.serving_kv_heads(cfg, 0, plan) == (0, 1)
        dec = dryrun.trace_decode(cfg, plan, b, s)
        pre = dryrun.trace_prefill(cfg, plan, b, s)
    assert dec["cache_bytes"] == pre["cache_bytes"] == one_head + 4
    assert dec["cache_bytes_reference_layout"] == pre["cache_bytes_reference_layout"] \
        == one_head // 2 + 4


# ---------------------------------------------------------------------------
# the mini dry run in a fake world, and a production cell
# ---------------------------------------------------------------------------


def test_mini_dryrun_in_a_fake_world_of_8():
    """The reference's mini dry run's cells on a (pod 2, data 2, model 2)
    plan, rank 0 of a fake world of 8."""
    shape = ShapeConfig("mini_train", "train", 64, 16)
    with dryrun.fake_world(8):
        mesh = dryrun.rank_mesh((2, 2, 2), ("pod", "data", "model"))
        plan = ShardingPlan(mesh=mesh, dp=("pod", "data"), fsdp=("pod", "data"), tp="model",
                            ep=("pod", "data"))
        for arch in ("qwen2-7b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"):
            cfg = get_config(arch, reduced=True).replace(remat=True)
            res = dryrun.trace_train(cfg, plan, shape.global_batch // 2, shape.seq_len, 2,
                                     torch.float32,
                                     moe_groups=plan.dp_size if cfg.num_experts else 1)
            a = res["analysis"]
            assert a["flops"] > 0 and a["peak_bytes"] > 0, arch
            kinds = a["collectives"]["by_kind"]
            assert kinds["all-gather"]["count"] > 0 and kinds["reduce-scatter"]["count"] > 0
            assert a["collectives"]["total_time_s"] > 0, arch
            assert res["state_bytes"] == dryrun.state_bytes(tf.param_specs(cfg), plan,
                                                            torch.float32), arch
        res = dryrun.trace_decode(get_config("yi-6b", reduced=True), plan, 16, 64)
        assert res["analysis"]["flops"] > 0 and res["analysis"]["peak_bytes"] > 0
        # 16 rows over dp 4: 4 a rank, and 1 of the 2 kv heads over tp 2:
        # the reference's layout
        assert res["cache_bytes"] == res["cache_bytes_reference_layout"]
    with pytest.raises(RuntimeError, match="process group exists"):
        with dryrun.fake_world(2):
            with dryrun.fake_world(2):
                pass


def test_run_cell_records_a_production_cell(tmp_path):
    rec = dryrun.run_cell("yi-6b", "decode_32k", False, str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 256 and rec["plan"]["tp"] == "model"
    m, c = rec["memory"], rec["cost"]
    assert m["state_bytes"] == dryrun.state_bytes(
        tf.param_specs(dryrun.dryrun_config("yi-6b")), lmesh.make_plan(
            abstract_mesh((16, 16), ("data", "model"))), None)
    assert m["fits_80gb"] == (m["peak_bytes"] <= 80e9)
    # one KV head of 4 whole a rank (4 ranks share it), where the reference
    # splits head_dim over the 16: 4 times its layout, but for ``len``
    assert m["cache_bytes"] == 4 * m["cache_bytes_reference_layout"] - 3 * 4
    assert c["flops_per_device"] > 0 and 0 < c["useful_flops_ratio"] < 1
    assert rec["collectives"]["by_kind"]["all-gather"]["count"] > 0
    assert rec["roofline"]["step_time_lower_bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s", "collective_s"))
    assert rec["hardware"]["power_limit_w"] == 700
    assert (tmp_path / "yi-6b__decode_32k__pod16x16.json").exists()
    skip = dryrun.run_cell("hubert-xlarge", "decode_32k", True, None)
    assert skip["status"] == "skipped" and skip["mesh"] == "pod2x16x16"
