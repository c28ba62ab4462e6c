"""Tensor-parallel compute in training, on the CPU: each block's attention
heads, dense-FFN widths and expert widths split over the ``model`` axis of
a rank rung (``dist.sharding.tp_split``, ``models/transformer.py``), on
gloo ranks spawned from ``tests/_scaleout_ranks.py`` (``slow`` marker, the
lane of the repo's process-group tests).

  * reduced yi-6b (4 query heads over 2 KV heads: "local" at T 2, "shared"
    at T 4), qwen2-7b (the replicated ``qkv_bias``), gemma2-27b (windows,
    both softcaps), hubert-xlarge (non-causal, the frontend), dbrx-132b at
    ``moe_groups=2``, jamba-v0.1-52b (Mamba mixers split by channels next
    to split attention and MoE; the gram tier too at T 4) and falcon-mamba-7b
    (the mixers alone, under remat) on ``(model 2)``, ``(model 4)`` and
    ``(data 2, model 2)`` rungs: the moment tier (yi under a DiveBatch
    program) and the gram tier for yi, against the one-process whole run and the
    reference's single-device ``make_train_step(dp_size=...)``: schedules
    and buckets exact, losses and ``sq_norm_sum`` within 1e-5 relative,
    parameters within 1e-5 relative plus 5e-5 of each tensor's RMS (the
    bounds of ``test_torch_sharded.py``), each rank holding exactly the
    elements the specs reckon;
  * that the compute splits: spies on ``_self_attention`` and the FFNs'
    products see ``H/T`` query heads and ``ff/T`` columns on every rank,
    ``tp_counts`` names each sublayer split or whole, ``MoE.stats`` (drops,
    the commonest first expert) are equal on every tp rank, and the bytes
    the block entries gather equal their reckoning (the fsdp axes only
    where every sublayer splits over local heads); the Mamba scan runs
    ``d_inner/T`` channels, no mixer product sees ``in_proj`` whole, and
    the ``in_proj`` exchange sends a rank's blocks that are not its own
    (at most its shard) a layer and pass;
  * ``gradcheck`` in float64 of ``copy_to_group`` and ``reduce_from_group``
    (around the context-parallel exchanges and the Mamba mixer's ``in_proj``
    exchange and ``x_proj`` sum too), the exchange's rows against the whole
    weight's, and the k/v and bias gradients of reduced qwen2-7b at T 4
    summed over the model group (the gather's former slice-own rule gets
    them wrong);
  * the input and the head split: reduced yi-6b at vocab 256 (both tiers,
    on every rung), gemma2-27b at 256 (the final softcap on split logits)
    and hubert-xlarge at 64 (the frontend) take the vocab-parallel
    cross-entropy and the embedding's (frontend's) ``d/T`` columns, held
    as above; the embedding, the frontend and the head reach the compute
    as the rank's shards and no all-gather outside the blocks forms a
    ``(V, d)`` table; ``xent_vocab_parallel`` against ``xent_chunked`` on
    the whole head, targets on the shard edges, within 1e-6 relative;
  * the residual stream split by ``d_model`` columns in every case above
    (T divides each reduced ``d_model``): ``tp_counts`` has "residual"
    split on every layer, and ``dist.plan.residual_counts`` (the sublayers'
    entry all-gathers and their summed backward's reduce-scatters, the
    exits' reduce-scatters and their backward's all-gathers, the remat
    recompute's again) equal the reckoning; reduced yi at vocab 256,
    dbrx-132b and falcon-mamba-7b under remat on ``(model 2)`` and
    ``(model 4)``: every checkpointed layer keeps the rank's ``(B, S,
    d/T)`` columns in a storage of their size (a ``saved_tensors_hooks``
    count), every norm scale's and the MoE router's gradient is the same on
    every rank and within 1e-5 of one process's, and ``gradcheck`` of the
    entry, the exit and the slice in float64.

Two spawns, 2 ranks and 4, run beside the reference's runs in this
process.
"""

import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _scaleout_ranks as ranks  # noqa: E402
from repro import adapt as jadapt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import probes as jprobes  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import StepEngine as JStepEngine  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.utils.pytree import _path_str  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.plan import ShardingPlan, abstract_mesh  # noqa: E402
from repro_torch.models import probes  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402

torch.set_num_threads(2)

SEQ = ranks.SEQ
_CONTEXT = {"num_heads": 3, "num_kv_heads": 1, "d_model": 48}
# params: (arch, seed of the reference init, config replacements); the
# reduced configs' vocabularies (251, hubert's 63) leave the head whole over
# tp, 256 and 64 split it
ARCHS = {"yi": ("yi-6b", 2, {}), "qwen2": ("qwen2-7b", 3, {}), "gemma2": ("gemma2-27b", 4, {}),
         "hubert": ("hubert-xlarge", 5, {}), "dbrx": ("dbrx-132b", 6, {}),
         "jamba": ("jamba-v0.1-52b", 7, {}), "yi256": ("yi-6b", 9, {"vocab_size": 256}),
         "gemma2_256": ("gemma2-27b", 10, {"vocab_size": 256}),
         "hubert64": ("hubert-xlarge", 11, {"vocab_size": 64}),
         # 3/1 heads of hd 16: no T of 2 or 4 divides the heads, every one
         # their widths (48, 16) and SEQ, so attention runs context-parallel
         "qwen2ctx": ("qwen2-7b", 13, {**_CONTEXT, "attn_impl": "pallas"}),
         "intern": ("internvl2-1b", 14, _CONTEXT),
         # d_inner 128: its channels split at T 2 and 4; remat, so the
         # recompute issues the mixer's exchanges again
         "falcon": ("falcon-mamba-7b", 15, {"remat": True})}
# each case names its rung (data, model); jamba at lr 0.01 (PERF.md: lr 0.1
# turns its float32 rounding into 1e-4 of its parameters in a few steps)
SHAPES_2, SHAPES_4 = [(1, 2)], [(1, 4), (2, 2)]
_BASE = [
    {"name": "yi_gram", "params": "yi", "seed": 3, "tier": "gram"},
    {"name": "qwen2", "params": "qwen2", "seed": 4},
    {"name": "gemma2", "params": "gemma2", "seed": 5},
    {"name": "hubert", "params": "hubert", "seed": 6},
    {"name": "dbrx", "params": "dbrx", "seed": 7, "moe_groups": 2},
    {"name": "jamba", "params": "jamba", "seed": 8, "moe_groups": 2, "lr": 0.01, "steps": 1},
]
# the head split over the vocabulary: yi on both tiers on every rung
_VOCAB = [{"name": "yi256", "params": "yi256", "seed": 9},
          {"name": "yi256_gram", "params": "yi256", "seed": 10, "tier": "gram"}]
_HUBERT64 = {"name": "hubert64", "params": "hubert64", "seed": 12}
_FALCON = {"name": "falcon", "params": "falcon", "seed": 15}
# the split residual's own checks (tp_residual): (params, arch, replacements)
# under remat, so that each layer's input is what checkpoint keeps
RESIDUAL_CASES = [(k, ARCHS[k][0], {**ARCHS[k][2], "remat": True})
                  for k in ("yi256", "dbrx", "falcon")]
# context-parallel attention: qwen2 (its replicated biases) on the kernel
# lane's plain versions, the moment tier; internvl2 (the frontend) on the
# gram tier; on every rung
_CONTEXT_CASES = [{"name": "qwen2ctx", "params": "qwen2ctx", "seed": 13},
                  {"name": "intern_gram", "params": "intern", "seed": 14, "tier": "gram"}]
CASES_2 = [{**c, "shape": (1, 2)} for c in
           [{"name": "yi_program", "params": "yi", "seed": 1, "program": True}] + _BASE
           + _VOCAB + [{"name": "gemma2_256", "params": "gemma2_256", "seed": 11}, _HUBERT64]
           + _CONTEXT_CASES + [_FALCON]]
CASES_4 = [{**c, "shape": (1, 4)} for c in _BASE + _VOCAB + [_HUBERT64] + _CONTEXT_CASES + [
    _FALCON, {"name": "jamba_gram", "params": "jamba", "seed": 16, "moe_groups": 2,
              "lr": 0.01, "steps": 1, "tier": "gram"}]] + [
    {"name": "yi_program_dp", "params": "yi", "seed": 1, "program": True, "shape": (2, 2)},
    {"name": "dbrx_dp", "params": "dbrx", "seed": 7, "moe_groups": 2, "shape": (2, 2)},
] + [{**c, "name": c["name"] + "_dp", "shape": (2, 2)} for c in _VOCAB + _CONTEXT_CASES
     + [_FALCON]]
for _c in CASES_2 + CASES_4:
    _c["arch"], _, _c["extra"] = ARCHS[_c["params"]]


def _cfgs(case: dict):
    """The port's and the reference's reduced config of a case, its
    replacements applied to both."""
    return get_config(case["arch"], reduced=True).replace(**case["extra"]), \
        jget(case["arch"], reduced=True).replace(**case["extra"])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(path): leaf for path, leaf in flat}


def _reference(case: dict, jparams) -> dict:
    """The reference's single-device run of a case at the rung's dp width:
    ``make_train_step(dp_size=dp)`` (the gram tier with its interpret-mode
    kernels), or ``StepEngine.for_lm`` under the program."""
    jcfg = _cfgs(case)[1]
    dp = case["shape"][0]
    out = {"loss": [], "sq_norm_sum": [], "batch": [], "diversity": []}
    opt = jsgd(momentum=0.9)
    state = jinit_state(jparams, opt)
    if case.get("program"):
        eng = JStepEngine.for_lm(jcfg, opt, micro_batch=4, dp_size=dp, attn_impl="pallas")
        program = ranks.lm_program(jadapt)
        m = program.batch_size
        for step in range(6):
            b = {k: jax.numpy.asarray(v) for k, v in
                 ranks.tp_batch(jcfg, case["seed"], step, m).items()}
            state, metrics = eng.step(state, b, 0.1)
            out["loss"].append(float(metrics["loss"]))
            out["batch"].append(m)
            if step in (2, 5):
                sig, state = jadapt.read_signals(state, "moment", reset=True, batch_size=m)
                program.observe(sig, jadapt.Clock(epoch=step // 3, step=step + 1,
                                                  boundary="tick"))
                out["diversity"].append(sig.diversity)
                m = program.batch_size
        out["buckets"] = list(eng.stats.buckets)
    else:
        kw = {}
        if case.get("tier") == "gram":
            jcfg = jcfg.replace(scan_layers=False)
            kw = dict(probe_loss=lambda p, pr, b: jprobes.loss_with_probes(jcfg, p, pr, b),
                      probe_specs=lambda p, n: jprobes.probe_specs(jcfg, n, SEQ),
                      psn_interpret=True)
        step = jax.jit(jmake_train_step(jcfg, opt, 2, dp_size=dp,
                                        estimator=case.get("tier", "moment"),
                                        moe_groups=case.get("moe_groups", 1), **kw))
        for i in range(case.get("steps", 3)):
            b = {k: jax.numpy.asarray(v) for k, v in
                 ranks.tp_batch(jcfg, case["seed"], i, 8).items()}
            state, metrics = step(state, b, jax.numpy.float32(case.get("lr", 0.1)))
            out["loss"].append(float(metrics["loss"]))
            out["sq_norm_sum"].append(float(state.div_state.sq_norm_sum))
    out["params"] = _np_tree(state.params)
    return out


def _whole(case: dict, jparams) -> dict | None:
    """The port's one-process run of a case with whole state (``dp_size``
    lays the batch out as the rung's data ranks split it); None for the
    program cases, held against the reference only."""
    if case.get("program"):
        return None
    cfg = _cfgs(case)[0]
    kw = {}
    if case.get("tier") == "gram":
        kw = dict(probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
                  probe_specs=lambda p, n: probes.probe_specs(cfg, n, SEQ, device="cpu"))
    opt = sgd(momentum=0.9)
    state = init_state(interop.params_from_jax(_np_tree(jparams), cfg), opt)
    step = make_train_step(cfg, opt, 2, dp_size=case["shape"][0],
                           estimator=case.get("tier", "moment"),
                           moe_groups=case.get("moe_groups", 1), **kw)
    out = {"loss": [], "sq_norm_sum": []}
    for i in range(case.get("steps", 3)):
        state, metrics = step(state, ranks.tp_batch(cfg, case["seed"], i, 8),
                              case.get("lr", 0.1))
        out["loss"].append(float(metrics["loss"]))
        out["sq_norm_sum"].append(state.div_state.sq_norm_sum.item())
    out["params"] = {n: p.detach().numpy() for n, p in state.params.named_parameters()}
    return out


def _close(got: np.ndarray, want: np.ndarray):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5 * np.sqrt(np.mean(want ** 2)))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Both spawns started at once, the reference's and the one-process
    runs computed meanwhile, then the ranks' results."""
    jparams = {k: jtf.init_params(jget(arch, reduced=True).replace(**extra),
                                  jax.random.key(seed))
               for k, (arch, seed, extra) in ARCHS.items()}
    args = {k: _np_tree(v) for k, v in jparams.items()}
    started = {
        2: ranks.start_ranks(tmp_path_factory.mktemp("tp2"),
                             "tp_gradcheck+tp_xent+tp_residual+tp_train",
                             {**args, "shapes": SHAPES_2, "cases": CASES_2,
                              "residual_cases": RESIDUAL_CASES}, 2),
        4: ranks.start_ranks(tmp_path_factory.mktemp("tp4"),
                             "tp_gradcheck+tp_xent+tp_grads+tp_residual+tp_train",
                             {**args, "shapes": SHAPES_4, "cases": CASES_4,
                              "residual_cases": RESIDUAL_CASES, "shape": (1, 4)}, 4)}
    cases = {(w, c["name"]): c for w, cs in ((2, CASES_2), (4, CASES_4)) for c in cs}
    want, whole = {}, {}
    for key, c in cases.items():
        ref_key = (c["name"].removesuffix("_dp"), c["shape"][0])  # one run per dp width
        if ref_key not in want:
            want[ref_key] = _reference(c, jparams[c["params"]])
            whole[ref_key] = _whole(c, jparams[c["params"]])
    got = {w: ranks.collect(s, deadline_s=300) for w, s in started.items()}
    return {"got": got, "want": want, "whole": whole, "cases": cases}


def _ref_key(case: dict):
    return case["name"].removesuffix("_dp"), case["shape"][0]


IDS = [(2, c["name"]) for c in CASES_2] + [(4, c["name"]) for c in CASES_4]


@pytest.mark.slow
@pytest.mark.parametrize("world,name", IDS)
def test_tp_training_matches_reference_and_whole_run(tp_runs, world, name):
    case = tp_runs["cases"][(world, name)]
    w = tp_runs["want"][_ref_key(case)]
    o = tp_runs["whole"][_ref_key(case)]
    cfg = _cfgs(case)[0]
    jref = {leaf.path: leaf for leaf in interop.layout(tf.build(cfg, "meta"))}
    flat = _flat(w["params"])
    for r in range(world):
        g = tp_runs["got"][world][r]["tp_train"][name]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        if case.get("program"):
            assert g["batch"] == w["batch"] and len(set(w["batch"])) > 1
            assert g["buckets"] == w["buckets"]
            np.testing.assert_allclose(g["diversity"], w["diversity"], rtol=1e-4)
        else:
            np.testing.assert_allclose(g["sq_norm_sum"], w["sq_norm_sum"], rtol=1e-5)
            np.testing.assert_allclose(g["loss"], o["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["sq_norm_sum"], o["sq_norm_sum"], rtol=1e-5)
            for n, v in o["params"].items():
                _close(g["params"][n], v)
        for path, leaf in jref.items():  # the gathered parameters against the reference's
            ref = np.asarray(flat[path])
            for i, n in enumerate(leaf.names):
                part = ref[i] if leaf.stacked else ref
                _close(g["params"][n], part.T if leaf.form == "t" else part)
        assert g["held"] == g["reckoned"] < sum(v.size for v in g["params"].values())


@pytest.mark.slow
@pytest.mark.parametrize("world,name", IDS)
def test_tp_compute_splits_heads_and_widths(tp_runs, world, name):
    """The spies' head counts and widths on every rank, the split and whole
    sublayers counted per forward, the block entries' gathered bytes.
    Context-parallel attention: every head over the rank's ``SEQ/T`` query
    rows at offset ``r SEQ/T`` against the keys up to its last row, and
    per layer of a forward one all-to-all each way of ``B SEQ H hd/T``
    values and one all-gather of k and v (``2 B SEQ KV hd``), as the spies
    and ``context_parallel_counts`` see them.  The residual split by columns
    on every layer, its collectives by kind the reckoning's
    (:func:`_residual_reckoning`)."""
    case = tp_runs["cases"][(world, name)]
    cfg = _cfgs(case)[0]
    data, t = case["shape"]
    plan = ShardingPlan(mesh=abstract_mesh(case["shape"], ("data", "model")), tp="model")
    splits = [sharding.tp_split(cfg, p, plan, SEQ) for p in range(cfg.period)]
    assert all(s.size == t for s in splits)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    heads = {(h, kv) if s.attn == "context" else (h // t, kv // t if s.attn == "local" else 1)
             for s in splits if s.attn}
    shared = {s.attn for s in splits if s.attn} == {"shared"}
    assert shared == (kv > 0 and h % t == 0 and t % kv == 0 and kv < t)  # falcon: no heads
    context = {s.attn for s in splits if s.attn} == {"context"}
    assert context == (h % t != 0 and name.startswith(("qwen2ctx", "intern")))
    st = SEQ // t
    for r in range(world):
        g = tp_runs["got"][world][r]["tp_train"][name]
        assert set(map(tuple, g["heads"])) == heads
        rank = r % t  # the model axis is the rung's last
        if context:
            assert set(map(tuple, g["rows"])) == {(st, rank * st, (rank + 1) * st)}, g["rows"]
            n = 2 * SEQ * h * hd // t * 4  # the forward's batch of 2 sequences, float32
            want = [("all-to-all", n), ("all-gather", 2 * 2 * SEQ * kv * hd * 4),
                    ("all-to-all", n)] * cfg.num_layers
            assert [tuple(c) for c in g["context_colls"]] == want, g["context_colls"]
            cp = g["cp_counts"]
            calls = _micro(case, g) * cfg.num_layers * (2 if case.get("tier") == "gram" else 1)
            assert {k: c["calls"] for k, c in cp.items()} == dict.fromkeys(cp, calls), cp
        else:
            assert set(map(tuple, g["rows"])) == ({(SEQ, 0, SEQ)} if heads else set()), g["rows"]
            assert not g["context_colls"]
        assert set(g["ffn"]) == ({cfg.d_ff // t} if any(s.ffn == "dense" for s in splits)
                                 else set())
        assert set(g["moe"]) == ({cfg.d_ff // t} if any(s.ffn == "moe" for s in splits)
                                 else set())
        micro = _micro(case, g)
        # the input and the head count per call: the gram tier's probe pass too
        calls = micro * (2 if case.get("tier") == "gram" else 1)
        want_split, want_whole = {_input_kind(cfg): calls}, {}
        (want_split if cfg.vocab_size % t == 0 else want_whole)["head"] = calls
        assert all(s.residual for s in splits)  # T divides every reduced d_model
        for layer in range(cfg.num_layers):
            s = splits[layer % cfg.period]
            attn = [] if not s.attn else ["attn_context" if s.attn == "context" else "attn"]
            for kind in attn + (["mamba"] if s.ssm else []) + ([s.ffn] if s.ffn else []) \
                    + ["residual"]:
                want_split[kind] = want_split.get(kind, 0) + micro
            for kind in s.whole:
                want_whole[kind] = want_whole.get(kind, 0) + micro
        assert g["tp_counts"] == {"tp_split": want_split, "tp_whole": want_whole}
        # the router is replicated: every tp rank routes, drops and counts alike
        assert g["moe_stats"] == tp_runs["got"][world][0]["tp_train"][name]["moe_stats"]
        assert bool(g["moe_stats"]) == bool(cfg.num_experts)
        assert g["block_gather_bytes"] == g["block_gather_reckoned"]
        assert g["residual_counts"] == _residual_reckoning(cfg, splits, _micro(case, g),
                                                            4 // data)
        _mixers_split(cfg, case, g, splits, rank)
        if not shared and not any(s.whole for s in splits):
            # every block splits over local heads: its entry gathers the fsdp axes only
            model = tf.build(cfg, "meta")
            specs = sharding.param_pspecs(model, plan)
            fsdp = sum(np.prod(sharding.local_shape(p.shape, specs[n], plan)) * data
                       * p.element_size() for n, p in model.named_parameters()
                       if n.startswith("blocks.") and "data" in specs[n])
            assert g["block_gather_bytes"] == fsdp


def _residual_reckoning(cfg, splits, micro: int, bm: int) -> dict:
    """The split residual's collectives on a rank over ``micro``
    microbatches of ``bm`` sequences, by kind (``dist.plan.
    residual_counts``), per microbatch: an entry
    all-gather per sublayer and one at the head, again in the remat
    recompute; an entry reduce-scatter behind each split sublayer and a
    split head (a whole one slices); an exit reduce-scatter per split
    sublayer, again in the recompute but for a layer's last (it stops once
    the layer's saved tensors are back), and an exit all-gather in the
    backward; a slice all-gather behind each whole sublayer (the embedding
    and the frontend split whenever T divides ``d_model``).  Each call moves
    the whole ``(bm, SEQ, d)`` float32 tensor.  The gram tier's probe pass
    keeps the residual whole: none of these."""
    n_sub = n_split = n_last = 0
    for layer in range(cfg.num_layers):
        p = layer % cfg.period
        s = splits[p]
        subs = [bool(s.ssm if cfg.pattern[p] == "mamba" else s.attn)]
        if cfg.d_ff > 0:
            subs.append(s.ffn is not None)
        n_sub, n_split, n_last = n_sub + len(subs), n_split + sum(subs), n_last + subs[-1]
    again = bool(cfg.remat)
    head = cfg.vocab_size % splits[0].size == 0
    calls = {"entry_all_gather": n_sub + 1 + again * n_sub,
             "entry_reduce_scatter": n_split + head,
             "exit_reduce_scatter": n_split + again * (n_split - n_last),
             "exit_all_gather": n_split, "slice_all_gather": n_sub - n_split}
    whole = bm * SEQ * cfg.d_model * 4
    return {k: {"calls": n * micro, "bytes": n * micro * whole} for k, n in calls.items()}


def _mixers_split(cfg, case: dict, g: dict, splits, rank: int) -> None:
    """A rank's Mamba mixers: the scan over its ``c = d_inner/T`` channels
    (``dt``, ``A_log`` and the state), no product seeing ``in_proj`` whole
    but its ``[x_t | z_t]`` rows, and by ``ssm.collective_counts`` per
    mixer and pass one ``in_proj`` exchange sending the rank's blocks that
    are not its own and one ``x_proj`` all-reduce (float32); in the
    backward one exchange back and ``x_proj``'s ``tp.copy`` all-reduce.
    The training stack's split residual takes the mixer's entry and exit
    (:func:`_residual_reckoning`): no ``out_proj`` all-reduce and no
    ``tp.copy`` of its input.  The remat recompute issues the exchange and
    the ``x_proj`` all-reduce again.  The gram tier's probe pass keeps the
    residual whole: it runs the mixers' forward once more with one
    ``out_proj`` all-reduce and, its parameters frozen, the backward's two
    ``tp.copy`` all-reduces (the input's and ``x_proj``'s) only behind a
    probe (jamba's layer 0 mixer comes before the first)."""
    layers = [layer for layer in range(cfg.num_layers) if splits[layer % cfg.period].ssm]
    if not layers:
        assert not g["scan"] and not any(v["calls"] for v in g["mamba_counts"].values())
        return
    t, d = splits[0].size, cfg.d_model
    d_inner = cfg.ssm_expand * d
    c = d_inner // t
    assert set(map(tuple, g["scan"])) == {(c, c, c)}, g["scan"]
    weights = set(map(tuple, g["mamba_weights"]))
    assert (2 * d_inner, d) not in weights and (2 * c, d) in weights, weights
    assert (d, c) in weights and (d, d_inner) not in weights, weights
    micro = _micro(case, g)
    probed = [layer for layer in range(cfg.num_layers) if cfg.pattern[layer % cfg.period]
              != "mamba" or (cfg.d_ff and cfg.ffn_kind(layer % cfg.period) == "dense")]
    gram = case.get("tier") == "gram"
    fwd = len(layers) * micro * (2 if gram else 1)
    back = len(layers) * micro
    probe = len(layers) * micro if gram else 0  # the probe pass's forwards
    probe_back = sum(lay > probed[0] for lay in layers) * micro if gram else 0
    again = back if cfg.remat else 0
    sent = sum(b % t != rank for b in (2 * rank, 2 * rank + 1)) * c * d * 4
    bm = 4 // case["shape"][0]  # a microbatch's sequences on the rank
    x_proj = bm * SEQ * ((cfg.ssm_dt_rank or math.ceil(d / 16)) + 2 * cfg.ssm_state) * 4
    x = bm * SEQ * d * 4
    want = {"in_proj_exchange": (fwd + again, (fwd + again) * sent),
            "x_proj_all_reduce": (fwd + again, (fwd + again) * x_proj),
            "out_proj_all_reduce": (probe, probe * x),
            "in_proj_exchange_back": (back, back * sent),
            "copy_back": (back + 2 * probe_back,
                          back * x_proj + probe_back * (x + x_proj))}
    got = {k: (v["calls"], v["bytes"]) for k, v in g["mamba_counts"].items()}
    assert got == want, (got, want)


def _micro(case: dict, g: dict) -> int:
    """The microbatches of a case's run on a rank (2 a step, 4 sequences
    each under the program)."""
    return sum(b // 4 for b in g["batch"]) if case.get("program") else 2 * case.get("steps", 3)


def _input_kind(cfg) -> str:
    return "embed" if cfg.input_mode == "tokens" else "frontend"


@pytest.mark.slow
@pytest.mark.parametrize("world,name", IDS)
def test_tp_forms_no_vocab_table_whole(tp_runs, world, name):
    """The embedding (or frontend) and the head reach the compute as the
    rank's tp shards: ``(V, d/T)`` (the embedding gathered over fsdp only),
    ``(d/T, d)``, ``(V/T, d)``; the head whole only where T does not divide
    V.  The input and the head (the training forward's and the probe
    pass's) all-gather only the input's columns, the logsumexps and target
    logits, and the embedding's (the frontend's) tp shard over fsdp, by
    calls and bytes; the vocab-parallel
    collectives' calls and bytes are the reckoning's (2 microbatches a step
    of ``4 / data`` sequences of ``SEQ``, float32).  The training forward
    splits the residual: its input enters as the rank's columns (no input
    all-gather) and its head's dx is summed by the final entry's
    reduce-scatter (no head all-reduce); the gram tier's probe pass keeps
    the residual whole and issues both."""
    case = tp_runs["cases"][(world, name)]
    cfg = _cfgs(case)[0]
    data, t = case["shape"]
    v, d = cfg.vocab_size, cfg.d_model
    split_head = v % t == 0
    want = {"lm_head.weight": (v // t, d) if split_head else (v, d)}
    if cfg.input_mode == "tokens":
        want["embed.weight"] = (v, d // t)
    else:
        want["frontend.weight"] = (d // t, d)
    for r in range(world):
        g = tp_runs["got"][world][r]["tp_train"][name]
        assert {n: tuple(shape) for n, shape in g["leaves"]} == want, g["leaves"]
        assert len(g["leaves"]) == len(want), g["leaves"]  # one shape a leaf
        vp = g["vp_counts"]
        probe = _micro(case, g) if case.get("tier") == "gram" else 0  # the probe pass's
        calls = _micro(case, g) + probe
        head = calls if split_head else 0
        assert {k: c["calls"] for k, c in vp.items()} == {
            "input_all_gather": probe, "xent_all_gather": head,
            "head_all_reduce": probe if split_head else 0}, vp
        # every all-gather of the input and the head accounted for: the
        # input's columns, the logsumexps, and (over data) the rank's tp shard
        # of the embedding or frontend, float32
        rows = v if cfg.input_mode == "tokens" else d  # the leaf's dim over fsdp
        fsdp = calls if data > 1 and rows % data == 0 else 0
        shard = 4 * rows * (d // t)
        assert len(g["vocab_gathers"]) == probe + head + fsdp, g["vocab_gathers"]
        assert sum(g["vocab_gathers"]) == vp["input_all_gather"]["bytes"] \
            + vp["xent_all_gather"]["bytes"] + fsdp * shard
        if not case.get("program"):
            bm = 4 // data
            assert vp["input_all_gather"]["bytes"] == probe * bm * SEQ * d * 4
            assert vp["head_all_reduce"]["bytes"] == (probe if split_head else 0) \
                * bm * SEQ * d * 4
            assert vp["xent_all_gather"]["bytes"] == head * t * 2 * bm * SEQ * 4


@pytest.mark.slow
def test_vocab_parallel_xent_matches_whole(tp_runs):
    """``xent_vocab_parallel`` behind ``copy_to_group`` on 2 and 4 model
    ranks and on ``(data 2, model 2)``, targets on the shard edges: the
    loss, dx and the rank's dW rows within 1e-6 relative of
    ``xent_chunked`` on the whole head, with and without the softcap."""
    for world, shapes in ((2, SHAPES_2), (4, SHAPES_4)):
        for r in range(world):
            got = tp_runs["got"][world][r]["tp_xent"]
            assert len(got) == 2 * len(shapes)
            for key, e in got.items():
                t = int(key[0].split("x")[1])
                assert e["edges"] == 2 * t, (world, r, key)  # v0 - 1 is the last shard's end
                assert max(e["loss"], e["dx"], e["dw"]) < 1e-6, (world, r, key, e)


@pytest.mark.slow
def test_copy_and_reduce_gradcheck(tp_runs):
    """``gradcheck`` on every rank of ``copy_to_group`` / ``reduce_from_group``
    around a rank's own map, and around the context-parallel exchanges: the
    q and out all-to-alls, and the k/v all-gather whose backward sums over
    tp (a slice-own backward fails it); around the Mamba mixer's ``in_proj``
    exchange and ``x_proj``'s sum over tp (summed in the backward too); the
    split residual's entry (summed backward), exit and slice; and the
    exchange gives each rank exactly its ``[x_t | z_t]`` rows of the whole
    weight, at T 2 and 4."""
    for world, shapes in ((2, SHAPES_2), (4, SHAPES_4)):
        for r in range(world):
            got = tp_runs["got"][world][r]["tp_gradcheck"]
            want = {"x".join(map(str, s)) + kind: True for s in shapes
                    for kind in ("", " all-to-all", " k/v all-gather", " in_proj exchange",
                                 " x_proj sum", " in_proj rows", " residual entry",
                                 " residual exit", " residual slice")}
            assert got == want, (world, r, got)


@pytest.mark.slow
def test_kv_and_bias_gradients_summed_over_the_model_group(tp_runs):
    """qwen2 at T 4 (each KV head shared by 2 ranks, biases replicated):
    the gathered gradients equal the whole model's when the k/v and bias
    gradients are summed over tp, and not with the slice-own rule; under
    the split residual the norm scales' too (each rank's a part)."""
    for r in range(4):
        got = tp_runs["got"][4][r]["tp_grads"]
        assert got["split"] == "shared"
        assert max(got["summed"].values()) < 1e-5, got
        assert got["slice_own"]["kv"] > 0.1 and got["slice_own"]["bias"] > 0.1, got
        assert got["slice_own"]["norm"] > 0.1, got
        assert got["slice_own"]["other"] < 1e-5, got


RESIDUAL_IDS = [(w, k) for w in (2, 4) for k, _, _ in RESIDUAL_CASES]


def _residual_rec(tp_runs, world: int, r: int, name: str) -> dict:
    return tp_runs["got"][world][r]["tp_residual"][f"1x{world} {name}"]


def _residual_cfg(name: str):
    _, arch, extra = next(c for c in RESIDUAL_CASES if c[0] == name)
    return get_config(arch, reduced=True).replace(**extra)


@pytest.mark.slow
@pytest.mark.parametrize("world,name", RESIDUAL_IDS)
def test_residual_remat_keeps_the_ranks_columns(tp_runs, world, name):
    """Under remat each checkpointed layer keeps its input, the rank's
    ``(B, S, d/T)`` columns of the residual, in a storage of exactly their
    bytes (not a view of a gathered whole), on every rank of ``(model 2)``
    and ``(model 4)``: the ``saved_tensors_hooks`` count of one
    microbatch (B 2), one such tensor a layer."""
    cfg = _residual_cfg(name)
    cols = (2, SEQ, cfg.d_model // world)
    for r in range(world):
        saved = _residual_rec(tp_runs, world, r, name)["saved"]
        kept = [n for shape, n in saved if tuple(shape) == cols]
        assert kept == [math.prod(cols) * 4] * cfg.num_layers, (r, saved)


@pytest.mark.slow
@pytest.mark.parametrize("world,name", RESIDUAL_IDS)
def test_residual_collectives_match_the_reckoning(tp_runs, world, name):
    """One microbatch's forward, remat recompute and backward: the split
    residual's collectives by kind, calls and bytes, equal
    :func:`_residual_reckoning`'s; and the tensor-parallel all-reduces that
    sum a norm scale's gradient once over tp: one behind each split
    sublayer's norm and the vocab-parallel head's final norm (reduced yi
    at vocab 256 issues no other)."""
    cfg = _residual_cfg(name)
    plan = ShardingPlan(mesh=abstract_mesh((1, world), ("data", "model")), tp="model")
    splits = [sharding.tp_split(cfg, p, plan, SEQ) for p in range(cfg.period)]
    want = _residual_reckoning(cfg, splits, 1, 2)  # one microbatch of 2 sequences
    for r in range(world):
        rec = _residual_rec(tp_runs, world, r, name)
        assert rec["counts"] == want, (r, rec["counts"], want)
        if name == "yi256":
            norms = 2 * cfg.num_layers + 1
            assert rec["tp"] == {"calls": norms, "bytes": norms * cfg.d_model * 4}, rec["tp"]


@pytest.mark.slow
@pytest.mark.parametrize("world,name", RESIDUAL_IDS)
def test_norm_and_router_gradients_match_one_process(tp_runs, world, name):
    """One microbatch's gradients under the split residual against the
    whole model's on one process: every norm scale (a part on each rank,
    summed over tp once), the MoE router (its input's gradient the same on
    every rank, counted once), and every other leaf within 1e-5 of the
    largest magnitude; each norm scale's and router's gradient is the same
    on every tp rank, to the bit.  A sum taken T times or not at all misses
    by far more."""
    first = _residual_rec(tp_runs, world, 0, name)
    assert ("router" in first["err"]) == (name == "dbrx")
    for r in range(world):
        rec = _residual_rec(tp_runs, world, r, name)
        assert max(rec["err"].values()) < 1e-5, (r, rec["err"])
        assert rec["grads"].keys() == first["grads"].keys()
        for n, g in rec["grads"].items():
            assert np.array_equal(g, first["grads"][n]), (r, n)
        np.testing.assert_allclose(rec["loss"], first["loss"], rtol=1e-6)
