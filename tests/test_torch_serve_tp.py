"""Tensor-parallel serving, on the CPU: decode and chunked prefill split over
the ``model`` axis of a rank rung (``models/transformer.py``,
``serve/engine.py``), on gloo ranks spawned from ``tests/_scaleout_ranks.py``
(``slow`` marker, the lane of the repo's process-group tests).

  * reduced yi-6b at vocab 256 (the head split over the vocabulary; 4 query
    heads over 2 KV heads: "local" at T 2, "shared" at T 4) and at its
    vocab of 251 (the head whole), qwen2-7b (the replicated ``qkv_bias``),
    gemma2-27b (rings, both softcaps, a full-prompt prefix hit), dbrx-132b
    (``moe_apply(tp=)``) and jamba-v0.1-52b (Mamba computing whole beside
    split attention and MoE) on fixed ``(model 2)`` and ``(model 4)``
    plans, and yi and gemma2 on ``MeshLadder(model_axes=(("model", 2),))``
    over 4 ranks, whose ramping trace grows onto ``(data 2, model 2)`` and
    shrinks back: greedy tokens equal one process's and the reference's
    single-device ``ServeEngine``'s; every decode step's logits within
    1e-5 relative of one process's; each rank's pool and slot cache (rings,
    Mamba state) equal to one process's at its rows and its KV heads
    ``[first, first + count)`` within 1e-5 of each leaf's largest magnitude
    (the sentinel block aside), and equal across the ranks of a tp
    coordinate;
  * the traps of a ladder under tp: the ranks that enter ``(data 2, model
    2)`` take the pool and the rows from the first rank of their own tp
    coordinate (``_from_root``), and the rows split over the data axis
    count once in the token agreement (``_agree``);
  * that the compute splits: spies on the serving attention wrappers and
    the FFNs see ``H/T`` query heads over the rank's KV heads and ``ff/T``
    columns, ``tp_counts`` names each sublayer split or whole, each rank
    holds exactly the parameter elements its layout reckons;
  * ``prefill_step`` (the dense cache), ``prefill_chunk`` and paged
    ``decode_step`` called on a tp-sharded module against the whole one;
  * reduced internvl2-1b and hubert-xlarge (at vocab 64) on ``(model 2)``
    through ``prefill_step`` and ``decode_step`` on frames: the frontend's
    output columns split over tp, tokens equal one process's and the
    reference's, logits within 1e-5 relative of one process's;
  * ``launch/serve.py --tp 2`` under two ranks against one process, and
    ``moe_impl="ep"`` on a tp rung refused, naming Queue A 5.

Two spawns, 2 ranks and 4, run beside the one-process and reference runs
in this process.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _scaleout_ranks as ranks  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.plan import ShardingPlan, abstract_mesh  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

MAX_SEQ, GRANULE = 64, 8
LENS = [5, 3, 8, 2, 6, 4, 7, 5]
# the first request outlives the rest: the ladder's bucket falls back to 1
MAX_NEW = [16, 6, 6, 4, 4, 4, 4, 4]
# name: (arch, seed of the reference init, config replacements)
PARAMS = {"yi256": ("yi-6b", 11, {"vocab_size": 256}), "yi": ("yi-6b", 12, {}),
          "qwen2": ("qwen2-7b", 13, {}), "gemma2": ("gemma2-27b", 14, {}),
          "dbrx": ("dbrx-132b", 15, {}), "jamba": ("jamba-v0.1-52b", 16, {})}
ENTRIES = ("yi256", "gemma2", "jamba")  # the entry points called directly
# embedding-input configs, served through the entry points on the 2 ranks
# (the engine is tokens-only): the frontend split, the head whole at vocab
# 251 and split at 64
FRONTEND = {"internvl2": ("internvl2-1b", 17, {}),
            "hubert64": ("hubert-xlarge", 18, {"vocab_size": 64})}
FRONTEND_CASES = [{"name": n, "params": n, "arch": arch, "extra": extra}
                  for n, (arch, _, extra) in FRONTEND.items()]
CASES_2 = [{"name": f"{n}@1x2", "params": n, "shape": (1, 2), "entries": n in ENTRIES}
           for n in PARAMS]
CASES_4 = [{"name": f"{n}@1x4", "params": n, "shape": (1, 4), "entries": n in ENTRIES}
           for n in PARAMS] + [{"name": f"{n}@ladder", "params": n, "shape": "ladder"}
                               for n in ("yi256", "gemma2")]
for _c in CASES_2 + CASES_4:
    _c["arch"], _, _c["extra"] = PARAMS[_c["params"]]
# logits and held state, relative to the largest magnitude (float32; the
# residual stream's all-reduces sum in another order: jamba's 8 layers reach
# 2.4e-6 in its Mamba state and pool)
REL = 1e-5


def _cfgs(name):
    arch, _, extra = {**PARAMS, **FRONTEND}[name]
    return get_config(arch, reduced=True).replace(**extra), \
        jget(arch, reduced=True).replace(**extra)


def _prompts():
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 251, size=n).astype(np.int32) for n in LENS]
    prompts[4] = prompts[1].copy()  # submitted after the second's prefill: a full-prompt hit
    return prompts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns started together; while they run, the one-process port
    engine on each config (recorded as the ranks record, a snapshot after
    every step) and the reference's engine."""
    tmp = tmp_path_factory.mktemp("serve_tp")
    trees = {}
    for name, (arch, seed, _) in {**PARAMS, **FRONTEND}.items():
        _, jcfg = _cfgs(name)
        trees[name] = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.key(seed)))
    prompts = _prompts()
    r = np.random.default_rng(19)
    d = _cfgs("internvl2")[0].d_model  # the reduced configs' common width
    frames = r.standard_normal((2, 16, d), dtype=np.float32)
    steps = [r.standard_normal((2, 1, d), dtype=np.float32) for _ in range(4)]
    args = {"trees": trees, "prompts": prompts, "max_new": MAX_NEW, "max_seq": MAX_SEQ,
            "granule": GRANULE}
    (tmp / "two").mkdir()
    (tmp / "four").mkdir()
    two = ranks.start_ranks(tmp / "two", "serve_tp+serve_tp_cli+serve_tp_frontend",
                            {**args, "cases": CASES_2, "frontend_cases": FRONTEND_CASES,
                             "frames": frames, "steps": steps}, 2)
    four = ranks.start_ranks(tmp / "four", "serve_tp", {**args, "cases": CASES_4}, 4)
    kw = dict(max_slots=8, max_seq=MAX_SEQ, prompt_granule=GRANULE, block_size=8,
              prefill_chunk=8)
    one, ref = {}, {}
    for name in PARAMS:
        cfg, jcfg = _cfgs(name)
        eng = ServeEngine(cfg, params_from_jax(trees[name], cfg), device="cpu", **kw)
        one[name] = ranks.serve_recorded(eng, [Request(prompt=p, max_new_tokens=m)
                                               for p, m in zip(prompts, MAX_NEW)], every=True)
        jeng = JServeEngine(jcfg, jax.tree.map(jax.numpy.asarray, trees[name]), **kw)
        ref[name] = [r.tokens.tolist() for r in jeng.generate(
            [JRequest(prompt=p, max_new_tokens=m) for p, m in zip(prompts, MAX_NEW)])]
    for name in FRONTEND:
        cfg, jcfg = _cfgs(name)
        one[name] = ranks.frontend_serve(cfg, params_from_jax(trees[name], cfg), frames, steps)
        jparams = jax.tree.map(jax.numpy.asarray, trees[name])
        logits, cache = jtf.prefill_step(jcfg, jparams, {"embeddings": jax.numpy.asarray(frames)})
        ref[name] = [np.asarray(logits)]
        for e in steps if cfg.causal else []:
            logits, cache = jtf.decode_step(jcfg, jparams, cache, jax.numpy.asarray(e))
            ref[name].append(np.asarray(logits))
    return {"two": ranks.collect(two, 300), "four": ranks.collect(four, 300), "one": one,
            "ref": ref}


def _cases():
    return [("two", c) for c in CASES_2] + [("four", c) for c in CASES_4]


def _ids():
    return [c["name"] for _, c in _cases()]


def _recs(runs, spawn, case):
    return {r: out["serve_tp"][case["name"]] for r, out in sorted(runs[spawn].items())}


def _tp_size(case) -> int:
    return 2 if case["shape"] == "ladder" else case["shape"][1]


def _split(case, pos: int = None):
    """The case's ``tp_split`` at its first attention position (or
    ``pos``), on an abstract mesh of its tp size."""
    cfg, _ = _cfgs(case["params"])
    if pos is None:
        pos = next(p for p in range(cfg.period) if cfg.pattern[p] != "mamba")
    plan = ShardingPlan(mesh=abstract_mesh((1, _tp_size(case)), ("data", "model")))
    return cfg, sharding.tp_split(cfg, pos, plan)


@pytest.mark.slow
@pytest.mark.parametrize("spawn,case", _cases(), ids=_ids())
def test_tokens_and_logits_match_one_process(runs, spawn, case):
    """Every rank's greedy tokens equal one process's and the reference
    engine's; every decode step's logits (this rank's rows) lie within
    1e-5 relative of one process's."""
    one = runs["one"][case["params"]]
    assert one["tokens"] == runs["ref"][case["params"]]
    by_step = {step: (live, logits) for step, _, live, logits in one["logits"]}
    for r, rec in _recs(runs, spawn, case).items():
        assert rec["tokens"] == one["tokens"], f"rank {r}"
        assert rec["logits"], f"rank {r} decoded nothing"
        for step, (lo, hi), live, logits in rec["logits"]:
            whole_live, whole = by_step[step]
            assert (live == whole_live[lo:hi]).all(), (r, step)
            if live.any():
                want = whole[lo:hi][live]
                rel = np.abs(logits[live] - want).max() / np.abs(want).max()
                assert rel <= REL, (r, step, rel)


def _rel_gap(x: np.ndarray, w: np.ndarray) -> float:
    return float(np.abs(x - w).max() / max(np.abs(w).max(), 1e-30)) if x.size else 0.0


def _held_gap(snap: dict, want: dict, first: int, count: int) -> float:
    """The largest gap, relative to the leaf's largest magnitude, of a
    rank's snapshot from one process's at its rows (where the rank's leaf
    holds a share of them) and KV heads (the pools' sentinel block
    aside)."""
    lo, hi = snap["rows"]
    gap = 0.0
    for path, x in snap["pool"].items():
        w = want["pool"][path][..., first:first + count, :]
        assert x.shape == w.shape, (path, x.shape, w.shape)
        gap = max(gap, _rel_gap(x[:, 1:], w[:, 1:]))
    for path, x in snap["cache"].items():
        w = want["cache"][path]
        ax = 0 if w.ndim == 1 else 1
        if x.shape[ax] != w.shape[ax]:
            w = w[lo:hi] if ax == 0 else w[:, lo:hi]
        if path.rsplit("/", 1)[-1] in ("k", "v"):
            w = w[..., first:first + count, :]
        assert x.shape == w.shape, (path, x.shape, w.shape)
        gap = max(gap, _rel_gap(x, w))
    return gap


@pytest.mark.slow
@pytest.mark.parametrize("spawn,case", _cases(), ids=_ids())
def test_each_rank_holds_its_kv_heads(runs, spawn, case):
    """Each rank's KV heads are ``serving_kv_heads``' (its ``KV/T``
    "local", the one it shares "shared"); at its last step on the widest
    rung its pool and slot cache (rings, Mamba state, lengths) equal one
    process's at the same step, at its rows and heads, within 1e-5 of each
    leaf's largest magnitude (float32 rounding: the residual stream's
    all-reduce sums in another order); the ranks of one tp coordinate hold
    equal pools."""
    cfg, split = _split(case)
    one = runs["one"][case["params"]]
    recs = _recs(runs, spawn, case)
    pools: dict = {}
    for r, rec in recs.items():
        want = split.kv_heads(cfg.num_kv_heads, rec["tp_rank"]) if split.attn \
            else (0, cfg.num_kv_heads)
        assert (rec["first"], rec["kv_heads"]) == want, f"rank {r}"
        assert rec["tp_rank"] == r % _tp_size(case)
        snap = rec["snap"]
        assert snap is not None, f"rank {r} never served on the widest rung"
        gap = _held_gap(snap, one["snaps"][snap["step"]], rec["first"], rec["kv_heads"])
        assert gap <= REL, (r, gap)
        pools.setdefault(rec["tp_rank"], []).append((snap["step"], snap["pool"]))
    for t, held in pools.items():
        for (step, pool), (step2, pool2) in zip(held, held[1:]):
            assert step == step2
            for path in pool:
                np.testing.assert_array_equal(pool[path][:, 1:], pool2[path][:, 1:])


# the sublayers each case serves split and whole (tp_counts' kinds)
KINDS = {"yi256": ({"attn", "dense", "embed", "head"}, set()),
         "yi": ({"attn", "dense", "embed"}, {"head"}),
         "qwen2": ({"attn", "dense", "embed"}, {"head"}),
         "gemma2": ({"attn", "dense", "embed"}, {"head"}),
         "dbrx": ({"attn", "moe", "embed"}, {"head"}),
         "jamba": ({"attn", "dense", "moe", "embed"}, {"mamba", "head"})}


@pytest.mark.slow
@pytest.mark.parametrize("spawn,case", _cases(), ids=_ids())
def test_the_compute_splits(runs, spawn, case):
    """The serving attention calls see ``H/T`` query heads over the rank's
    KV heads, the dense FFNs and the experts ``ff/T`` columns; ``tp_counts``
    names the sublayers split and whole; each rank holds the parameter
    elements its layout reckons, fewer than the whole model (a rank outside
    the ladder's last rung keeps it whole)."""
    cfg, split = _split(case)
    t = _tp_size(case)
    whole = sum(p.numel() for p in tf.param_specs(cfg).parameters())
    for r, rec in _recs(runs, spawn, case).items():
        assert [tuple(h) for h in rec["heads"]] == [(cfg.num_heads // t, rec["kv_heads"])], r
        ff = {cfg.d_ff // t}
        assert set(rec["ffn"]) == (ff if "dense" in KINDS[case["params"]][0] else set())
        assert set(rec["moe"]) == (ff if cfg.num_experts else set())
        split_kinds, whole_kinds = KINDS[case["params"]]
        assert set(rec["tp_counts"]["tp_split"]) == split_kinds, rec["tp_counts"]
        assert set(rec["tp_counts"]["tp_whole"]) == whole_kinds, rec["tp_counts"]
        if rec["reckoned"] is None:  # outside the ladder's last rung: the whole model
            assert case["shape"] == "ladder" and r >= 2 and rec["held"] == whole
        else:
            assert rec["held"] == rec["reckoned"] < whole


LADDERS = [("four", c) for c in CASES_4 if c["shape"] == "ladder"]


@pytest.mark.slow
@pytest.mark.parametrize("spawn,case", LADDERS, ids=[c["name"] for _, c in LADDERS])
def test_ladder_grow_takes_state_from_its_tp_coordinate(runs, spawn, case):
    """On ``MeshLadder(model_axes=(("model", 2),))`` over 4 ranks the ramp
    grows onto ``(data 2, model 2)`` and back: ranks 2 and 3, which enter
    the wide rung, hold at their last step on it the pool of their own tp
    coordinate, the one-process pool's heads of ranks 0 and 1 (a broadcast
    from the rung's first rank alone would give rank 3 rank 0's heads)."""
    one = runs["one"][case["params"]]
    recs = _recs(runs, spawn, case)
    for r, rec in recs.items():
        assert rec["rungs"] == [0, 1] and rec["reshards"] >= 2, (r, rec["rungs"])
    for r in (2, 3):
        snap, mate = recs[r]["snap"], recs[r - 2]
        assert recs[r]["first"] == mate["first"] and recs[r]["tp_rank"] == mate["tp_rank"]
        assert _held_gap(snap, one["snaps"][snap["step"]], mate["first"],
                         mate["kv_heads"]) <= REL, r


@pytest.mark.slow
@pytest.mark.parametrize("spawn,case", LADDERS, ids=[c["name"] for _, c in LADDERS])
def test_rows_split_over_dp_agree_once(runs, spawn, case):
    """On ``(data 2, model 2)`` each data row's two tp ranks decode its
    rows alike; the token agreement counts them once: every rank decoded a
    strict share of some bucket and records one process's tokens."""
    one = runs["one"][case["params"]]
    bucket = {step: logits.shape[0] for step, _, _, logits in one["logits"]}
    for r, rec in _recs(runs, spawn, case).items():
        split = [step for step, (lo, hi), _, _ in rec["logits"] if hi - lo < bucket[step]]
        assert split and rec["tokens"] == one["tokens"], r


@pytest.mark.slow
@pytest.mark.parametrize("spawn", ["two", "four"])
@pytest.mark.parametrize("name", ENTRIES)
def test_entry_points_on_a_tp_sharded_module(runs, spawn, name):
    """``prefill_step`` then lockstep ``decode_step`` over its dense cache,
    ``prefill_chunk`` then paged ``decode_step``, on a module sharded on
    the tp plan against the whole module: logits, the dense cache, the
    rings and the pool at the rank's KV heads within 1e-5 relative."""
    case = f"{name}@1x{2 if spawn == 'two' else 4}"
    for r, out in runs[spawn].items():
        e = out["serve_tp"][case]["entries"]
        assert e["logits_rel"] <= REL and e["cache_gap"] <= REL, (r, e)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(FRONTEND))
def test_frontend_serves_split_on_two_ranks(runs, name):
    """An embedding-input config on ``(model 2)`` through ``prefill_step``
    (every position's logits for hubert, an encoder) and, for internvl2, 4
    lockstep ``decode_step``s on frames: the frontend's ``d/T`` output
    columns a rank, joined by one all-gather; every call's argmax tokens
    equal one process's and the reference's, its logits within 1e-5
    relative of one process's; ``tp_counts`` names the frontend split and
    the head split where 2 divides V."""
    cfg, _ = _cfgs(name)
    one, ref = runs["one"][name], runs["ref"][name]
    assert len(one) == (5 if cfg.causal else 1) == len(ref)
    for r, out in sorted(runs["two"].items()):
        got = out["serve_tp_frontend"][name]
        assert len(got["logits"]) == len(one)
        for g, o, j in zip(got["logits"], one, ref):
            assert g.shape == o.shape == j.shape
            np.testing.assert_array_equal(g.argmax(-1), o.argmax(-1))
            np.testing.assert_array_equal(g.argmax(-1), j.argmax(-1))
            assert _rel_gap(g, o) <= REL, (r, _rel_gap(g, o))
        head = "tp_split" if cfg.vocab_size % 2 == 0 else "tp_whole"
        assert got["tp_counts"]["tp_split"]["frontend"] == len(one), got["tp_counts"]
        assert got["tp_counts"][head]["head"] == len(one), got["tp_counts"]
        assert "frontend" not in got["tp_counts"]["tp_whole"], got["tp_counts"]


@pytest.mark.slow
def test_cli_serves_tensor_parallel_on_two_ranks(runs):
    """``launch.serve --tp 2 --backend gloo`` on 2 ranks: both ranks'
    tokens equal the one-process CLI's; each rank's pool holds one of the
    2 KV heads; rank 0 alone prints."""
    got = runs["two"]
    want = got[0]["serve_tp_cli"]["one"]
    assert got[0]["serve_tp_cli"]["tokens"] == got[1]["serve_tp_cli"]["tokens"] == want
    assert got[0]["serve_tp_cli"]["kv_heads"] == got[1]["serve_tp_cli"]["kv_heads"] == 1
    assert "served 6 requests" in got[0]["serve_tp_cli"]["out"]
    assert got[1]["serve_tp_cli"]["out"] == ""


@pytest.mark.slow
def test_moe_ep_refused_on_a_tp_rung(runs):
    """``moe_impl="ep"`` while serving on a tp rung is refused, naming
    ROADMAP.md Queue A 5."""
    for spawn in ("two", "four"):
        for r, out in runs[spawn].items():
            assert "Queue A 5" in out["serve_tp"]["ep_refused"], (spawn, r)
