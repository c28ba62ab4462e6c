"""Elastic serving in the port against ``repro.serve`` on the CPU.

  * every local rung of ``MeshLadder(["cpu"] * 8, granule=1)`` under
    ``use_plan``: greedy tokens equal the reference oracle's (a whole
    re-prefill per token, no engine) and the reference engine's kernel lane
    (``attn_impl="pallas"``, interpret mode);
  * the reference's live-transition script on ``elastic=MeshLadder``:
    tokens, ``stats.rungs``/``buckets``/``reshards``/``compiles``/
    ``bucket_hits`` and the run log's ``reshard`` events equal the
    reference engine's on its 8 forced host devices;
  * ``elastic=`` under an ambient plan raises, as the reference does;
  * on 2 gloo ranks (``tests/_scaleout_ranks.py::serve_ranks``): reduced
    Yi-6B on a rank ladder (tokens equal one process's and the reference's,
    ``stats.rungs`` equal a 2-entry local ladder's, each rank holding its
    layout's parameter elements, pools equal across ranks), reduced
    gemma2-27b and falcon-mamba-7b (rows that move across a resize and a
    rung change), a fixed rank plan, the serving entry points on a sharded
    module within 1e-6 of the whole one's, and the serving CLI;
  * the serving CLI's ``--elastic`` on the CPU against the reference CLI.

Weights come from the JAX init through ``interop.params_from_jax``.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _scaleout_ranks as ranks
from repro.configs import get_config as jget
from repro.configs.base import ModelConfig as JModelConfig
from repro.elastic import MeshLadder as JMeshLadder
from repro.launch import serve as jlaunch_serve
from repro.models import transformer as jtf
from repro.obs import RunLog as JRunLog
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import padded_prompt_len
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import use_plan
from repro_torch.elastic import MeshLadder
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.obs import RunLog
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(2)

MAX_SEQ = 64
GRANULE = 8
# the reference test's tiny config and its golden trace
KW = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4,
          num_kv_heads=2, d_ff=64, vocab_size=61, pattern=("attn",),
          param_dtype="float32", compute_dtype="float32", xent_chunk=8, remat=False)
JCFG, CFG = JModelConfig(**KW), ModelConfig(**KW)
JPARAMS = jtf.init_params(JCFG, jax.random.key(0))
NP_PARAMS = jax.tree.map(np.asarray, JPARAMS)
LENS = [5, 3, 8, 2, 6, 4, 7, 5]
MAX_NEW = [24, 12, 12, 6, 6, 6, 6, 6]


def _prompts(vocab=61, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in LENS]


def _params(cfg=CFG, tree=None):
    return params_from_jax(NP_PARAMS if tree is None else tree, cfg)


def _oracle(prompt, max_new):
    """The reference's single-request oracle: greedy by re-prefilling the
    whole padded prompt and the tokens so far, no engine."""
    plen = padded_prompt_len(len(prompt), GRANULE)
    seq = list(np.concatenate([np.zeros(plen - len(prompt), np.int32), prompt]))
    budget = min(max_new, MAX_SEQ - plen + 1)
    pref = jax.jit(lambda p, b: jtf.prefill_step(JCFG, p, b)[0])
    out = []
    while len(out) < budget:
        logits = pref(JPARAMS, {"tokens": jnp.asarray(np.asarray(seq)[None])})
        out.append(int(jnp.argmax(logits[0, -1])))
        seq.append(out[-1])
    return out


@pytest.fixture(scope="module")
def golden():
    prompts = _prompts()
    expected = [_oracle(p, m) for p, m in zip(prompts, MAX_NEW)]
    kernel_lane = JServeEngine(JCFG, JPARAMS, max_slots=4, max_seq=MAX_SEQ,
                               prompt_granule=GRANULE, attn_impl="pallas").generate(
        [JRequest(prompt=p, max_new_tokens=m) for p, m in zip(prompts, MAX_NEW)])
    return prompts, expected, [r.tokens.tolist() for r in kernel_lane]


def _reqs(prompts, cls=Request):
    return [cls(prompt=p, max_new_tokens=m) for p, m in zip(prompts, MAX_NEW)]


@pytest.mark.parametrize("lane", ["oracle", "kernel lane"])
def test_every_rung_matches_oracle(golden, lane):
    """Each local rung of the port's ladder under ``use_plan``: the tokens
    of the reference's oracle (its dense XLA lane) and of its engine on the
    kernel lane, exactly."""
    prompts, expected, kernel_lane = golden
    want = expected if lane == "oracle" else kernel_lane
    ladder = MeshLadder(["cpu"] * 8, granule=1)
    assert ladder.widths == [1, 2, 4, 8]
    for rung in ladder:
        with use_plan(rung.plan):
            eng = ServeEngine(CFG, _params(), max_slots=4, max_seq=MAX_SEQ,
                              prompt_granule=GRANULE)
            got = [r.tokens.tolist() for r in eng.generate(_reqs(prompts))]
        assert got == want, f"rung dp{rung.dp}"
        assert eng.device.type == "cpu" and eng.stats.reshards == 0
        assert set(eng.stats.rungs) == {None}


def _events(path, kind):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [(e["src"], e["dst"], e["dp"], e["step"]) for e in rows if e["kind"] == kind]


def test_elastic_live_rung_transitions_match_reference(golden, tmp_path):
    """The reference's ramping script drives live rung transitions on both
    engines: tokens, the (bucket, rung) accounting and the run log's
    ``reshard`` events equal the reference engine's."""
    prompts, expected, _ = golden
    jlog = JRunLog(str(tmp_path / "ref"))
    jeng = JServeEngine(JCFG, JPARAMS, max_slots=8, max_seq=MAX_SEQ, prompt_granule=GRANULE,
                        elastic=JMeshLadder(granule=1), runlog=jlog)
    jtoks, _ = ranks.serve_ramp(jeng, _reqs(prompts, JRequest))
    jlog.close()
    log = RunLog(str(tmp_path / "port"))
    ladder = MeshLadder(["cpu"] * 8, granule=1)
    eng = ServeEngine(CFG, _params(), max_slots=8, max_seq=MAX_SEQ, prompt_granule=GRANULE,
                      elastic=ladder, runlog=log)
    toks, seen = ranks.serve_ramp(eng, _reqs(prompts))
    log.close()
    assert toks == jtoks == expected
    st, js = eng.stats, jeng.stats
    for key in ("rungs", "buckets", "reshards", "compiles", "bucket_hits", "resizes"):
        assert getattr(st, key) == getattr(js, key), key
    assert st.reshards >= 2 and len(seen) >= 2 and len(set(st.rungs)) >= 2
    assert st.compiles == len(set(zip(st.buckets, st.rungs)))
    for b, r in zip(st.buckets, st.rungs):
        assert r == ladder.rung_for_batch(b).index
    events = _events(log.path, "reshard")
    assert events and events == _events(jlog.path, "reshard")


def test_elastic_under_ambient_plan_raises():
    ladder = MeshLadder(["cpu"] * 8, granule=1)
    with use_plan(ladder.full.plan):
        with pytest.raises(ValueError, match="ambig"):
            ServeEngine(CFG, _params(), elastic=MeshLadder(["cpu"] * 8, granule=1))
    with pytest.raises(ValueError, match="mesh runs this process"):
        ServeEngine(CFG, _params(), device="cuda", elastic=ladder)


def test_cli_elastic_matches_reference(tmp_path, monkeypatch, capsys):
    """``launch.serve --device cpu --elastic``: the reference CLI's tokens and
    reshard count on the same flags (weights carried from its init)."""
    flags = ["--elastic", "--requests", "8", "--ramp", "2", "--max-new", "8",
             "--prefill-chunk", "8", "--block-size", "8"]
    monkeypatch.setattr(sys, "argv", ["serve", *flags, "--out", str(tmp_path / "j.json")])
    jlaunch_serve.main()
    want = json.loads((tmp_path / "j.json").read_text())
    cfg = get_config("yi-6b", reduced=True).replace(num_layers=4, d_model=128, num_heads=4,
                                                   num_kv_heads=2)
    jparams = jtf.init_params(jget("yi-6b", reduced=True).replace(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2), jax.random.key(0))
    monkeypatch.setattr(launch_serve, "init_model",
                        lambda cfg_, seed, device: params_from_jax(
                            jax.tree.map(np.asarray, jparams), cfg))
    capsys.readouterr()
    launch_serve.main(["--device", "cpu", *flags, "--out", str(tmp_path / "p.json")])
    out = capsys.readouterr().out
    got = json.loads((tmp_path / "p.json").read_text())
    assert [r["tokens"] for r in got["results"]] == [r["tokens"] for r in want["results"]]
    for key in ("reshards", "rungs", "buckets", "compiles"):
        assert got["stats"][key] == want["stats"][key], key
    assert got["stats"]["reshards"] >= 1
    assert f"elastic: ladder dp=[1, 2, 4, 8] reshards={got['stats']['reshards']}" in out


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

RANK_ARCHS = {"yi-6b": 1, "gemma2-27b": 5, "falcon-mamba-7b": 9}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _one_process(arch, tree, prompts, elastic):
    cfg = get_config(arch, reduced=True)
    kw = dict(max_slots=8, max_seq=MAX_SEQ, prompt_granule=GRANULE, block_size=8,
              prefill_chunk=8)
    if elastic:
        eng = ServeEngine(cfg, params_from_jax(tree, cfg), elastic=MeshLadder(
            ["cpu"] * 2, granule=1), **kw)
        toks, _ = ranks.serve_ramp(eng, _reqs(prompts))
        return toks, eng.stats
    eng = ServeEngine(cfg, params_from_jax(tree, cfg), device="cpu", **kw)
    return [r.tokens.tolist() for r in eng.generate(_reqs(prompts))], eng.stats


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """One spawn of 2 gloo ranks running every rank case
    (``_scaleout_ranks.serve_ranks`` and ``serve_cli``), and the
    one-process runs and the reference's tokens they are held against."""
    trees = {a: _np_tree(jtf.init_params(jget(a, reduced=True), jax.random.key(k)))
             for a, k in RANK_ARCHS.items()}
    prompts = _prompts(vocab=get_config("yi-6b", reduced=True).vocab_size, seed=3)
    # the second request repeats the first's prompt: a full-prompt hit
    prompts[4] = prompts[0].copy()
    tmp = tmp_path_factory.mktemp("serve_ranks")
    got = ranks.spawn_ranks(tmp, "serve_ranks+serve_cli",
                            {"trees": trees, "prompts": prompts, "max_seq": MAX_SEQ,
                             "granule": GRANULE, "max_new": MAX_NEW,
                             "out": str(tmp / "cli.json")}, 2)
    jcfg = jget("yi-6b", reduced=True)
    jeng = JServeEngine(jcfg, jtf.init_params(jcfg, jax.random.key(RANK_ARCHS["yi-6b"])),
                        max_slots=8, max_seq=MAX_SEQ, prompt_granule=GRANULE, block_size=8,
                        prefill_chunk=8)
    ref = [r.tokens.tolist() for r in jeng.generate(_reqs(prompts, JRequest))]
    one = {a: _one_process(a, trees[a], prompts, elastic=False) for a in RANK_ARCHS}
    local = _one_process("yi-6b", trees["yi-6b"], prompts, elastic=True)
    return {"got": got, "ref": ref, "one": one, "local": local, "tmp": tmp}


@pytest.mark.slow
def test_rank_ladder_serves_yi_as_one_process(rank_runs):
    """Reduced Yi-6B on ``MeshLadder(rank_devices("cpu"), granule=1)``: every
    rank's tokens equal one process's and the reference engine's; the rungs
    equal a 2-entry local ladder's; each rank holds its layout's
    parameter elements on the 2-rank rung; the pools are equal across ranks
    after the last step both spend on the 2-rank rung (the sentinel block
    aside).  ``moe_impl="ep"`` on the ranks is refused, naming Queue A 5."""
    got = rank_runs["got"]
    one_toks, _ = rank_runs["one"]["yi-6b"]
    local_toks, local_stats = rank_runs["local"]
    assert one_toks == rank_runs["ref"] == local_toks
    for r in (0, 1):
        y = got[r]["serve_ranks"]["yi-6b"]
        assert y["tokens"] == one_toks, f"rank {r}"
        assert y["rungs"] == local_stats.rungs and y["buckets"] == local_stats.buckets
        assert y["reshards"] == local_stats.reshards >= 2
        assert y["held"] == y["reckoned"] < y["whole"]
    assert got[0]["serve_ranks"]["yi-6b"]["pool"] == got[1]["serve_ranks"]["yi-6b"]["pool"]
    assert all("Queue A 5" in got[r]["serve_ranks"]["ep_refused"] for r in (0, 1))


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["gemma2-27b", "falcon-mamba-7b"])
def test_rank_ladder_moves_rows(rank_runs, arch):
    """Rings (gemma2: full-prompt hits only) and Mamba state (falcon-mamba)
    live in the slot cache's rows, which move whole across the resizes and
    rung changes of the ramp: every rank's tokens equal one process's."""
    one_toks, _ = rank_runs["one"][arch]
    for r in (0, 1):
        rec = rank_runs["got"][r]["serve_ranks"][arch]
        assert rec["tokens"] == one_toks, f"rank {r}"
        assert rec["reshards"] >= 2 and rec["resizes"] >= 2


@pytest.mark.slow
def test_fixed_rank_plan_serves_as_one_process(rank_runs):
    """``use_plan`` of the 2-rank rung (buckets of 1 decode on both ranks,
    wider buckets split their rows): tokens equal one process's."""
    one_toks, _ = rank_runs["one"]["yi-6b"]
    for r in (0, 1):
        rec = rank_runs["got"][r]["serve_ranks"]["fixed"]
        assert rec["tokens"] == one_toks and rec["reshards"] == 0
        assert set(rec["rungs"]) == {None} and 1 in rec["buckets"]


@pytest.mark.slow
@pytest.mark.parametrize("entry", ["decode_step", "prefill_chunk", "prefill_step"])
def test_serving_entry_points_on_a_sharded_module(rank_runs, entry):
    """``decode_step``, ``prefill_chunk`` and ``prefill_step`` on a module
    sharded over the 2-rank rung (each block gathered on entry) within 1e-6
    of the same calls on the whole module, float32."""
    for r in (0, 1):
        gaps = rank_runs["got"][r]["serve_ranks"]["entries"]
        assert gaps["sharded"] and gaps[entry] <= 1e-6, (r, gaps)


@pytest.mark.slow
def test_cli_on_two_ranks(rank_runs):
    """``launch.serve --elastic --backend gloo`` on 2 ranks: rank 0 prints
    the ladder and writes the one-process CLI's tokens."""
    got = rank_runs["got"]
    want = got[0]["serve_cli"]["one"]
    assert got[0]["serve_cli"]["tokens"] == got[1]["serve_cli"]["tokens"] == want
    assert "elastic: ladder dp=[1, 2]" in got[0]["serve_cli"]["out"]
    assert got[1]["serve_cli"]["out"] == ""
