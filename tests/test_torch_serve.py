"""The port's serving stack against ``repro.serve``, on the CPU.

  * ``ServeEngine(device="cpu")`` against the reference engine on its Pallas
    lane (``attn_impl="pallas"``, interpret mode) with the reference's own
    weights (``interop.params_from_jax``): a chunked (prefill_chunk 8,
    block 8), prefix-shared trace gives identical greedy tokens and equal
    pool / prefill / slot statistics;
  * the copied host objects (``BlockPool``, ``Scheduler``, policies) driven
    through identical random operation sequences end in equal state;
  * the package stands alone: every module imports with ``jax`` blocked,
    and no source line imports ``jax`` or ``repro``;
  * the entry points default to the card and raise without one;
  * the categorical sampler is per-request deterministic inside torch.
"""

import ast
import dataclasses
import importlib
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as jget
from repro.launch import monitor
from repro.models import transformer as jtf
from repro.serve import BlockPool as JBlockPool
from repro.serve import FairSharePolicy as JFair
from repro.serve import QueuedRequest as JQueued
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JServeEngine
from repro.serve import ServeSignals as JSignals
from repro.adapt.signals import Clock as JClock
from repro_torch.adapt.signals import Clock
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.obs import RunLog, Tracer
from repro_torch.serve import (
    BlockPool,
    FairSharePolicy,
    QueuedRequest,
    Request,
    Scheduler,
    ServeEngine,
    ServeSignals,
    ServeStats,
)

torch.set_num_threads(2)

JCFG = jget("yi-6b", reduced=True)
CFG = get_config("yi-6b", reduced=True)
JPARAMS = jtf.init_params(JCFG, jax.random.key(1))
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), CFG)
SRC = Path(repro_torch.__file__).resolve().parent


def _trace(seed=5):
    """Requests that exercise chunking and both kinds of prefix sharing:
    two prompts sharing a padded prefix (partial match), a repeat of a whole
    prompt (full-prompt hit), and prompts of assorted lengths."""
    r = np.random.default_rng(seed)
    shared = r.integers(1, CFG.vocab_size, size=20)
    first = np.concatenate([shared, r.integers(1, CFG.vocab_size, size=10)])
    second = np.concatenate([shared, r.integers(1, CFG.vocab_size, size=10)])
    prompts = [first, r.integers(1, CFG.vocab_size, size=7), second,
               r.integers(1, CFG.vocab_size, size=45), first.copy()]
    return [(p.astype(np.int32), n) for p, n in zip(prompts, (9, 5, 12, 6, 8))]


def test_engine_matches_reference_engine():
    kw = dict(max_slots=2, max_seq=64, prefill_chunk=8, block_size=8,
              prompt_granule=8)
    reqs = _trace()
    jeng = JServeEngine(JCFG, JPARAMS, attn_impl="pallas", **kw)
    jout = jeng.generate([JRequest(prompt=p, max_new_tokens=n) for p, n in reqs])
    teng = ServeEngine(CFG, PARAMS, device="cpu", **kw)
    tout = teng.generate([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    assert [o.tokens.tolist() for o in tout] == [o.tokens.tolist() for o in jout]
    js, ts = jeng.stats.as_dict(), teng.stats.as_dict()
    assert set(ts) == set(js)
    for key in ("prefills", "prefill_chunks", "shared_prefill_hits", "shared_blocks",
                "peak_blocks", "slot_steps", "steps", "tokens", "buckets",
                "compiles", "bucket_hits", "prefill_compiles", "resizes", "retired"):
        assert ts[key] == js[key], key
    # the trace really exercised chunking and both kinds of sharing
    assert ts["shared_prefill_hits"] >= 1 and ts["shared_blocks"] > ts["shared_prefill_hits"]
    assert ts["prefill_chunks"] > ts["prefills"] - ts["shared_prefill_hits"]
    assert ts["compiles"] == len(set(zip(ts["buckets"], ts["rungs"])))


@pytest.mark.parametrize("policy", ["priority", "fair"])
def test_engine_policies_match_reference(policy):
    """Policy-ordered admission under a tight slot budget: same tokens."""
    r = np.random.default_rng(11)
    reqs = [(r.integers(1, CFG.vocab_size, size=int(r.integers(3, 20))).astype(np.int32),
             int(r.integers(2, 6)), f"t{i % 2}", i % 3) for i in range(6)]
    kw = dict(max_slots=2, max_seq=48, policy=policy)
    jout = JServeEngine(JCFG, JPARAMS, attn_impl="pallas", **kw).generate(
        [JRequest(prompt=p, max_new_tokens=n, tenant=t, priority=q) for p, n, t, q in reqs])
    tout = ServeEngine(CFG, PARAMS, device="cpu", **kw).generate(
        [Request(prompt=p, max_new_tokens=n, tenant=t, priority=q) for p, n, t, q in reqs])
    assert [o.tokens.tolist() for o in tout] == [o.tokens.tolist() for o in jout]


def _pool_state(pool):
    return (list(pool._free), dict(pool._ref), dict(pool._by_key),
            dict(pool._key_of), list(pool._lru), pool.reserved, pool.peak_live,
            pool.cow_copies)


def _apply(obj, name, *args, **kw):
    try:
        return ("ok", getattr(obj, name)(*args, **kw))
    except Exception as e:  # the same op must fail the same way in both
        return ("raise", type(e).__name__)


@pytest.mark.parametrize("seed", range(4))
def test_block_pool_copy_matches_reference(seed):
    r = np.random.default_rng(seed)
    a, b = BlockPool(12, 4), JBlockPool(12, 4)
    keys = [(("k", i),) for i in range(6)]
    for _ in range(300):
        op = int(r.integers(0, 9))
        bid = int(r.integers(0, 12))
        key = keys[int(r.integers(0, len(keys)))]
        call = [("alloc",), ("alloc",), ("retain", bid), ("release", bid),
                ("register", key, bid), ("match", keys[:int(r.integers(0, 6))]),
                ("reserve", int(r.integers(0, 3))), ("unreserve", int(r.integers(0, 2))),
                ("cow", bid)][op]
        if op == 1:
            call, kw = ("alloc",), {"reserved": True}
        else:
            kw = {}
        assert _apply(a, *call, **kw) == _apply(b, *call, **kw), call
        assert _pool_state(a) == _pool_state(b)
        assert a.available() == b.available()
    a.check()
    b.check()


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_copy_matches_reference(seed):
    r = np.random.default_rng(seed)
    a, b = Scheduler(8, granule=1), JScheduler(8, granule=1)
    for _ in range(200):
        op = int(r.integers(0, 5))
        if op == 0:
            n = int(r.integers(1, 5))
            prompt = np.arange(n, dtype=np.int32)
            eos = int(r.integers(0, 3)) if r.random() < 0.3 else None
            got = a.submit(Request(prompt=prompt, max_new_tokens=n, eos_id=eos,
                                   submit_time=0.0))
            want = b.submit(JRequest(prompt=prompt, max_new_tokens=n, eos_id=eos,
                                     submit_time=0.0))
            assert got == want
        elif op == 1:
            target = a.target_slots()
            assert target == b.target_slots()
            if target >= a.live:
                assert a.resize(target) == b.resize(target)
        elif op == 2:
            order = [int(x) for x in r.permutation(max(a.submitted, 1))]
            veto = set(int(x) for x in r.integers(0, max(a.submitted, 1), size=2))
            gate = lambda rid, req: rid not in veto  # noqa: E731
            got = a.admit(gate=gate, order=order)
            want = b.admit(gate=gate, order=order)
            assert [(x.slot, x.rid) for x in got] == [(x.slot, x.rid) for x in want]
        else:
            for slot, _ in a.live_slots():
                tok = int(r.integers(0, 4))
                assert a.record(slot, tok) == b.record(slot, tok)
        assert a.live_slots() == b.live_slots()
        assert a.running_slots() == b.running_slots()
        np.testing.assert_array_equal(a.next_tokens(), b.next_tokens())
        np.testing.assert_array_equal(a.slot_rids(), b.slot_rids())
    assert {k: v.tokens.tolist() for k, v in a.results().items()} == \
        {k: v.tokens.tolist() for k, v in b.results().items()}


def test_fair_share_policy_copy_matches_reference():
    r = np.random.default_rng(3)
    a, b = FairSharePolicy(quantum=2), JFair(quantum=2)
    queue = []
    next_rid = 0
    for step in range(40):
        for _ in range(int(r.integers(0, 3))):
            queue.append((next_rid, f"t{int(r.integers(0, 3))}"))
            next_rid += 1
        fields = [dict(rid=rid, tenant=t, priority=0, age=0.0, prompt_len=4)
                  for rid, t in queue]
        da = a.observe(ServeSignals(queued=tuple(QueuedRequest(**f) for f in fields)),
                       Clock(0, step, "tick"))
        db = b.observe(JSignals(queued=tuple(JQueued(**f) for f in fields)),
                       JClock(0, step, "tick"))
        assert (da is None) == (db is None)
        if da is not None:
            assert dataclasses.astuple(da) == dataclasses.astuple(db)
            queue = [q for q in queue if q[0] not in set(da.order[:int(r.integers(0, 3))])]


def test_package_imports_without_jax():
    """Every repro_torch module imports with ``jax`` blocked, and none of
    them pulls in the reference package."""
    mods = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    ]
    # the training slice's and the gram tier's modules are among those walked
    assert {f"repro_torch.{m}" for m in (
        "utils.pytree", "core.diversity", "core.controller", "optim.optimizer",
        "optim.schedules", "data.synthetic", "train.state", "train.step",
        "train.engine", "adapt.policy", "adapt.combinators", "adapt.program",
        "launch.train_lm", "kernels.psgn", "kernels.ops", "models.probes",
        "kernels.quant", "models.small", "data.pipeline", "dist.plan", "dist.compression",
        "elastic.ladder", "elastic.reshard", "pod.topology", "pod.health", "pod.ladder",
        "pod.step", "train.loop", "utils.logging", "ckpt.checkpoint", "launch.monitor",
        "launch.train", "models.resnet", "interop", "configs.hubert_xlarge")} <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print(len(sys.argv), 'ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) > 20


def test_pod_slice_imports_without_jax():
    """Importing the pod slice and the Trainer alone pulls in no ``jax`` and
    nothing of ``repro``."""
    code = (
        "import sys\n"
        "import repro_torch.pod, repro_torch.train.loop\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith(('repro.', 'jax'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_import_no_jax_and_no_reference():
    files = list(SRC.rglob("*.py")) + [SRC.parents[1] / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ServeEngine(CFG, PARAMS)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_serve.main(["--requests", "1"])
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        ServeEngine(CFG, PARAMS, device="cpu", elastic=object())


def test_categorical_sampling_is_per_request():
    """A request's sampled tokens do not depend on its neighbours or on the
    slot it lands in: alone, in a batch, and behind other requests."""
    r = np.random.default_rng(2)
    reqs = [Request(prompt=r.integers(1, CFG.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=6) for n in (5, 11, 9)]
    kw = dict(device="cpu", sampler="categorical", seed=7, temperature=1.5,
              max_seq=48)
    both = ServeEngine(CFG, PARAMS, max_slots=4, **kw).generate(reqs)
    alone = ServeEngine(CFG, PARAMS, max_slots=1, **kw).generate(reqs)
    assert [x.tokens.tolist() for x in both] == [x.tokens.tolist() for x in alone]
    other = ServeEngine(CFG, PARAMS, max_slots=4, **dict(kw, seed=8)).generate(reqs)
    assert [x.tokens.tolist() for x in other] != [x.tokens.tolist() for x in both]


def test_serve_telemetry_reads_with_the_reference_monitor(tmp_path):
    """The port's tracer and run log feed the unmodified reference monitor:
    the run-log schema is identical."""
    tracer, runlog = Tracer(), RunLog(str(tmp_path), meta={"cmd": "serve"})
    eng = ServeEngine(CFG, PARAMS, device="cpu", max_slots=2, max_seq=48,
                      tracer=tracer, runlog=runlog, obs_window=2)
    eng.generate([Request(prompt=np.arange(1, 9, dtype=np.int32), max_new_tokens=6)
                  for _ in range(3)])
    tracer.save(str(tmp_path))
    runlog.close()
    events = monitor.load(str(tmp_path))
    kinds = {e["kind"] for e in events}
    assert {"serve_admit", "serve_retire", "serve_window"} <= kinds
    assert "serve windows:" in monitor.summary(events)
    names = {e["name"] for e in tracer.events if e.get("ph") == "X"}
    assert {"admit", "prefill_chunk", "decode"} <= names
    merged = json.loads(Path(monitor.merge_traces(str(tmp_path),
                                                  str(tmp_path / "m.json"))).read_text())
    assert merged["traceEvents"]


def test_torch_annotate_bridges_spans_to_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    tracer = Tracer(torch_annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("decode", step_num=3):
            torch.ones(4).sum()
    assert "decode#3" in {e.name for e in prof.events()}


def test_stats_keys_and_cli_output(tmp_path):
    out = tmp_path / "serve.json"
    launch_serve.main(["--device", "cpu", "--requests", "3", "--max-new", "4",
                       "--out", str(out)])
    got = json.loads(out.read_text())
    assert len(got["results"]) == 3
    assert set(got["stats"]) == set(ServeStats().as_dict())
    assert got["stats"]["compile_s"] == 0
