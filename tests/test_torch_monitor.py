"""The port's run-log monitor and engine telemetry against the reference's.

``repro_torch.launch.monitor`` is a copy of ``repro/launch/monitor.py`` over
``repro_torch.obs``; it must import with ``jax`` blocked and print what the
reference's reader prints for the same log: one port training run (a
tick-fired DiveBatch program, so the log holds decisions, compiles, epochs
and checkpoints), read by both readers.  The engine's telemetry: a new step
key emits one ``compile`` event and span, each step one ``dispatch`` span,
with the reference's fields; the null sinks emit nothing.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro.launch import monitor as jmonitor
from repro_torch import data as tdata
from repro_torch.adapt import AdaptationProgram, DiveBatchPolicy
from repro_torch.ckpt import CheckpointManager
from repro_torch.models import small
from repro_torch.obs import RunLog, Tracer, read_runlog
from repro_torch.optim import sgd
from repro_torch.train import StepEngine
from repro_torch.train.loop import ModelFns, Trainer

torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"


def _run(tmp_path) -> str:
    """A port training run with a tracer and a run log; returns its dir."""
    run = tmp_path / "run"
    run.mkdir()
    train, val, _ = tdata.sigmoid_synthetic(n=1200, d=16, seed=1)
    kw = dict(m0=32, m_max=256, delta=0.5, dataset_size=len(train), granule=16,
              on_tick=True)
    tracer, runlog = Tracer(), RunLog(str(run), meta={"cmd": "train"})
    t = Trainer(ModelFns(batch_loss=small.mlp_batch_loss, example_loss=small.mlp_loss,
                         metrics=lambda p, b: {"acc": small.mlp_accuracy(p, b)}),
                small.mlp_init(torch.Generator().manual_seed(1), 16, device="cpu"),
                sgd(momentum=0.9),
                AdaptationProgram(DiveBatchPolicy(**kw), 0.3, estimator="moment",
                                  tick_every=8),
                train, val, estimator="moment", seed=1,
                ckpt=CheckpointManager(str(tmp_path / "ck")), ckpt_every=1,
                tracer=tracer, runlog=runlog)
    t.run(3, verbose=False)
    runlog.close()
    tracer.save(str(run))
    return str(run)


def test_monitor_reads_a_port_log_as_the_reference_does(tmp_path):
    run = _run(tmp_path)
    events = jmonitor.load(run)
    kinds = {e.get("kind") for e in events}
    assert {"compile", "epoch", "checkpoint", "decision"} <= kinds
    want = {"summary": jmonitor.summary(events), "epoch_table": jmonitor.epoch_table(events),
            "schedule": jmonitor.schedule(events),
            "merged": len(json.load(open(jmonitor.merge_traces(
                run, str(tmp_path / "ref.json"))))["traceEvents"])}
    code = (
        "import json, sys\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch.launch import monitor as m\n"
        f"ev = m.load({run!r})\n"
        f"merged = json.load(open(m.merge_traces({run!r}, {str(tmp_path / 'port.json')!r})))\n"
        "print(json.dumps({'summary': m.summary(ev), 'epoch_table': m.epoch_table(ev),"
        " 'schedule': m.schedule(ev), 'merged': len(merged['traceEvents'])}))\n"
        "bad = [k for k, mod in sys.modules.items() if mod is not None and"
        " (k == 'repro' or k.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == json.loads(json.dumps(want))
    assert len(got["schedule"]) == len([e for e in events if e.get("kind") == "decision"]) > 0
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.monitor", run],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert cli.returncode == 0 and cli.stdout.strip() == want["summary"].strip()


def test_engine_emits_compile_and_dispatch_telemetry(tmp_path):
    tracer, runlog = Tracer(), RunLog(str(tmp_path / "log"))
    fns = ModelFns(batch_loss=small.mlp_batch_loss)
    eng = StepEngine.for_model_fns(fns, sgd(), estimator="moment", diversity_on=False)
    eng.tracer, eng.runlog = tracer, runlog
    from repro_torch.train import init_state

    state = init_state(small.mlp_init(torch.Generator().manual_seed(0), 8, device="cpu"),
                       sgd())
    rng = np.random.default_rng(0)
    for b in (16, 16, 32, 16):
        batch = {"x": torch.from_numpy(rng.standard_normal((b, 8)).astype(np.float32)),
                 "y": torch.from_numpy(rng.integers(0, 2, b).astype(np.int32))}
        state, _ = eng.step(state, batch, 0.1)
    runlog.close()
    compiles = [e for e in read_runlog(str(tmp_path / "log")) if e["kind"] == "compile"]
    assert [e["bucket"] for e in compiles] == [16, 32] == eng.stats.buckets
    assert all(set(e) >= {"scope", "what", "seconds", "bucket", "rung", "tier"}
               and e["seconds"] >= 0 for e in compiles)
    spans = [e for e in tracer.to_json()["traceEvents"] if e.get("ph") == "X"]
    assert [e["name"] for e in spans].count("compile") == 2
    dispatch = [e for e in spans if e["name"] == "dispatch"]
    assert [e["args"]["step_num"] for e in dispatch] == [0, 1, 2, 3]
    # the null sinks: nothing recorded anywhere, and the step runs the same
    quiet = StepEngine.for_model_fns(fns, sgd(), estimator="moment", diversity_on=False)
    assert not quiet.tracer.enabled and not quiet.runlog.enabled
