"""repro_torch.obs: the one telemetry path every subsystem emits into (a copy
of the reference package's ``repro.obs``; the run-log schema is identical).

Three surfaces, one discipline:

  * :mod:`repro_torch.obs.trace` — thread-safe span tracer with Chrome/Perfetto
    trace-event export (host spans; optional torch profiler bridge).
  * :mod:`repro_torch.obs.metrics` — process-wide registry of counters / gauges /
    histograms; ``EngineStats`` / ``ServeStats`` are emitting views over it.
  * :mod:`repro_torch.obs.runlog` — schema-versioned JSONL run log of typed
    events (epoch boundaries, adapt decisions, compiles, reshards,
    checkpoints, restarts) under ``runs/<name>/``.

Everything defaults to the disabled null objects (``trace.NULL``,
``runlog.NULL``) — a strict no-op — so instrumented hot paths cost one
attribute load and a branch when telemetry is off.
"""

import os

from repro_torch.obs import metrics, runlog, trace
from repro_torch.obs.metrics import REGISTRY, Counter, Gauge, Histogram, Registry, StatsView
from repro_torch.obs.runlog import NullRunLog, RunLog, read_runlog
from repro_torch.obs.trace import NullTracer, Tracer

def from_cli(trace_dir: str | None, runlog_path: str | None, *,
             meta: dict | None = None):
    """Build ``(tracer, runlog)`` from the launch CLIs' ``--trace DIR`` /
    ``--runlog [PATH]`` flag values.

    ``trace_dir`` enables tracing (the dir is created so a later
    ``tracer.save(trace_dir)`` lands at ``DIR/trace.json``); ``runlog_path``
    enables the run log — the empty string (bare ``--runlog``) means
    ``<trace_dir>/runlog.jsonl``.  Disabled sinks come back as ``None`` so
    callers can skip save/close; pass them straight to Trainer/ServeEngine,
    whose ``None`` default is the null sink."""
    tracer = None
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        tracer = Tracer()
    rl = None
    if runlog_path is not None:
        path = runlog_path or trace_dir
        if not path:
            raise ValueError("--runlog without a path requires --trace DIR")
        rl = RunLog(path, meta=meta)
    return tracer, rl


__all__ = [
    "from_cli",
    "trace",
    "metrics",
    "runlog",
    "Tracer",
    "NullTracer",
    "Registry",
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "StatsView",
    "RunLog",
    "NullRunLog",
    "read_runlog",
]
