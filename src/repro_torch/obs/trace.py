"""Span tracer: the one timeline every subsystem emits into.

``Tracer.span("compile", bucket=4, rung=1)`` is a context manager recording
one Chrome/Perfetto *complete* event (``ph="X"``) per exit — host wall-time
spans for the decisions the stack makes at runtime (compiles, dispatches,
reshards, prefill chunks, decode steps, adaptation boundaries).  The export
(:meth:`Tracer.save`) is the trace-event JSON Perfetto / ``chrome://tracing``
load directly: ``{"traceEvents": [...], "displayTimeUnit": "ms"}``.

Design constraints, in order:

  * **A disabled tracer is a strict no-op.**  ``NULL`` (the module-level
    :class:`NullTracer`) returns one shared, stateless span object and never
    touches its arguments — no allocation, no clock read, no host transfer.
    Hot loops additionally guard on ``tracer.enabled`` so the disabled path
    costs one attribute load and a branch per step (the overhead guard in
    ``tests/test_obs.py`` pins both properties).
  * **Thread-safe.**  Spans carry ``threading.get_ident()`` as their ``tid``
    and the event list is appended under a lock — the prefetch producer
    thread and the main loop interleave on one timeline.
  * **Device alignment (optional).**  ``Tracer(torch_annotate=True)``
    bridges every span into ``torch.profiler.record_function`` (a span
    carrying a ``step_num`` arg is labelled ``name#step``), so a device
    profile collected with ``torch.profiler.profile`` lines up step-for-step
    with the host spans.  The import is lazy: this module stays torch-free
    so host-only code (``serve/blocks.py``) can emit into it.

``SCHEMA_VERSION`` is pinned by the trace schema test; it rides in the
export's ``otherData`` next to ``wall_origin`` (the wall-clock time of the
tracer's ts=0), which lets ``launch/monitor.py`` merge run-log events onto
the same timeline.
"""

from __future__ import annotations

import json
import os
import threading
import time

#: version of the exported trace layout (pinned in tests/test_obs.py)
SCHEMA_VERSION = 1


def jsonable(o):
    """JSON default= hook: numpy scalars -> python, everything else -> str."""
    item = getattr(o, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(o)


class _NullSpan:
    """The shared do-nothing span (one instance per process)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call is a strict no-op (see module docstring)."""

    __slots__ = ()
    enabled = False

    def span(self, name, **args):
        return _NULL_SPAN

    def instant(self, name, **args):
        return None

    def to_json(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"schema": SCHEMA_VERSION}}

    def save(self, path) -> None:
        return None


#: the process-wide disabled tracer — the default everywhere
NULL = NullTracer()


class _Span:
    """One live span: records a ``ph="X"`` complete event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._ann = None

    def __enter__(self):
        tr = self._tracer
        if tr._annotate:
            from torch.profiler import record_function  # lazy: torch-free module

            step = self._args.get("step_num")
            label = self._name if step is None else f"{self._name}#{int(step)}"
            self._ann = record_function(label)
            self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._complete(self._name, self._args, self._t0, t1)
        return False


class Tracer:
    """In-memory span/instant recorder with Chrome trace-event export."""

    enabled = True

    def __init__(self, *, torch_annotate: bool = False):
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._origin_ns = time.perf_counter_ns()
        #: wall-clock time of ts=0 (lets the monitor align run-log events)
        self.wall_origin = time.time()
        self._pid = os.getpid()
        self._annotate = bool(torch_annotate)
        self._named_threads: set[int] = set()

    # -- recording -----------------------------------------------------------
    def _ts(self, t_ns: int) -> float:
        """Microseconds since tracer start (the trace-event time unit)."""
        return (t_ns - self._origin_ns) / 1_000.0

    def _name_thread(self, tid: int) -> None:
        if tid in self._named_threads:
            return
        self._named_threads.add(tid)
        self._events.append({
            "ph": "M", "name": "thread_name", "ts": 0.0,
            "pid": self._pid, "tid": tid,
            "args": {"name": threading.current_thread().name},
        })

    def _complete(self, name: str, args: dict, t0: int, t1: int) -> None:
        tid = threading.get_ident()
        ev = {
            "ph": "X", "name": name, "ts": self._ts(t0),
            "dur": max((t1 - t0) / 1_000.0, 0.001),
            "pid": self._pid, "tid": tid, "args": args,
        }
        with self._lock:
            self._name_thread(tid)
            self._events.append(ev)

    def span(self, name: str, **args) -> _Span:
        """Context manager recording one complete event when it exits."""
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Point-in-time event (``ph="i"``, thread-scoped)."""
        tid = threading.get_ident()
        ev = {
            "ph": "i", "name": name, "ts": self._ts(time.perf_counter_ns()),
            "s": "t", "pid": self._pid, "tid": tid, "args": args,
        }
        with self._lock:
            self._name_thread(tid)
            self._events.append(ev)

    # -- export --------------------------------------------------------------
    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_json(self) -> dict:
        return {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": {
                "schema": SCHEMA_VERSION,
                "wall_origin": self.wall_origin,
                "pid": self._pid,
            },
        }

    def save(self, path: str) -> str:
        """Write the Perfetto-loadable ``trace.json``; returns the path.

        If ``path`` is a directory the file is ``<path>/trace.json``."""
        if os.path.isdir(path) or path.endswith(os.sep):
            path = os.path.join(path, "trace.json")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, default=jsonable)
        return path
