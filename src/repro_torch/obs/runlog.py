"""Schema-versioned JSONL run log: the durable record of one run.

A :class:`RunLog` is an append-only JSONL file (conventionally
``runs/<name>/runlog.jsonl``) of *typed events*: every record carries the
schema version ``v``, a ``kind`` from :data:`EVENTS`, a wall-clock ``t``,
and the kind's required fields (validated at emit time, so a malformed
event fails at the write site, not in the reader).  The log captures what
the in-memory stats cannot — the *sequence* of runtime decisions:

  * per-boundary scalars — loss, diversity, GNS, batch size, lr, rung,
    throughput (``epoch`` / ``decision`` events);
  * every adapt ``Applied`` decision, reshard, compile, checkpoint,
    injected event, and supervisor restart, each as its own kind — a
    cross-rung failure/restart is reconstructable from this one file.

``launch/monitor.py`` is the reader: it tails a run log, prints per-epoch /
per-window summary tables, and rebuilds the full batch-size/rung/lr
schedule from the decision stream.  :data:`NULL` is the disabled sink
(``emit`` is a no-op); hot paths guard on ``runlog.enabled`` exactly like
the tracer.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

from repro_torch.obs.trace import jsonable

#: run-log record layout version (pinned by tests/test_obs.py; the reader
#: rejects records from a NEWER schema instead of misparsing them)
SCHEMA_VERSION = 1

#: typed event kinds -> required fields (extra fields always allowed)
EVENTS = {
    # run lifecycle
    "run_start": ("run",),
    "restart": ("restarts", "epoch"),
    "checkpoint": ("epoch", "step"),
    "inject": ("name",),
    # training boundaries
    "epoch": ("epoch", "steps", "batch_size", "lr", "loss"),
    "decision": ("epoch", "step", "boundary", "batch_size", "lr"),
    # engine events (scope: "train" | "serve")
    "compile": ("scope", "what", "seconds"),
    "reshard": ("scope", "src", "dst"),
    # pod supervision (repro.pod): a host loss degrades the ladder in place
    "pod_lost": ("pod", "epoch"),
    "demote": ("src", "dst", "pods"),
    # serving
    "serve_admit": ("rid", "prompt_len", "budget"),
    "serve_retire": ("rid", "pos"),
    "serve_window": ("step", "tokens", "tokens_per_sec", "live"),
    # a ServePolicy decision the engine actually applied (serve/policy.py):
    # reordered admission, a slot-budget cap, or a shrink-patience change
    "serve_policy": ("step", "reason"),
}


def _clean(v):
    """JSON-safe scalar: non-finite floats become null (json.dumps would
    otherwise emit bare NaN, which strict readers reject)."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class NullRunLog:
    """Disabled run log: ``emit`` is a strict no-op."""

    __slots__ = ()
    enabled = False

    def emit(self, kind: str, /, **fields) -> None:
        return None

    def close(self) -> None:
        return None


#: the process-wide disabled run log — the default everywhere
NULL = NullRunLog()


class RunLog:
    """Append-only JSONL event writer (line-buffered, thread-safe)."""

    enabled = True

    def __init__(self, path: str, *, meta: dict | None = None):
        if os.path.isdir(path) or path.endswith(os.sep):
            path = os.path.join(path, "runlog.jsonl")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self._f = open(path, "w", buffering=1)
        self._lock = threading.Lock()
        self.emit("run_start", run=dict(meta or {}))

    def emit(self, kind: str, /, **fields) -> None:
        """Write one typed event (validates kind + required fields).  The
        event kind is positional-only so fields named ``kind`` etc. stay
        usable — but the record envelope keys themselves are reserved."""
        spec = EVENTS.get(kind)
        if spec is None:
            raise ValueError(
                f"unknown run-log event kind {kind!r}; known: {sorted(EVENTS)}"
            )
        missing = [f for f in spec if f not in fields]
        if missing:
            raise ValueError(f"event {kind!r} missing required fields {missing}")
        clash = {"v", "kind", "t"} & fields.keys()
        if clash:
            raise ValueError(f"field names {sorted(clash)} are reserved "
                             f"(record envelope keys)")
        rec = {"v": SCHEMA_VERSION, "kind": kind, "t": time.time()}
        rec.update((k, _clean(v)) for k, v in fields.items())
        line = json.dumps(rec, default=jsonable)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_runlog(path: str) -> list[dict]:
    """Parse a run log back into its event records.

    Accepts a ``runs/<name>`` directory or the JSONL path itself.  Raises on
    records written by a NEWER schema version; blank lines are skipped (a
    torn final line from a crashed writer raises — the log is evidence)."""
    if os.path.isdir(path):
        path = os.path.join(path, "runlog.jsonl")
    events: list[dict] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            v = int(rec.get("v", 0))
            if v > SCHEMA_VERSION:
                raise ValueError(
                    f"{path}:{i + 1}: run-log schema v{v} is newer than this "
                    f"reader (v{SCHEMA_VERSION})"
                )
            events.append(rec)
    return events
