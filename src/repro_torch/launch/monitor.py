"""Run-log monitor: summary tables, schedule reconstruction, trace merge.

Counterpart of ``repro/launch/monitor.py``, a copy over ``repro_torch.obs``
(the run-log schema is the same, so it reads either package's logs, and it
imports no JAX).  The reader side of ``repro_torch.obs``: point it at a
``runs/<name>`` directory (or the ``runlog.jsonl`` itself) and it prints
what the run did — a per-epoch table for training logs, a per-window table
for serving logs, and the typed lifecycle events (compiles, reshards,
checkpoints, restarts, injected events) in between.  ``schedule()`` rebuilds the full batch-size/rung/lr
schedule from the ``decision`` event stream (which mirrors
``AdaptationProgram.history`` record-for-record); ``merge_traces()`` folds
the run-log events onto the tracer's timeline via the trace's
``wall_origin`` and emits one merged Perfetto-loadable ``trace.json``.

  python -m repro_torch.launch.monitor runs/smoke-train
  python -m repro_torch.launch.monitor runs/smoke-train --follow
  python -m repro_torch.launch.monitor runs/smoke-train --trace merged.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

from repro_torch.obs.runlog import read_runlog
from repro_torch.obs.trace import jsonable


def load(path: str) -> list[dict]:
    """All events of a run log (directory or JSONL path)."""
    return read_runlog(path)


def schedule(events: list[dict]) -> list[dict]:
    """The batch-size/rung/lr schedule, one row per adapt decision.

    Rows mirror ``AdaptationProgram.history`` (epoch/step/boundary/
    batch_size/lr come straight off each ``decision`` event); the live rung
    is tracked across ``reshard``/``restart`` events so every row also says
    where the decision executed."""
    rung = None
    out: list[dict] = []
    for ev in events:
        kind = ev.get("kind")
        if kind == "reshard" and ev.get("scope") == "train":
            rung = ev.get("dst")
        elif kind == "demote":
            rung = ev.get("dst")
        elif kind == "restart" and ev.get("rung") is not None:
            rung = ev.get("rung")
        elif kind == "decision":
            out.append({
                "t": ev.get("t"),
                "epoch": ev["epoch"],
                "step": ev["step"],
                "boundary": ev["boundary"],
                "batch_size": ev["batch_size"],
                "lr": ev["lr"],
                "rung": rung,
            })
    return out


def _fmt(v, nd: int = 4) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def _table(rows: list[dict], cols: list[str]) -> str:
    cells = [[_fmt(r.get(c)) for c in cols] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells)) if cells else len(c)
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.rjust(w) for c, w in zip(cols, widths))]
    for row in cells:
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
    return "\n".join(lines)


def epoch_table(events: list[dict]) -> str:
    rows = [e for e in events if e.get("kind") == "epoch"]
    return _table(rows, ["epoch", "steps", "batch_size", "lr", "loss",
                         "val_loss", "diversity", "gns", "rung", "wall_s"])


def serve_table(events: list[dict]) -> str:
    rows = [e for e in events if e.get("kind") == "serve_window"]
    return _table(rows, ["step", "tokens", "tokens_per_sec", "live",
                         "live_blocks", "bucket", "rung"])


def lifecycle(events: list[dict]) -> str:
    """One line per non-boundary typed event, in log order."""
    lines = []
    for ev in events:
        kind = ev.get("kind")
        if kind == "compile":
            lines.append(f"compile   [{ev.get('scope')}] {ev.get('what')} "
                         f"({_fmt(ev.get('seconds'))}s)")
        elif kind == "reshard":
            lines.append(f"reshard   [{ev.get('scope')}] rung "
                         f"{_fmt(ev.get('src'))} -> {ev.get('dst')} "
                         f"(dp {_fmt(ev.get('dp'))})")
        elif kind == "checkpoint":
            lines.append(f"checkpoint epoch={ev.get('epoch')} step={ev.get('step')}")
        elif kind == "restart":
            what = "start" if not ev.get("restarts") else f"restart #{ev['restarts']}"
            lines.append(f"restart   {what} at epoch={ev.get('epoch')} "
                         f"batch={_fmt(ev.get('batch_size'))} "
                         f"rung={_fmt(ev.get('rung'))}")
        elif kind == "inject":
            lines.append(f"inject    {ev.get('name')!r} at "
                         f"epoch={ev.get('epoch')} step={ev.get('step')}")
        elif kind == "serve_policy":
            lines.append(f"policy    {ev.get('reason')!r} at step="
                         f"{ev.get('step')} reordered={_fmt(ev.get('reordered'))} "
                         f"budget={_fmt(ev.get('slot_budget'))} "
                         f"patience={_fmt(ev.get('shrink_patience'))} "
                         f"queue={_fmt(ev.get('queue_depth'))}")
        elif kind == "pod_lost":
            lines.append(f"pod_lost  pod={ev.get('pod')} at "
                         f"epoch={ev.get('epoch')} rung={_fmt(ev.get('rung'))}")
        elif kind == "demote":
            lines.append(f"demote    rung {_fmt(ev.get('src'))} -> "
                         f"{ev.get('dst')} (pods {_fmt(ev.get('pods'))}, "
                         f"dp {_fmt(ev.get('dp'))})")
    return "\n".join(lines)


def summary(events: list[dict]) -> str:
    """The full human-readable report for one run log."""
    parts = []
    start = next((e for e in events if e.get("kind") == "run_start"), None)
    if start is not None:
        parts.append(f"run: {json.dumps(start.get('run', {}), default=jsonable)}")
    life = lifecycle(events)
    if life:
        parts.append(life)
    if any(e.get("kind") == "epoch" for e in events):
        parts.append("epochs:")
        parts.append(epoch_table(events))
    if any(e.get("kind") == "serve_window" for e in events):
        parts.append("serve windows:")
        parts.append(serve_table(events))
    sched = schedule(events)
    if sched:
        parts.append(f"schedule ({len(sched)} decisions):")
        parts.append(_table(sched, ["epoch", "step", "boundary",
                                    "batch_size", "lr", "rung"]))
    return "\n".join(parts)


def merge_traces(run_dir: str, out: str) -> str:
    """Merge every ``trace*.json`` under ``run_dir`` plus the run log into
    one Perfetto-loadable trace; run-log events become instants on their own
    thread lane, aligned via the first trace's ``wall_origin``."""
    traces = sorted(glob.glob(os.path.join(run_dir, "trace*.json")))
    merged: list[dict] = []
    origin = None
    pid = 0
    for p in traces:
        with open(p) as f:
            doc = json.load(f)
        other = doc.get("otherData", {})
        if origin is None and other.get("wall_origin") is not None:
            origin = float(other["wall_origin"])
            pid = int(other.get("pid", 0))
        merged.extend(doc.get("traceEvents", []))
    log_path = os.path.join(run_dir, "runlog.jsonl")
    if os.path.exists(log_path) and origin is not None:
        merged.append({"ph": "M", "name": "thread_name", "ts": 0.0,
                       "pid": pid, "tid": -1, "args": {"name": "runlog"}})
        for ev in read_runlog(log_path):
            t = ev.get("t")
            if t is None:
                continue
            args = {k: v for k, v in ev.items() if k not in ("v", "t")}
            merged.append({
                "ph": "i", "name": ev.get("kind", "event"), "s": "t",
                "ts": (float(t) - origin) * 1e6, "pid": pid, "tid": -1,
                "args": args,
            })
    with open(out, "w") as f:
        json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f,
                  default=jsonable)
    return out


def _drain(f, buf: str) -> tuple[list[str], str]:
    """Read every COMPLETE line currently available on ``f``.

    A live writer's trailing record may be torn (flushed mid-line, or read
    mid-write): partial text is carried in ``buf`` and re-joined with the
    rest of the line once the writer completes it — a follower never emits
    (or json-parses) a half record, and never loses one either.  Returns
    ``(complete_lines, carry_buffer)``; pure, so the torn-tail behaviour is
    unit-testable without a live tail loop (tests/test_obs.py).
    """
    lines: list[str] = []
    while True:
        chunk = f.readline()
        if not chunk:
            return lines, buf
        buf += chunk
        if buf.endswith("\n"):
            if buf.strip():
                lines.append(buf.strip())
            buf = ""


def _follow(path: str) -> None:
    """Tail the run log, printing each typed event as it lands (torn/partial
    trailing lines are held back until the writer completes them)."""
    if os.path.isdir(path):
        path = os.path.join(path, "runlog.jsonl")
    while not os.path.exists(path):
        time.sleep(0.2)
    buf = ""
    with open(path) as f:
        while True:
            lines, buf = _drain(f, buf)
            for line in lines:
                print(line)
            if not lines:
                time.sleep(0.5)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("run", help="runs/<name> directory or runlog.jsonl path")
    ap.add_argument("--follow", action="store_true",
                    help="tail the log instead of printing the summary")
    ap.add_argument("--trace", default=None, metavar="OUT",
                    help="also write the merged trace.json (trace*.json + "
                         "run-log instants) to OUT")
    args = ap.parse_args(argv)
    if args.follow:
        try:
            _follow(args.run)
        except KeyboardInterrupt:
            return
        return
    print(summary(load(args.run)))
    if args.trace:
        run_dir = args.run if os.path.isdir(args.run) else os.path.dirname(args.run)
        print(f"merged trace: {merge_traces(run_dir, args.trace)}")


if __name__ == "__main__":
    main()
