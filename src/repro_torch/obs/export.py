"""Chrome-trace (Perfetto-loadable) JSON export of a TraceEvent stream
(copy of ``repro/obs/export.py``).

The output follows the Trace Event Format: a ``traceEvents`` list of
``"X"`` complete slices (events with ``dur > 0``), ``"i"`` instants, and
``"C"`` counter series (pool occupancy), timestamps in MICROseconds.  Open it
at https://ui.perfetto.dev (or chrome://tracing).

Track layout: per-request events render on a thread per engine slot
(``tid = 10 + slot``); slot-less events land on fixed subsystem tracks
(engine 0, scheduler 1, allocator 2).  ``validate_chrome_trace`` checks the
document: structural keys, known phase types, numeric
non-negative timestamps in non-decreasing order.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

from repro_torch.obs.trace import TraceEvent

_PID = 1
_TRACK_ENGINE, _TRACK_SCHED, _TRACK_ALLOC = 0, 1, 2
_KIND_TRACK = {
    "grant": _TRACK_SCHED, "pack": _TRACK_SCHED, "defer": _TRACK_SCHED,
    "alloc": _TRACK_ALLOC, "free": _TRACK_ALLOC, "cow": _TRACK_ALLOC,
    "adopt": _TRACK_ALLOC, "pool": _TRACK_ALLOC,
}
_COUNTER_KINDS = ("pool",)


def _tid(ev: TraceEvent) -> int:
    if ev.slot >= 0:
        return 10 + ev.slot
    return _KIND_TRACK.get(ev.kind, _TRACK_ENGINE)


def chrome_trace(events: Sequence[TraceEvent],
                 process_name: str = "repro-serving") -> Dict[str, Any]:
    """Trace Event Format document.  Event times are rebased to the stream's
    first timestamp so the trace starts at t=0."""
    t0 = min((ev.ts for ev in events), default=0.0)
    out: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
         "args": {"name": process_name}},
        {"name": "thread_name", "ph": "M", "pid": _PID, "tid": _TRACK_ENGINE,
         "args": {"name": "engine"}},
        {"name": "thread_name", "ph": "M", "pid": _PID, "tid": _TRACK_SCHED,
         "args": {"name": "scheduler"}},
        {"name": "thread_name", "ph": "M", "pid": _PID, "tid": _TRACK_ALLOC,
         "args": {"name": "allocator"}},
    ]
    slots = sorted({ev.slot for ev in events if ev.slot >= 0})
    for s in slots:
        out.append({"name": "thread_name", "ph": "M", "pid": _PID,
                    "tid": 10 + s, "args": {"name": f"slot {s}"}})
    for ev in sorted(events, key=lambda e: e.ts):
        ts_us = (ev.ts - t0) * 1e6
        args: Dict[str, Any] = dict(ev.payload)
        if ev.rid >= 0:
            args["rid"] = ev.rid
        if ev.kind in _COUNTER_KINDS:
            # counter series: numeric args only
            out.append({"name": ev.kind, "ph": "C", "pid": _PID,
                        "tid": _tid(ev), "ts": ts_us,
                        "args": {k: v for k, v in args.items()
                                 if isinstance(v, (int, float))}})
        elif ev.dur > 0:
            out.append({"name": ev.kind, "ph": "X", "pid": _PID,
                        "tid": _tid(ev), "ts": ts_us, "dur": ev.dur * 1e6,
                        "args": args})
        else:
            out.append({"name": ev.kind, "ph": "i", "pid": _PID,
                        "tid": _tid(ev), "ts": ts_us, "s": "t", "args": args})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events: Sequence[TraceEvent], path: str,
                       process_name: str = "repro-serving") -> int:
    """Write the JSON document; returns the number of trace events written
    (metadata records excluded)."""
    doc = chrome_trace(events, process_name=process_name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for e in doc["traceEvents"] if e["ph"] != "M")


def validate_chrome_trace(doc: Any) -> List[str]:
    """Structural validation; returns a list of problems (empty = valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not a dict with a traceEvents list"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    last_ts = None
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in e:
                problems.append(f"{where}: missing {key!r}")
        ph = e.get("ph")
        if ph not in ("X", "i", "C", "M"):
            problems.append(f"{where}: unknown ph {ph!r}")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: bad ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            problems.append(f"{where}: ts {ts} < previous {last_ts} "
                            "(not monotonic)")
        last_ts = ts
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event with bad dur {dur!r}")
        if ph == "i" and e.get("s") not in ("t", "p", "g"):
            problems.append(f"{where}: instant with bad scope {e.get('s')!r}")
        if ph == "C":
            args = e.get("args", {})
            if not args or not all(isinstance(v, (int, float))
                                   for v in args.values()):
                problems.append(f"{where}: counter args must be numeric")
    return problems
