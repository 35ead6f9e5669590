"""Chrome ``trace_event`` JSON for the telemetry recorder.

Port of ``perceiver_io_tpu/obs/trace.py``, schema ``chrome-trace/v1``
unchanged: a trace either package writes validates under the other's
validator. The recorder (obs/core.py) buffers events with offsets in
seconds from its construction; this module renders them in the Chrome
trace-event format that Perfetto and chrome://tracing load: complete spans
("X", microsecond ``ts``/``dur``), async lifecycle spans ("b"/"n"/"e" keyed
by id, one a served request) and instant markers ("i"). The recorder's
summary rides in the trace's ``metadata``, so one file carries both the
timeline and the numbers ``python -m perceiver_io_torch.obs.report``
tabulates.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

TRACE_SCHEMA = "chrome-trace/v1"

_S_TO_US = 1e6


def to_chrome_trace(events: List[Dict], summary: Optional[Dict] = None, dropped: int = 0) -> Dict:
    """Recorder events (offsets in seconds) as a Chrome trace dict: ``ts``
    and ``dur`` become microseconds, everything else passes through."""
    out = []
    for ev in events:
        ev = dict(ev)
        ev["ts"] = round(ev["ts"] * _S_TO_US, 3)
        if "dur" in ev:
            ev["dur"] = round(ev["dur"] * _S_TO_US, 3)
        ev.setdefault("pid", os.getpid())
        out.append(ev)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "metadata": {
            "schema": TRACE_SCHEMA,
            **({"summary": summary} if summary else {}),
            **({"events_dropped": dropped} if dropped else {}),
        },
    }


def write_chrome_trace(path: str, trace: Dict) -> str:
    """Write atomically (a temporary file, then a rename): a kill mid-write
    leaves the previous trace, never a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_chrome_trace(path: str) -> Dict:
    with open(path) as f:
        trace = json.load(f)
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError(f"{path} is not a Chrome trace object (no traceEvents)")
    return trace


def validate_chrome_trace(trace: Dict) -> List[str]:
    """Structural checks; returns the problems found (empty: valid).

    Every event has a phase and a non-negative numeric ``ts``; complete
    events a non-negative ``dur``; async spans balance: each (cat, id) a
    "b" opens is closed by one "e" not before it. A trace whose recorder
    evicted events (``metadata.events_dropped`` > 0) may hold ends and
    instants whose begins were dropped, and spans still open: those are
    tolerated then, and reported otherwise."""
    problems: List[str] = []
    truncated = bool((trace.get("metadata") or {}).get("events_dropped"))
    open_async: Dict[tuple, float] = {}
    for i, ev in enumerate(trace.get("traceEvents", [])):
        ph = ev.get("ph")
        ts = ev.get("ts")
        if ph is None or not isinstance(ts, (int, float)):
            problems.append(f"event {i}: missing ph/ts ({ev})")
            continue
        if ts < 0:
            problems.append(f"event {i} ({ev.get('name')}): negative ts {ts}")
        if ph == "X" and not (isinstance(ev.get("dur"), (int, float)) and ev["dur"] >= 0):
            problems.append(f"event {i} ({ev.get('name')}): bad dur {ev.get('dur')}")
        elif ph == "b":
            key = (ev.get("cat"), ev.get("id"))
            if key in open_async:
                problems.append(f"event {i}: async span {key} begun twice")
            open_async[key] = ts
        elif ph == "e":
            key = (ev.get("cat"), ev.get("id"))
            if key not in open_async:
                if not truncated:
                    problems.append(f"event {i}: async end {key} without begin")
            elif ts < open_async.pop(key):
                problems.append(f"event {i}: async span {key} ends before it begins")
        elif ph == "n":
            key = (ev.get("cat"), ev.get("id"))
            if key not in open_async and not truncated:
                problems.append(f"event {i}: async instant {key} outside open span")
    if not truncated:
        for key in open_async:
            problems.append(f"async span {key} never ended")
    return problems
