"""Device time from a ``torch.profiler`` capture of the window.

The interval arithmetic is that of ``chip_smoke.py:3601-3633``
(``trace_summary``: the union of the device's kernel, copy and memset
intervals, and the operations taking most time), frozen here and applied
to the whole window rather than to one request's span, and extended with
the longest idle gaps between device intervals.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device activity in a torch.profiler trace
TOP = 10  # entries in each breakdown list


def device_events(chrome_trace: str) -> list[tuple[str, str, float, float]]:
    """``(name, category, start µs, duration µs)`` of every device
    operation in a Chrome trace file, by start."""
    with open(chrome_trace) as fh:
        events = json.load(fh).get("traceEvents", [])
    out = [(e["name"], e["cat"], float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events if isinstance(e, dict) and e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(out, key=lambda e: e[2])


def summary(events: list[tuple[str, str, float, float]]) -> dict:
    """Busy seconds (the union of the intervals), the operations taking
    most time by name, and the longest gaps between busy intervals, each
    named by the operations on either side."""
    busy, end, last = 0.0, None, None
    by_op: dict[str, float] = {}
    gaps: list[tuple[float, str]] = []
    for name, _, ts, dur in events:
        stop = ts + dur
        if end is not None and ts > end:
            gaps.append(((ts - end) / 1e6, f"{last} -> {name}"))
        if end is None or stop > end:
            busy += stop - max(ts, end if end is not None else ts)
            end, last = stop, name
        by_op[name] = by_op.get(name, 0.0) + dur / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    gaps.sort(key=lambda g: -g[0])
    return {
        "busy_s": busy / 1e6,
        "device_ops": [[n, s] for n, s in top],
        "idle_gaps": [[label, s] for s, label in gaps[:TOP]],
    }
