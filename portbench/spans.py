"""The program's spans beside the card's operations, on one clock.

The port's span recorder (``fenix_tpu_torch.utils.profiling``) times its
spans on ``time.time_ns()``. A ``torch.profiler`` Chrome trace gives a
device operation's start as ``ts`` µs after the trace's
``baseTimeNanoseconds``, unix time floored to 7,889,238-s intervals
(libkineto's ``ChromeTraceBaseTime``); ``devtrace.device_events`` keeps
``ts`` and drops the base, which :func:`trace_base_ns` recomputes.

:func:`fetch_offsets` checks that the two clocks agree: the dispatcher
enqueues a batch's search and the pinned device-to-host copies of its
results, then waits for them in ``fenix.fetch``, and enqueues the next
batch only after that wait. So each pinned copy must end at or before
the end of the first ``fenix.fetch`` span that ends after it, and start
after the end of the fetch before that, within ``TOLERANCE_NS``. Where
they do not (the clocks disagree, or the copies and waits are not one
dispatcher's, as with ``FENIX_PIPELINE_DEPTH > 0`` or solo searches),
the join is not made.

Standard library only; a span is any object with ``name``, ``start_ns``
and ``end_ns``, a device event ``(name, category, ts µs, dur µs)``.
"""

from __future__ import annotations

import bisect
import time

TRIMONTH_S = 7_889_238
TOLERANCE_NS = 1_000_000
FETCH = "fenix.fetch"
DISPATCHING = ("batch.dispatch", "batch.finish")  # the dispatcher's and the completer's host work


def trace_base_ns(now_ns: "int | None" = None) -> int:
    """The ``baseTimeNanoseconds`` of a trace exported at ``now_ns``."""
    now_s = (time.time_ns() if now_ns is None else now_ns) // 1_000_000_000
    return now_s // TRIMONTH_S * TRIMONTH_S * 1_000_000_000


def intervals(events, base_ns: int, pinned_copies: bool = False) -> list[tuple[int, int]]:
    """``(start, end)`` unix ns of the device events, by start; with
    ``pinned_copies``, of the device-to-host copies into pinned memory
    (``Memcpy DtoH (Device -> Pinned)``) alone."""
    out = [(base_ns + round(ts * 1e3), base_ns + round((ts + dur) * 1e3)) for name, cat, ts, dur in events
           if not pinned_copies or (cat == "gpu_memcpy" and "DtoH" in name and "Pinned" in name)]
    return sorted(out)


def merge(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of intervals, as disjoint intervals by start."""
    out: list[list[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The intervals between consecutive disjoint ``busy`` intervals."""
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]


def overlap(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """ns covered by both of two lists of disjoint intervals by start."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def fetch_offsets(copies: list[tuple[int, int]], recorded) -> "list[int] | None":
    """Each pinned copy's end less the end of the ``fenix.fetch`` span
    that waits for it (<= ``TOLERANCE_NS``); None when a copy has no fetch
    ending after it, starts before the previous fetch ended, or there is
    no copy or no fetch to compare."""
    ends = sorted(s.end_ns for s in recorded if s.name == FETCH)
    if not copies or not ends:
        return None
    out = []
    for start, end in copies:
        j = bisect.bisect_left(ends, end - TOLERANCE_NS)
        if j == len(ends) or (j > 0 and start < ends[j - 1] - TOLERANCE_NS):
            return None
        out.append(end - ends[j])
    return out


def idle_dispatching_share(events, recorded, base_ns: int) -> "float | None":
    """The share of the card's idle time, between its first and last
    operation, during which a thread was inside ``batch.dispatch`` or
    ``batch.finish``; None without idle time, or when the clocks fail
    :func:`fetch_offsets`."""
    busy = merge(intervals(events, base_ns))
    idle = gaps(busy)
    idle_ns = sum(e - s for s, e in idle)
    if not idle_ns or fetch_offsets(intervals(events, base_ns, pinned_copies=True), recorded) is None:
        return None
    lo, hi = busy[0][0], busy[-1][1]
    work = merge([(max(s.start_ns, lo), min(s.end_ns, hi)) for s in recorded if s.name in DISPATCHING])
    return overlap(idle, work) / idle_ns
