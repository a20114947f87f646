"""The readers of the port's span recorder and the join of its spans with
the device trace, against hand-worked numbers."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import spans
from portbench import spec as spec_mod
from portbench.tests.test_portbench_arith import run_view

NOW = 1_792_297_193_703_357_912  # unix ns
BASE = spans.trace_base_ns(NOW)
MS = 1_000_000


def span(name, start_ms, end_ms):
    return SimpleNamespace(name=name, start_ns=BASE + round(start_ms * MS), end_ns=BASE + round(end_ms * MS))


# the card: a search 0-1 ms and its pinned copy to 1.01 ms, idle until a
# search at 10 ms and its copy to 11.01 ms (trace ``ts``/``dur`` in µs)
EVENTS = [("void fenix::tiled_kernel<float, 8, true>(...)", "kernel", 0.0, 1000.0),
          ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1000.0, 10.0),
          ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 10000.0, 5.0),
          ("void fenix::tiled_kernel<float, 8, true>(...)", "kernel", 10005.0, 995.0),
          ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 11000.0, 10.0)]
# the dispatcher: the first dispatch straddles the idle gap's start, the
# second its end; each fetch ends after the copy it waits for
SPANS = [span("batch.dispatch", -1.0, 1.2), span("fenix.fetch", 0.5, 1.05), span("batch.idle", 1.2, 5.0),
         span("batch.dispatch", 5.0, 11.2), span("fenix.fetch", 10.6, 11.05),
         span("fenix.rpc.search", 0.0, 12.0)]


def test_base_is_the_trimonth_floor():
    assert BASE % (spans.TRIMONTH_S * 10**9) == 0 and 0 <= NOW - BASE < spans.TRIMONTH_S * 10**9
    assert spans.trace_base_ns(BASE) == BASE and spans.trace_base_ns(BASE - 1) < BASE


def test_interval_arithmetic():
    assert spans.merge([(5, 9), (0, 2), (1, 3), (9, 9), (8, 12)]) == [(0, 3), (5, 12)]
    assert spans.gaps([(0, 3), (5, 12), (12, 14)]) == [(3, 5)]
    assert spans.overlap([(0, 3), (5, 12)], [(2, 6), (11, 20)]) == 1 + 1 + 1
    copies = spans.intervals(EVENTS, BASE, pinned_copies=True)
    assert copies == [(BASE + MS, BASE + MS + 10_000), (BASE + 11 * MS, BASE + 11 * MS + 10_000)]


def test_idle_join_by_hand():
    """Idle 1.01-10 ms (8.99 ms); dispatching over it 1.01-1.2 and 5-10 ms."""
    share = spans.idle_dispatching_share(EVENTS, SPANS, BASE)
    assert share == pytest.approx((0.19 + 5.0) / 8.99, rel=1e-9)
    offsets = spans.fetch_offsets(spans.intervals(EVENTS, BASE, pinned_copies=True), SPANS)
    assert offsets == [-40_000, -40_000]  # each copy ends 40 µs before its fetch


def test_misaligned_clocks_refuse_the_join():
    copies = spans.intervals(EVENTS, BASE, pinned_copies=True)
    # the card 2 ms late: the last copy ends after every fetch
    assert spans.idle_dispatching_share(EVENTS, SPANS, BASE + 2 * MS) is None
    # a fetch ending 1.5 ms before the copy it waits for
    early = [s for s in SPANS if s.end_ns != BASE + round(11.05 * MS)] + [span("fenix.fetch", 9.0, 9.51)]
    assert spans.fetch_offsets(copies, early) is None
    assert spans.idle_dispatching_share(EVENTS, early, BASE) is None
    # within 1 ms the join stands
    late = [s for s in SPANS if s.end_ns != BASE + round(11.05 * MS)] + [span("fenix.fetch", 10.4, 10.5)]
    assert max(spans.fetch_offsets(copies, late)) == 510_000
    # a copy that starts before the previous fetch returned is not that dispatcher's
    waits = [span("fenix.fetch", 0.5, 3.0), span("fenix.fetch", 10.6, 11.05)]
    assert spans.fetch_offsets(copies, waits) == [-1_990_000, -40_000]
    overlapped = EVENTS + [("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 500.0, 10000.0)]
    assert spans.fetch_offsets(spans.intervals(overlapped, BASE, pinned_copies=True), waits) is None
    assert spans.idle_dispatching_share(overlapped, waits, BASE) is None
    assert spans.fetch_offsets([], SPANS) is None and spans.fetch_offsets(copies, []) is None


def test_no_idle_time_reads_nothing():
    busy = [("k", "kernel", 0.0, 10.0), ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 10.0, 1.0)]
    assert spans.idle_dispatching_share(busy, [span("fenix.fetch", 0.0, 0.02)], BASE) is None


def test_counter_readers_by_hand():
    spec = spec_mod.Spec()
    c = {"batch.dispatches": 4.0, "batch.requests": 64.0, "search.count": 64.0,
         "batch.queue_wait_seconds": 1.28, "batch.dispatch_seconds": 0.24, "batch.dispatch_cpu_seconds": 0.09,
         "batch.dispatch_host_seconds": 0.18, "flight.decode_seconds": 0.032, "flight.encode_seconds": 0.096,
         "results.gather_seconds": 0.02, "phase2.device_seconds": 0.1}
    v = run_view(counters=c)
    assert spec.reader("batch.queue_wait_ms").read(v) == pytest.approx(20.0)
    assert spec.reader("batch.dispatch_ms").read(v) == pytest.approx(60.0)
    assert spec.reader("dispatcher.on_cpu_share").read(v) == pytest.approx(0.5)
    assert spec.reader("flight.handler_ms").read(v) == pytest.approx(2.0)
    assert spec.reader("results.gather_ms_per_dispatch").read(v) == pytest.approx(5.0)
    assert spec.reader("phase2.device_ms_per_dispatch").read(v) == pytest.approx(25.0)
    # a program that counts none of them (tracing off, or the parent of
    # these metrics): nothing to read, no error
    bare = run_view(counters={"batch.dispatches": 4.0, "batch.requests": 64.0, "search.count": 64.0})
    for name in ("batch.queue_wait_ms", "batch.dispatch_ms", "dispatcher.on_cpu_share", "flight.handler_ms",
                 "results.gather_ms_per_dispatch", "phase2.device_ms_per_dispatch"):
        assert spec.reader(name).read(bare) is None
        assert spec.reader(name).read(run_view(counters={})) is None


def test_idle_join_reader(monkeypatch):
    """The reader takes the window's spans from the program's recorder:
    None with a dropped span, without a trace, or from a program that has
    no recorder."""
    from fenix_tpu_torch.utils import profiling

    reader = spec_mod.Spec().reader("device.idle_dispatching_share")
    asked = []
    monkeypatch.setattr(profiling, "spans", lambda t0, t1=None: asked.append((t0, t1)) or SPANS)
    monkeypatch.setattr(spans, "trace_base_ns", lambda: BASE)
    v = run_view(device_events=EVENTS, counters={"batch.dispatches": 2.0})
    assert reader.read(v) == pytest.approx(5.19 / 8.99, rel=1e-9)
    assert asked == [(BASE, None)]  # from the card's first operation on
    assert reader.read(run_view(device_events=EVENTS, counters={"spans.dropped": 1.0})) is None
    assert reader.read(run_view(device_events=None)) is None
    monkeypatch.delattr(profiling, "spans")
    assert reader.read(v) is None
