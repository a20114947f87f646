"""The roofline arithmetic, the device-trace union and the counter
readers, against hand-worked numbers."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import devtrace, roofline
from portbench import spec as spec_mod


def test_bound_by_hand():
    # 1,000,000 x 768 f32, Q=32, k=100: bytes (1e6 + 32)·768·4 + 8e6 + 8·32·100 = 3,080,123,904
    b = roofline.bound("f32", 32, 1_000_000, 768, 100)
    assert b["bytes"] == (1_000_000 + 32) * 768 * 4 + 8_000_000 + 25_600
    assert b["bound_by"] == "read"
    assert b["bound_s"] == pytest.approx(3_080_123_904 / 3.35e12, rel=1e-12)
    # Q=1024: 2·1024·1e6·768 = 1.5729e12 operations at 67e12/s = 23.48 ms
    b = roofline.bound("f32", 1024, 1_000_000, 768, 100)
    assert b["bound_by"] == "f32" and b["ops"] == 2 * 1024 * 1_000_000 * 768
    assert b["bound_s"] == pytest.approx(0.023476, rel=1e-4)
    assert roofline.bound("int8", 1, 8, 16, 1)["bytes"] == 9 * 16 + 64 + 8


def test_busy_union_gaps_and_top():
    ev = [("a", "kernel", 0.0, 10.0), ("b", "kernel", 5.0, 10.0), ("c", "gpu_memcpy", 30.0, 5.0),
          ("a", "kernel", 100.0, 1.0)]
    s = devtrace.summary(ev)
    assert s["busy_s"] == pytest.approx(21e-6)
    assert s["device_ops"] == [["a", pytest.approx(11e-6)], ["b", pytest.approx(10e-6)], ["c", pytest.approx(5e-6)]]
    assert s["idle_gaps"][0] == ["c -> a", pytest.approx(65e-6)]
    assert s["idle_gaps"][1] == ["b -> c", pytest.approx(15e-6)]


def run_view(**kw):
    base = dict(counters={}, latencies_s=np.array([0.01, 0.03]), device_events=None, trace_window_s=1.0, k=100,
                config={"precision": "fp32", "rows": 1_000_000, "dim": 768}, queries_answered=64, window_s=2.0,
                setup_s=5.0)
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers():
    spec = spec_mod.Spec()
    c = {"batch.dispatches": 4.0, "batch.queries": 64.0, "search.count": 2.0, "search.seconds": 0.03,
         "ivf.rank_seconds": 0.2, "ivf.route_seconds": 0.2, "filter.seconds": 0.004}
    v = run_view(counters=c)
    assert spec.reader("qps").read(v) == 32.0
    assert spec.reader("p95_ms").read(v) == pytest.approx(29.0)
    assert spec.reader("flight.wire_ms").read(v) == pytest.approx(20.0 - 15.0)
    assert spec.reader("batch.queries_per_dispatch").read(v) == 16.0
    assert spec.reader("ivf.host_ms_per_dispatch").read(v) == pytest.approx(100.0)
    assert spec.reader("filter.ms_per_dispatch").read(v) == pytest.approx(1.0)
    assert spec.reader("phase1_roofline").read(v) is None  # no trace: nothing to read
    least = roofline.bound("f32", 16, 1_000_000, 768, 100)["bound_s"]
    ev = [("void fenix::stream_kernel<float, 2, true>(...)", "kernel", 0.0, 2000.0),
          ("elementwise", "kernel", 2000.0, 500.0)] * 4
    v = run_view(counters=c, device_events=ev)
    assert spec.reader("phase1_roofline").read(v) == pytest.approx(100 * 4 * least / 8000e-6)
    assert spec.reader("device.idle_share").read(v) == pytest.approx(1 - 2500e-6)
    assert spec.reader("filter.ms_per_dispatch").read(run_view()) is None


@pytest.mark.parametrize("name, counted", [
    ("void fenix::(anonymous namespace)::tiled_kernel<float, 8, true>(float const*, float const*)", True),
    ("void fenix::(anonymous namespace)::tensor_kernel<signed char, 128, false>(CUtensorMap)", True),
    ("void fenix::stream_kernel<float, 2, true>(...)", True),
    ("void fenix::(anonymous namespace)::outer_kernel<24>(CUtensorMap)", True),
    ("void at::native::tensor_kernel_scan_innermost_dim<int, std::plus<int> >(int*, int const*)", False),
    ("void at::native::(anonymous namespace)::tiled_kernel<float>(float*)", False),
    ("fenix::(anonymous namespace)::stream_kernel_host_copy", False),
])
def test_phase1_kernels_by_whole_symbol(name, counted):
    """The phase-1 device time counts the port's kernels by their whole
    symbol, never a library kernel whose name holds one of theirs."""
    c = {"batch.dispatches": 1.0, "batch.queries": 16.0}
    ev = [("void fenix::stream_kernel<float, 2, true>(...)", "kernel", 0.0, 1000.0), (name, "kernel", 1000.0, 1000.0)]
    least = roofline.bound("f32", 16, 1_000_000, 768, 100)["bound_s"]
    got = spec_mod.Spec().reader("phase1_roofline").read(run_view(counters=c, device_events=ev))
    assert got == pytest.approx(100 * least / ((2000e-6) if counted else 1000e-6))
