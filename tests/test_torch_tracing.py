"""fenix_tpu_torch.utils.profiling's span recorder on the CPU: armed by
any ``torch.profiler`` capture in the process, recording on every thread
of the server (the Flight handlers, the batch dispatcher), on the clock
of the Chrome trace, and silent with no capture; the counters its spans
move; the removed counters; ``Metrics.timed``'s log line."""

import glob
import json
import logging
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

import fenix_tpu_torch
from fenix_tpu_torch import coder, expr, index
from fenix_tpu_torch.engine import batching, executor
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.utils import metrics, profiling
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

torch.set_num_threads(2)

N, DIM = 2048, 16
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture
def root(tmp_path, rng):
    root = str(tmp_path / "root")
    vecs = rng.standard_normal((N, DIM)).astype(np.float32)
    table.make(root, "t", pa.table({
        "id": pa.array(np.arange(N)),
        "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32()),
        "tag": pa.array(rng.integers(0, 8, N).astype(np.int32)),
    }).to_reader())
    return root


class Capture:
    """A ``torch.profiler`` capture held open on a thread of its own."""

    def __init__(self) -> None:
        self._up, self._stop = threading.Event(), threading.Event()
        self._thread = threading.Thread(target=self._hold, name="capture")

    def _hold(self) -> None:
        with torch.profiler.profile(activities=CPU):
            self._up.set()
            self._stop.wait(60)

    def __enter__(self) -> "Capture":
        self._thread.start()
        assert self._up.wait(60)
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(60)
        assert not self._thread.is_alive()


def _serve(root):
    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    return server


def _concurrently(fns) -> list:
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return out


def _wait_for(cond, seconds: float = 30.0) -> None:
    """Wait for ``cond()``: a handler's span ends just after its answer is
    on the wire, so a client can hold the answer first."""
    deadline = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(0.005)


def _delta(before: dict, after: dict) -> dict:
    return {n: after.get(n, 0.0) - before.get(n, 0.0) for n in set(after) | set(before)}


def test_torch_flag_flips_for_a_capture_on_another_thread():
    """The module global the recorder reads is true on every thread while
    a capture started on another thread is active; torch's thread-local
    flag is not (so torch's own ``record_function`` misses this thread)."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert profiling.annotate("x") is profiling.annotate("y")  # the shared no-op
    with Capture():
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert isinstance(profiling.annotate("x"), profiling.Span)
        assert not torch.autograd._profiler_enabled()
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_span_clock_is_the_trace_clock(tmp_path):
    """A span enclosing a ``record_function`` block on the capturing thread
    contains that block's ``baseTimeNanoseconds + ts`` interval within
    1 ms: the spans and the trace's events share one clock."""
    t0 = time.time_ns()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("clock.outer"):
            time.sleep(0.002)
            with torch.profiler.record_function("clock.inner"):
                (torch.ones(4096) * 2).sum()
                time.sleep(0.005)
            time.sleep(0.002)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as fh:
        doc = json.load(fh)
    (inner,) = [e for e in doc["traceEvents"] if e.get("name") == "clock.inner"]
    start = doc["baseTimeNanoseconds"] + inner["ts"] * 1e3
    end = start + inner["dur"] * 1e3
    (outer,) = [s for s in profiling.spans(t0) if s.name == "clock.outer"]
    assert outer.in_torch  # the capturing thread: also a record_function
    assert outer.start_ns - 1e6 <= start < end <= outer.end_ns + 1e6


def test_spans_on_every_thread_while_a_capture_runs_elsewhere(root, rng):
    """With a capture on a third thread, the dispatcher and two submitting
    threads record their spans, each under its own thread id and name,
    with parents on its own thread."""
    cache = DeviceCache(root, device="cpu")
    batcher = batching.SearchBatcher(cache)
    targets = [rng.standard_normal(DIM).astype(np.float32) for _ in range(2)]
    batcher.submit(executor.SearchRequest("t", "vector", targets[0], metric="l2", maxval=3))  # warm
    t0 = time.time_ns()
    with Capture():
        _concurrently([lambda t=t, r=r: batcher.submit(
            executor.SearchRequest("t", "vector", t, metric="l2", maxval=3), r) for r, t in enumerate(targets)])
    got = profiling.spans(t0)
    by_id = {s.id: s for s in got}
    waits = [s for s in got if s.name == "batch.wait"]
    dispatches = [s for s in got if s.name == "batch.dispatch"]
    assert sorted(s.links["requests"][0] for s in waits) == [0, 1]
    assert len({s.tid for s in waits}) == 2 and threading.get_native_id() not in {s.tid for s in waits}
    assert dispatches and {s.thread for s in dispatches} == {"fenix-search-batcher"}
    assert sorted(r for s in dispatches for r in s.links["requests"]) == [0, 1]
    inner = {s.name for s in got if s.parent in {d.id for d in dispatches}}
    assert {"fenix.snapshot", "executor.prepare", "executor.launch", "fenix.fetch", "fenix.result_gather"} <= inner
    for s in got:
        assert s.start_ns <= s.end_ns and s.cpu_ns >= 0 and not s.in_torch
        if s.parent in by_id:
            assert by_id[s.parent].tid == s.tid
            assert by_id[s.parent].start_ns <= s.start_ns and s.end_ns <= by_id[s.parent].end_ns


def test_no_capture_records_no_span(root, rng):
    """With no capture, a site without a counter or a wait is the shared
    no-op and moves nothing; the timed sites count (as ``filter.seconds``
    does) and record no span, and phase 2's device time is not read."""
    cache = DeviceCache(root, device="cpu")
    batcher = batching.SearchBatcher(cache)
    req = executor.SearchRequest("t", "vector", rng.standard_normal(DIM).astype(np.float32), metric="l2", maxval=3)
    batcher.submit(req)  # warm
    kept, before = len(profiling.spans()), METRICS.snapshot()
    assert profiling.annotate("x") is profiling.annotate("y", requests=(1,))
    with profiling.annotate("x", requests=(1,)):
        pass
    assert METRICS.snapshot() == before
    with profiling.annotate("x", counter="unit.x"):
        pass
    batcher.submit(req, 7)
    moved = {n for n, v in _delta(before, METRICS.snapshot()).items() if v}
    assert len(profiling.spans()) == kept
    assert {"unit.x_seconds", "batch.dispatches", "batch.queue_wait_seconds", "batch.dispatch_seconds",
            "batch.dispatch_host_seconds", "batch.dispatch_cpu_seconds", "results.gather_seconds"} <= moved
    assert not moved & {"phase2.device_seconds", "spans.dropped"}


def test_dispatch_counters_and_waits(root, rng):
    """While armed: the dispatch's wall, host and CPU seconds (host and CPU
    less its fetch wait), the result gather, and no phase-2 device time
    on the CPU."""
    cache = DeviceCache(root, device="cpu")
    batcher = batching.SearchBatcher(cache)
    req = executor.SearchRequest("t", "vector", rng.standard_normal((4, DIM)).astype(np.float32),
                                 metric="cosine", maxval=5)
    batcher.submit(req)
    before = METRICS.snapshot()
    t0 = time.time_ns()
    with Capture():
        batcher.submit(req, 3)
    d = _delta(before, METRICS.snapshot())
    (span,) = [s for s in profiling.spans(t0) if s.name == "batch.dispatch"]
    (fetch,) = [s for s in profiling.spans(t0) if s.name == "fenix.fetch"]
    assert fetch.parent == span.id and span.wait_ns == fetch.end_ns - fetch.start_ns
    assert d["batch.dispatch_seconds"] == pytest.approx(span.seconds)
    assert d["batch.dispatch_host_seconds"] == pytest.approx(span.seconds - fetch.seconds)
    assert 0 <= d["batch.dispatch_cpu_seconds"] <= d["batch.dispatch_host_seconds"] + 1e-3
    assert 0 < d["results.gather_seconds"] <= d["batch.dispatch_seconds"]
    assert d["batch.queue_wait_seconds"] >= 0 and not d.get("phase2.device_seconds")


def test_spans_from_many_threads_are_all_kept():
    """More threads than cores record nested spans with a short switch
    interval: every span is kept once, its parent open on its own thread,
    and the waits of each thread's outer spans are their own."""
    import sys

    def work(i):
        for _ in range(100):
            with profiling.annotate("stress.outer", requests=(i,)):
                with profiling.annotate("stress.wait", wait=True):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t0 = time.time_ns()
    try:
        with Capture():
            _concurrently([lambda i=i: work(i) for i in range(3 * (os.cpu_count() or 1))])
    finally:
        sys.setswitchinterval(old)
    got = [s for s in profiling.spans(t0) if s.name.startswith("stress.")]
    outer = {s.id: s for s in got if s.name == "stress.outer"}
    assert len(got) == 2 * len(outer) == 2 * 100 * 3 * (os.cpu_count() or 1)
    assert len({s.id for s in got}) == len(got)
    for s in got:
        if s.name == "stress.wait":
            parent = outer[s.parent]
            assert parent.tid == s.tid and parent.wait_ns == s.end_ns - s.start_ns


def test_dropped_spans_are_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    monkeypatch.setattr(profiling, "_STORE", profiling._Store())
    before = METRICS.snapshot().get("spans.dropped", 0)
    with Capture():
        for i in range(5):
            with profiling.annotate(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4"]
    assert METRICS.snapshot()["spans.dropped"] == before + 2


def test_traced_search_goes_through_the_batcher(tmp_path, root, rng, monkeypatch):
    """A search captured by FENIX_TRACE_DIR is batched like any other
    (``batch.dispatches`` moves) and answers as an untraced one; its trace
    holds the dispatcher's spans on the dispatcher's thread, and the
    handler's ``fenix.rpc.search`` once."""
    trace_dir = str(tmp_path / "traces")
    server = _serve(root)
    try:
        client = fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port)
        target = rng.standard_normal(DIM).astype(np.float32)
        untraced = client.search(target, "t", "vector", metric="l2", maxval=5, filter=expr.field("tag") < 6)
        monkeypatch.setenv(profiling.TRACE_DIR_ENV, trace_dir)
        before = METRICS.snapshot()
        traced = client.search(target, "t", "vector", metric="l2", maxval=5, filter=expr.field("tag") < 6)
        d = _delta(before, METRICS.snapshot())
        client.close()
    finally:
        server.shutdown()
    assert traced.equals(untraced)
    assert d["batch.dispatches"] == 1 and d["batch.requests"] == 1
    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert [e["name"] for e in spans].count("fenix.rpc.search") == 1
    dispatch = [e for e in spans if e["name"] == "batch.dispatch"]
    assert len(dispatch) == 1 and names[dispatch[0]["tid"]] == "fenix-search-batcher"
    assert {"fenix.snapshot", "fenix.fetch", "fenix.result_gather", "batch.wait", "flight.decode",
            "flight.encode"} <= {e["name"] for e in spans}


def test_dispatch_request_ids_are_its_members(root, rng):
    """Under concurrent clients, each request id of a ``batch.dispatch``
    span is a ``fenix.rpc.search`` span's, served inside that dispatch's
    interval, and every search's id is in exactly one dispatch."""
    server = _serve(root)
    clients = [fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port) for _ in range(4)]
    targets = [rng.standard_normal(DIM).astype(np.float32) for _ in range(4)]
    try:
        for c, t in zip(clients, targets):
            c.search(t, "t", "vector", metric="l2", maxval=3)  # warm
        t0 = time.time_ns()
        with Capture():
            _concurrently([lambda c=c, t=t: [c.search(t, "t", "vector", metric="l2", maxval=3) for _ in range(3)]
                           for c, t in zip(clients, targets)])
    finally:
        for c in clients:
            c.close()
        server.shutdown()
    _wait_for(lambda: sum(s.name == "fenix.rpc.search" for s in profiling.spans(t0)) == 12)
    got = profiling.spans(t0)
    rpc = {s.links["requests"][0]: s for s in got if s.name == "fenix.rpc.search"}
    members = [r for s in got if s.name == "batch.dispatch" for r in s.links["requests"]]
    assert len(rpc) == 12 and sorted(members) == sorted(rpc)
    for d in (s for s in got if s.name == "batch.dispatch"):
        for r in d.links["requests"]:
            assert rpc[r].start_ns <= d.start_ns <= rpc[r].end_ns


def test_queue_wait_is_within_the_search_time(root, rng):
    """Two clients on a CPU server: the requests' summed queue wait is
    counted, and lies within their summed ``search.seconds``."""
    server = _serve(root)
    clients = [fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port) for _ in range(2)]
    try:
        for c in clients:
            c.search(rng.standard_normal(DIM).astype(np.float32), "t", "vector", metric="l2", maxval=3)
        before = METRICS.snapshot()
        with Capture():
            _concurrently([lambda c=c: [c.search(rng.standard_normal((8, DIM)).astype(np.float32), "t", "vector",
                                                 metric="l2", maxval=3) for _ in range(5)] for c in clients])
        d = _delta(before, METRICS.snapshot())
    finally:
        for c in clients:
            c.close()
        server.shutdown()
    assert d["search.count"] == 10 and d["batch.requests"] == 10
    assert 0 < d["batch.queue_wait_seconds"] <= d["search.seconds"]
    assert 0 < d["flight.decode_seconds"] and 0 < d["flight.encode_seconds"]


def test_removed_counters_are_gone(root, rng):
    """``ivf.seconds`` and ``nomax.seconds`` are counted no more: a probed
    search and both no-top-k reads, captured or not, move neither."""
    cache = DeviceCache(root, device="cpu")
    coder.make(root, "c", "t", "vector", {"metric": "l2", "codebook_size": 8, "num_codebooks": 1,
                                          "batch_size": 256, "num_epochs": 1}, seed=0, device="cpu")
    index.make(root, "c", "t", "vector", device="cpu")
    target = rng.standard_normal((2, DIM)).astype(np.float32)
    reqs = [executor.SearchRequest("t", "vector", target, metric="l2", maxval=5, coding="c", probes=2),
            executor.SearchRequest("t", "vector", target, metric="l2", maxval=None),
            executor.SearchRequest("t", "vector", target, metric="l2", maxval=None, filter=expr.field("tag") < 2)]
    before = METRICS.snapshot()
    for req in reqs:
        executor.execute_search(cache, req)
    with Capture():
        for req in reqs:
            executor.execute_search(cache, req)
    d = _delta(before, METRICS.snapshot())
    assert d.get("search.ivf_clustered", 0) + d.get("search.ivf_scan", 0) == 2
    assert d["search.nomax_full"] == 2 and d["search.nomax_selected"] == 2
    assert "ivf.seconds" not in d and "nomax.seconds" not in d


@pytest.mark.parametrize("level, lines", [(logging.WARNING, 0), (logging.INFO, 1)])
def test_timed_logs_only_at_info(caplog, level, lines):
    """``Metrics.timed`` counts every block, and builds its log line only
    when INFO is enabled."""
    m = metrics.Metrics()
    caplog.set_level(level, logger=metrics.LOGGER.name)
    with m.timed("op", source="t") as record:
        record["rows"] = 3
    assert m.snapshot()["op.count"] == 1 and m.snapshot()["op.seconds"] >= 0
    got = [r for r in caplog.records if r.name == metrics.LOGGER.name]
    assert len(got) == lines
    if lines:
        assert json.loads(got[0].getMessage())["op"] == "op"
