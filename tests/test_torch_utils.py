"""fenix_tpu_torch.utils: the profiling trace and its engine spans, the
query log and its replay, against the JAX package's behaviour, on the CPU.

Twins of tests/test_utils.py's four profiling cases (a trace writes a
Chrome trace; a search's trace holds the engine's named spans; a nested
trace is a no-op; no directory, no trace) and of
tests/test_flight.py::test_query_log_replay on the port's server; a log
the JAX server wrote replays in the port with the ids the JAX server
returned (digests compare within one package only).
"""

import glob
import json
import os
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

import fenix_tpu
import fenix_tpu_torch
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu_torch import coder, expr, index
from fenix_tpu_torch.engine import executor, service
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.utils import profiling, replay

torch.set_num_threads(2)

N, DIM = 2048, 16


def spans(trace_dir: str) -> "list[set[str]]":
    """The event names of each trace file under ``trace_dir``, oldest first."""
    out = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))):
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        out.append({e.get("name", "") for e in events if isinstance(e, dict)})
    return out


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


def test_profiling_trace_writes_dump(tmp_path):
    with profiling.trace(str(tmp_path)):
        assert profiling.tracing()
        with profiling.annotate("unit-op"):
            (torch.ones(16) * 2).sum()
    assert not profiling.tracing()
    names = spans(str(tmp_path))
    assert len(names) == 1, "profiler produced no trace file"
    assert "unit-op" in names[0]


def test_engine_stages_annotated_in_trace(tmp_path, root, rng):
    """The engine's stages emit named spans into a captured trace: every
    search its snapshot, fetch and result gather, a probed search its
    cell ranking, a search filtered on the host its mask build."""
    cache = DeviceCache(root, device="cpu")
    target = rng.standard_normal((1, DIM)).astype(np.float32)
    coder.make(root, "c", "t", "vector", {"metric": "l2", "codebook_size": 8, "num_codebooks": 1,
                                          "batch_size": 256, "num_epochs": 1}, seed=0, device="cpu")
    index.make(root, "c", "t", "vector", device="cpu")
    requests = {
        "exact": executor.SearchRequest("t", "vector", target, metric="l2", maxval=5),
        "probed": executor.SearchRequest("t", "vector", target, metric="l2", maxval=5, coding="c", probes=2),
        # "/" keeps the predicate on the host route
        "host_filter": executor.SearchRequest("t", "vector", target, metric="l2", maxval=5,
                                              filter=(expr.field("tag") / 1) < 4),
    }
    for req in requests.values():
        executor.execute_search(cache, req)  # warm outside the capture
    base = {"fenix.snapshot", "fenix.fetch", "fenix.result_gather"}
    extra = {"exact": set(), "probed": {"fenix.rank_cells"}, "host_filter": {"fenix.mask_build"}}
    for name, req in requests.items():
        trace_dir = str(tmp_path / f"trace-{name}")
        with profiling.trace(trace_dir):
            executor.execute_search(cache, req)
        (names,) = spans(trace_dir)
        fenix = sorted(n for n in names if n.startswith("fenix."))
        assert base | extra[name] <= names, (name, fenix)
        if name == "exact":
            assert "fenix.rank_cells" not in names and "fenix.mask_build" not in names, fenix


def test_profiling_concurrent_trace_is_noop(tmp_path):
    """A second trace while one is active runs untraced, not raising
    (Flight handlers run on a thread pool)."""
    with profiling.trace(str(tmp_path)):
        with profiling.trace(str(tmp_path)):  # nested: skipped, no error
            (torch.ones(8) + 1).sum()
        done = []
        other = threading.Thread(target=lambda: done.append(profiling.tracing()))
        other.start()
        other.join()
        assert done == [False]  # another thread holds no capture
    assert len(spans(str(tmp_path))) == 1


def test_profiling_trace_noop_without_dir(monkeypatch, tmp_path):
    monkeypatch.delenv(profiling.TRACE_DIR_ENV, raising=False)
    with profiling.trace(None):
        assert not profiling.tracing()
        # off a capture a span is no record_function at all
        assert not isinstance(profiling.annotate("x"), torch.profiler.record_function)
    monkeypatch.setenv(profiling.TRACE_DIR_ENV, str(tmp_path / "env"))
    with profiling.trace():
        (torch.ones(4) * 3).sum()
    assert len(spans(str(tmp_path / "env"))) == 1


def _serve(server):
    threading.Thread(target=server.serve, daemon=True).start()
    return server


def test_traced_server_request_holds_its_spans(tmp_path, root, rng, monkeypatch):
    """With FENIX_TRACE_DIR set, each search of the port's server writes a
    trace holding fenix.rpc.search and the engine's spans (the traced
    request runs on its handler's thread) and answers as untraced."""
    trace_dir = str(tmp_path / "traces")
    monkeypatch.setenv(profiling.TRACE_DIR_ENV, trace_dir)
    server = _serve(fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu"))
    try:
        client = fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port)
        target = rng.standard_normal(DIM).astype(np.float32)
        got = client.search(target, "t", "vector", metric="l2", maxval=5)
        client.search(target, "t", "vector", metric="l2", maxval=None, filter=expr.field("tag") == 3)
        monkeypatch.delenv(profiling.TRACE_DIR_ENV)
        untraced = client.search(target, "t", "vector", metric="l2", maxval=5)
        client.close()
    finally:
        server.shutdown()
    assert got.equals(untraced)
    traces = spans(trace_dir)
    assert len(traces) == 2
    for names in traces:
        assert {"fenix.rpc.search", "fenix.snapshot", "fenix.result_gather"} <= names, sorted(names)
    assert "fenix.fetch" in traces[0]


def test_query_log_replay(tmp_path, root, rng, monkeypatch):
    """Recorded queries replay with identical result digests (the twin of
    tests/test_flight.py::test_query_log_replay on the port's server)."""
    log = str(tmp_path / "queries.jsonl")
    monkeypatch.setenv(replay.LOG_ENV, log)
    server = _serve(fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu"))
    try:
        client = fenix_tpu.Flight(host="127.0.0.1", port=server.port)
        target = rng.standard_normal(DIM).astype(np.float32)
        for metric in ("l2", "cosine"):
            client.search(target=target, source="t", column="vector", metric=metric, maxval=7)
    finally:
        server.shutdown()
    assert os.path.exists(log)
    assert replay.replay(log, root, device="cpu") == {"total": 2, "matched": 2, "mismatched": 0}


def test_jax_server_log_replays_in_the_port(tmp_path, root, rng, monkeypatch):
    """A log the JAX server wrote loads and replays in the port: each
    logged search gives the ids the JAX server returned."""
    log = str(tmp_path / "jax_queries.jsonl")
    monkeypatch.setenv(replay.LOG_ENV, log)
    jexecutor._CACHES[os.path.abspath(root)] = JaxCache(os.path.abspath(root), mesh=None)
    server = _serve(fenix_tpu.Server(root, host="127.0.0.1", port=0))
    try:
        client = fenix_tpu.Flight(host="127.0.0.1", port=server.port)
        answers = [
            client.search(rng.standard_normal(DIM).astype(np.float32), "t", "vector", metric="cosine", maxval=6),
            client.search(rng.standard_normal((3, DIM)).astype(np.float32), "t", "vector", metric="l2", maxval=4,
                          filter=fenix_tpu.expr.field("tag") < 5),
        ]
    finally:
        server.shutdown()
        jexecutor._CACHES.pop(os.path.abspath(root), None)
    entries = [*replay.load(log)]
    assert len(entries) == 2
    cache = executor.get_cache(root, "cpu")
    for entry, want in zip(entries, answers):
        got = service.run_search_config(cache, entry["config"], replay.target_of(entry))
        assert got.column("id").to_pylist() == want.column("id").to_pylist()
        assert got.column_names == want.column_names
    stats = replay.replay(log, root, device="cpu")
    assert stats["total"] == 2 and stats["matched"] + stats["mismatched"] == 2


def test_quickstart_runs_on_the_cpu():
    """The port's quickstart (server and client in one process) exits 0."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=repo, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "fenix_tpu_torch.examples.quickstart", "--device", "cpu"],
                         capture_output=True, text=True, cwd=repo, env=env, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "exact filtered top-5 ids" in out.stdout and "matches per group" in out.stdout, out.stdout
