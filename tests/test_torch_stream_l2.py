"""The fp32 stream residency at 768 dimensions and l2 (VectorDBBench's
LAION width and metric) through the port's Flight server.

The table (5,000 rows) is served by a cache whose row block is
``BLOCK`` rows, so a budget of ``CHUNKED_BUDGET`` streams it in five
chunks and no budget in one. Q = 1 and 64 take the ``stream`` design's
twin and Q = 128 the ``tiled`` one's (``kernels.STREAM_MAX_Q``); a
``tag`` filter folds into each chunk's aux as −inf.

Coordinates are small integers, so every fp32 sum the port makes is
exact whatever its order: the float64 top-k in (distance, id) order,
computed here in plain torch (no kernel of the port, no JAX), is the
only right answer, and the ids are held to it position by position,
exact ties broken by id within and across chunks. Distances are held
within the residency tests' l2 tolerance, 1e-5 · max(1, d).
"""

import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

import fenix_tpu_torch
from fenix_tpu_torch import expr
from fenix_tpu_torch.engine import executor, residency
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.ops import kernels
from fenix_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROWS, DIM, K = 5000, 768, 100
BLOCK = 1024  # the cache's row block: 5,000 rows pad to 5 blocks
CHUNKED_BUDGET = 16_000_000  # bytes: chunks of one block (``residency._stream_chunk_rows``)
CHUNKS = {1: None, 5: CHUNKED_BUDGET}  # chunks a request → the budget that gives them
CHUNK_ROWS = {1: 5 * BLOCK, 5: BLOCK}
TAG = expr.field("tag") < 50


def _grid(rng, n: int, centers: np.ndarray) -> np.ndarray:
    """Rows of a mixture on the integer grid: a center plus integer noise
    in [-10, 10]; every |coordinate| <= 30, so squared norms, products and
    their sums over 768 terms stay below 2**24 and are exact in fp32."""
    return (centers[rng.integers(0, centers.shape[0], n)] + rng.integers(-10, 11, (n, DIM))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(768)
    centers = rng.integers(-20, 21, (16, DIM))
    vectors = _grid(rng, ROWS, centers)
    tags = rng.integers(0, 100, ROWS).astype(np.int32)
    root = str(tmp_path_factory.mktemp("stream_l2"))
    table.make(root, "laion", pa.table({
        "id": pa.array(np.arange(ROWS, dtype=np.int64)),
        "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
        "tag": pa.array(tags),
    }).to_reader(max_chunksize=2048))
    return root, vectors, tags, _grid(rng, 128, centers)


def _serve(root: str, device: str):
    """A server whose cache has ``BLOCK``-row blocks (placed where the
    server looks its cache up), and a client of it."""
    key = (os.path.abspath(root), str(torch.device(device)))
    executor._CACHES[key] = DeviceCache(key[0], device=device, block=BLOCK)
    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device=device)
    threading.Thread(target=server.serve, daemon=True).start()
    return server, fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port), key


@pytest.fixture(scope="module")
def client(corpus):
    server, conn, key = _serve(corpus[0], "cpu")
    try:
        yield conn
    finally:
        conn.close()
        server.shutdown()
        executor._CACHES.pop(key, None)


def reference(vectors: np.ndarray, queries: np.ndarray, keep: "np.ndarray | None", k: int = K):
    """Float64 l2 top-``k`` ids and distances of each query, in (distance,
    id) order, excluded rows never."""
    v = torch.from_numpy(vectors).double()
    q = torch.from_numpy(queries).double()
    d = torch.cdist(q, v)
    if keep is not None:
        d[:, ~torch.from_numpy(keep)] = torch.inf
    top_d, top_i = torch.sort(d, dim=1, stable=True)  # ties in id order
    return top_i[:, :k].numpy(), top_d[:, :k].numpy()


def assert_exact(result: pa.Table, vectors, queries, keep) -> None:
    want_i, want_d = reference(vectors, queries, keep)
    ids = result.column("id").to_numpy()
    dist = result.column(executor.DIST_COL).to_numpy()
    q = queries.shape[0]
    qid = result.column(executor.QUERY_COL).to_numpy() if executor.QUERY_COL in result.column_names else \
        np.zeros(len(ids), np.int64)
    assert np.array_equal(qid, np.repeat(np.arange(q), K))
    np.testing.assert_array_equal(ids.reshape(q, K), want_i)
    assert np.all(np.abs(dist.reshape(q, K) - want_d) <= 1e-5 * np.maximum(1.0, want_d))


def _search(client, queries, filtered: bool, precision: str = "fp32") -> pa.Table:
    return client.search(queries[0] if queries.shape[0] == 1 else queries, "laion", "vector", metric="l2",
                         maxval=K, select=["id"], filter=TAG if filtered else None, precision=precision,
                         residency="stream")


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "tag_lt_50"])
@pytest.mark.parametrize("q", [1, 64, 128])
@pytest.mark.parametrize("chunks", [1, 5])
def test_stream_l2_through_flight(client, corpus, monkeypatch, chunks, q, filtered):
    _, vectors, tags, queries = corpus
    if CHUNKS[chunks] is None:
        monkeypatch.delenv("FENIX_HBM_BUDGET", raising=False)
    else:
        monkeypatch.setenv("FENIX_HBM_BUDGET", str(CHUNKS[chunks]))
    assert kernels.kernel_for(torch.float32, q, DIM) == ("stream" if q <= kernels.STREAM_MAX_Q else "tiled")
    before = client.stats()
    out = _search(client, queries[:q], filtered)
    after = client.stats()
    delta = {n: after.get(n, 0.0) - before.get(n, 0.0) for n in after}
    assert delta["search.residency_stream"] == delta["batch.dispatches"] == 1
    assert delta["search.stream_chunks"] == chunks
    assert delta["residency.stream_rows"] == chunks * CHUNK_ROWS[chunks]
    assert after.get("cache.device_entries.matrix", 0) == 0  # the column stays on the host
    assert_exact(out, vectors, queries[:q], tags < 50 if filtered else None)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("chunks", [1, 5])
def test_stream_stages_the_ragged_tail_as_one_padded_item(client, corpus, monkeypatch, chunks, precision):
    """A request's one ragged chunk is the one item whose pad rows the
    stager writes (5,000 rows: the tail of 5,120 or of 1,024-row chunks
    for fp32, of 4,096-row chunks for int8 under the budget), and the
    answers of both precisions stay exact."""
    _, vectors, tags, queries = corpus
    if CHUNKS[chunks] is None:
        monkeypatch.delenv("FENIX_HBM_BUDGET", raising=False)
    else:
        monkeypatch.setenv("FENIX_HBM_BUDGET", str(CHUNKS[chunks]))
    before = client.stats()
    out = _search(client, queries[:64], True, precision)
    after = client.stats()
    delta = {n: after.get(n, 0.0) - before.get(n, 0.0) for n in after}
    assert delta["transfer.padded_items"] == 1
    assert delta["transfer.pad_rows"] == delta["residency.stream_rows"] - ROWS
    assert delta["transfer.pad_rows"] == {("fp32", 1): 120, ("fp32", 5): 120,
                                          ("int8", 1): 120, ("int8", 5): 3192}[precision, chunks]
    assert_exact(out, vectors, queries[:64], tags < 50)


def test_stream_counters_split_the_route(client, corpus, monkeypatch):
    """Each chunk's scan is timed once, into the stream's counter and into
    ``residency.phase_a_seconds`` alike; the merge apart; no card, no
    device timer."""
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(CHUNKED_BUDGET))
    before = client.stats()
    _search(client, corpus[3][:64], False)
    after = client.stats()
    delta = {n: after.get(n, 0.0) - before.get(n, 0.0) for n in after}
    assert delta["residency.stream_scan_seconds"] > 0 and delta["residency.stream_merge_seconds"] > 0
    assert delta["residency.stream_scan_seconds"] == pytest.approx(delta["residency.phase_a_seconds"], rel=1e-9)
    assert "residency.stream_device_seconds" not in after  # a card's events, under a capture


def _captured(fn) -> dict[str, list]:
    """The spans recorded while ``fn`` runs under a capture held on
    another thread."""
    t0 = time.time_ns()
    up, stop = threading.Event(), threading.Event()

    def hold():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            up.set()
            stop.wait(60)

    capture = threading.Thread(target=hold, name="capture")
    capture.start()
    try:
        assert up.wait(60)
        fn()
    finally:
        stop.set()
        capture.join(60)
    by_name: dict[str, list] = {}
    for s in profiling.spans(t0):
        by_name.setdefault(s.name, []).append(s)
    return by_name


def _inside(child, parent) -> bool:
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_stream_spans_on_the_dispatcher_under_a_capture(client, corpus, monkeypatch):
    """The dispatcher records the stream route inside the host-corpus
    branch: one scan a chunk, then the merge, each inside the route."""
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(CHUNKED_BUDGET))
    by_name = _captured(lambda: _search(client, corpus[3][:8], True))
    (dispatch,) = by_name["batch.dispatch"]
    (branch,) = by_name["executor.host_corpus"]
    (route,) = by_name["residency.stream"]
    (merge,) = by_name["residency.stream_merge"]
    scans = by_name["residency.stream_scan"]
    assert len(scans) == 5 and dispatch.thread == "fenix-search-batcher"
    for child, parent in ((branch, dispatch), (route, branch), (merge, route), *((s, route) for s in scans)):
        assert child.parent == parent.id and child.tid == dispatch.tid and _inside(child, parent)
    assert max(s.end_ns for s in scans) <= merge.start_ns
    assert "transfer.stage" not in by_name  # a CPU device stages nothing


@pytest.mark.cuda
def test_stream_on_the_card_stages_on_the_worker(corpus, monkeypatch):
    """On a card: the answers, the pinned staging on the prefetch worker
    and the consumer's waits as spans inside the route, the uploads'
    bytes, and the chunks' searches timed by CUDA events under a
    capture; the int8 stream likewise, its one rescore inside the merge
    (each chunk's 4,096-row window holds the whole chunk, so it is exact
    too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root, vectors, tags, queries = corpus
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(CHUNKED_BUDGET))
    server, conn, key = _serve(root, "cuda")
    try:
        assert_exact(_search(conn, queries, False), vectors, queries, None)  # tiled at Q = 128
        assert_exact(_search(conn, queries[:8], True), vectors, queries[:8], tags < 50)  # stream
        before = conn.stats()
        got = {}
        by_name = _captured(lambda: got.setdefault("out", _search(conn, queries, False)))
        after = conn.stats()
        int8_spans = _captured(lambda: got.setdefault("int8", _search(conn, queries, True, "int8")))
        last = conn.stats()
    finally:
        conn.close()
        server.shutdown()
        executor._CACHES.pop(key, None)
    assert_exact(got["out"], vectors, queries, None)
    delta = {n: after.get(n, 0.0) - before.get(n, 0.0) for n in after}
    assert delta["transfer.h2d_bytes"] == 5 * BLOCK * (DIM + 2) * 4  # the rows, aux_mul and aux_add
    assert delta["transfer.h2d_seconds"] > 0 and delta["transfer.stage_seconds"] > 0
    assert delta["transfer.padded_items"] == 1 and delta["transfer.pad_rows"] == 5 * BLOCK - ROWS
    assert delta[residency.STREAM_DEVICE_COUNTER] > 0
    assert delta["kernel.bucket_scores.kernel.tiled.launches"] == 5
    (route,) = by_name["residency.stream"]
    stages, waits = by_name["transfer.stage"], by_name["transfer.wait"]
    assert len(stages) == 5 and all(s.tid != route.tid and _inside(s, route) for s in stages)
    assert waits and all(w.tid == route.tid and w.parent == route.id for w in waits)
    assert_exact(got["int8"], vectors, queries, tags < 50)
    assert last[residency.STREAM_DEVICE_COUNTER] > after[residency.STREAM_DEVICE_COUNTER]
    (merge,) = int8_spans["residency.stream_merge"]
    (rescore,) = int8_spans["residency.rescore"]
    chunks = last["search.stream_chunks"] - after["search.stream_chunks"]
    assert chunks == 2  # int8 rows take a quarter of the bytes: chunks of 4 blocks
    assert rescore.parent == merge.id and len(int8_spans["transfer.stage"]) == chunks
