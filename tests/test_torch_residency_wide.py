"""The int8-resident route at 1,536 dimensions (VectorDBBench's
Performance1536D500K width) through the port's Flight server, on the CPU.

Each answer is held to a plain float64 top-k written here (torch
float64, no kernel of the port): ids in (distance, id) order, rank for
rank, except where two float64 distances lie within ``TIE`` (fp32 sums
over 1,536 terms cannot order them), and served distances within 1e-5 of
the served rows' float64 ones. Q = 1, 64 and 256 take both bucket sizes
of phase A (``topk2.bucket_for``); a ``tag`` filter folds into the aux as
−inf on the card and is applied again in the host rescore.

The window is cut to ``WINDOW`` rows and the narrowing's gather cap to
``GATHER_CAP`` so that the CPU's temporaries stay small: the narrowing
then runs in chunks, and the host gathers Q × ``WINDOW`` rows of 6 KB.
"""

import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

import fenix_tpu_torch
from fenix_tpu_torch import expr
from fenix_tpu_torch.engine import batching, executor, residency
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.ops import topk2
from fenix_tpu_torch.utils import profiling
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

torch.set_num_threads(2)

ROWS, DIM, K = 8192, 1536, 100
CENTERS, NOISE = 64, 0.75  # a Gaussian mixture, as the benchmark's corpus
WINDOW = 512
GATHER_CAP = 64 << 20
TIE = 1e-6  # float64 distances this close may rank either way in fp32
TAG = expr.field("tag") < 50


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(1536)
    centers = rng.standard_normal((CENTERS, DIM)).astype(np.float32)
    vectors = centers[rng.integers(0, CENTERS, ROWS)] + NOISE * rng.standard_normal((ROWS, DIM), np.float32)
    tags = rng.integers(0, 100, ROWS).astype(np.int32)
    root = str(tmp_path_factory.mktemp("wide"))
    table.make(root, "wide", pa.table({
        "id": pa.array(np.arange(ROWS, dtype=np.int64)),
        "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
        "tag": pa.array(tags),
    }).to_reader(max_chunksize=4096))
    queries = centers[rng.integers(0, CENTERS, 512)] + NOISE * rng.standard_normal((512, DIM), np.float32)
    return root, vectors, tags, queries


@pytest.fixture(scope="module")
def small_work():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FENIX_RESCORE_WINDOW", str(WINDOW))
        mp.setattr(topk2, "_RESCORE_GATHER_CAP", GATHER_CAP)
        yield


@pytest.fixture(scope="module")
def client(corpus, small_work):
    server = fenix_tpu_torch.Server(corpus[0], host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    conn = fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port)
    try:
        yield conn
    finally:
        conn.close()
        server.shutdown()


def reference(vectors: np.ndarray, queries: np.ndarray, keep: "np.ndarray | None", k: int):
    """Float64 cosine distances ``[Q, N]`` (excluded rows at +inf) and the
    top-``k`` ids and distances in (distance, id) order."""
    v = torch.from_numpy(vectors).double()
    q = torch.from_numpy(queries).double()
    d = 0.5 - 0.5 * (q / q.norm(dim=1, keepdim=True)) @ (v / v.norm(dim=1, keepdim=True)).T
    if keep is not None:
        d[:, ~torch.from_numpy(keep)] = torch.inf
    top_d, top_i = torch.sort(d, dim=1, stable=True)  # ties in id order
    return d.numpy(), top_i[:, :k].numpy(), top_d[:, :k].numpy()


def split(result: pa.Table, q: int) -> tuple[list, list]:
    ids = result.column("id").to_numpy()
    dist = result.column(executor.DIST_COL).to_numpy()
    qid = result.column(executor.QUERY_COL).to_numpy() if executor.QUERY_COL in result.column_names else \
        np.zeros(len(ids), np.int64)
    assert (np.diff(qid) >= 0).all()
    return [ids[qid == i] for i in range(q)], [dist[qid == i] for i in range(q)]


def assert_exact(result: pa.Table, vectors, queries, keep, k: int = K) -> None:
    d64, want_i, want_d = reference(vectors, queries, keep, k + 1)
    ids, dists = split(result, queries.shape[0])
    for i, (got, dist) in enumerate(zip(ids, dists)):
        assert len(got) == k and len(set(got.tolist())) == k
        true = d64[i, got]
        np.testing.assert_allclose(dist, true, rtol=0, atol=1e-5)
        # served in the port's (distance, id) order
        assert np.all((np.diff(dist) > 0) | ((np.diff(dist) == 0) & (np.diff(got) > 0)))
        # the float64 top-k rank for rank; rows swap only within a tie
        assert np.all(np.abs(true - want_d[i, :k]) <= TIE)
        gaps = np.diff(want_d[i]) <= TIE  # rank r to r + 1, the (k+1)-th row included
        tied = gaps[:k].copy()
        tied[1:] |= gaps[: k - 1]
        assert np.array_equal(got[~tied], want_i[i, :k][~tied])


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "tag_lt_50"])
@pytest.mark.parametrize("q", [1, 64, 256])
def test_int8_resident_through_flight(client, corpus, q, filtered):
    _, vectors, tags, queries = corpus
    target = queries[0] if q == 1 else queries[:q]
    before = client.stats()
    out = client.search(target, "wide", "vector", metric="cosine", maxval=K, select=["id"],
                        filter=TAG if filtered else None, precision="int8", residency="int8")
    after = client.stats()
    assert after["search.residency_int8"] == before["search.residency_int8"] + 1
    assert after["batch.dispatches"] == before["batch.dispatches"] + 1
    assert after.get("cache.device_entries.matrix", 0) == 0  # no device fp32
    assert_exact(out, vectors, queries[:q], tags < 50 if filtered else None)


def test_rescore_counters(client, corpus):
    """``residency.rescore_rows`` is Q × window; the gather and score
    seconds add up to the rescore's."""
    queries = corpus[3][:64]
    before = client.stats()
    client.search(queries, "wide", "vector", metric="cosine", maxval=K, precision="int8", residency="int8")
    after = client.stats()
    delta = {n: after.get(n, 0.0) - before.get(n, 0.0) for n in after}
    assert delta["residency.rescore_rows"] == 64 * WINDOW
    assert delta["residency.rescore_gather_seconds"] > 0 and delta["residency.rescore_score_seconds"] > 0
    assert delta["residency.rescore_gather_seconds"] + delta["residency.rescore_score_seconds"] == \
        pytest.approx(delta["residency.rescore_seconds"], rel=1e-9, abs=1e-12)
    assert delta["residency.phase_a_seconds"] > 0
    assert "residency.phase_a_device_seconds" not in delta  # a card's events, under a capture


def test_spans_on_the_dispatcher_under_a_capture(client, corpus):
    """While a capture runs on another thread, the dispatcher records the
    host-corpus branch and the route's spans, each inside its parent."""
    queries = corpus[3][:8]
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
        client.search(queries, "wide", "vector", metric="cosine", maxval=K, precision="int8", residency="int8")
    finally:
        stop.set()
        capture.join(60)
    got = profiling.spans(t0)
    by_name: dict[str, list] = {}
    for s in got:
        by_name.setdefault(s.name, []).append(s)
    (dispatch,) = by_name["batch.dispatch"]
    (branch,) = by_name["executor.host_corpus"]
    (route,) = by_name["residency.int8"]
    (phase_a,) = by_name["residency.phase_a"]
    (rescore,) = by_name["residency.rescore"]
    (gather,) = by_name["residency.gather"]  # one query block
    (score,) = by_name["residency.score"]
    assert dispatch.thread == "fenix-search-batcher"
    for child, parent in ((branch, dispatch), (route, branch), (phase_a, route), (rescore, route),
                          (gather, rescore), (score, rescore)):
        assert child.parent == parent.id and child.tid == dispatch.tid
        assert parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns
    assert phase_a.end_ns <= rescore.start_ns and gather.end_ns <= score.start_ns


def test_concurrent_requests_share_one_pass(corpus, small_work):
    """Requests queued together are one ``residency.execute_many`` call,
    and each member's table equals its solo answer."""
    root, vectors, _, queries = corpus
    cache = DeviceCache(root, device="cpu")
    batcher = batching.SearchBatcher(cache)
    sizes = (1, 7, 32, 64)
    starts = np.cumsum((0,) + sizes)
    reqs = [executor.SearchRequest("wide", "vector", queries[a] if n == 1 else queries[a : a + n], metric="cosine",
                                   maxval=K, precision="int8", residency="int8")
            for a, n in zip(starts, sizes)]
    solo = [executor.execute_search(cache, r) for r in reqs]

    calls, gate = [], threading.Event()
    real = residency.execute_many

    def held(cache_, group, mode):
        calls.append(len(group))
        if len(calls) == 1:
            gate.wait(60)  # the first (blocking) dispatch holds the others in the queue
        return real(cache_, group, mode)

    results: list = [None] * (len(reqs) + 1)

    def submit(i, req):
        results[i] = batcher.submit(req)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(residency, "execute_many", held)
        threads = [threading.Thread(target=submit, args=(0, reqs[0]))]
        threads[0].start()
        deadline = time.monotonic() + 60
        while not calls:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        threads += [threading.Thread(target=submit, args=(i + 1, r)) for i, r in enumerate(reqs)]
        for t in threads[1:]:
            t.start()
        while len(batcher._queue) < len(reqs):
            assert time.monotonic() < deadline
            time.sleep(0.005)
        before = METRICS.snapshot().get("search.residency_int8", 0)
        gate.set()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    assert calls == [1, len(reqs)]
    assert METRICS.snapshot()["search.residency_int8"] == before + 2
    assert results[0] == solo[0]
    for got, want, req in zip(results[1:], solo, reqs):
        assert got == want
        assert_exact(got, vectors, np.atleast_2d(req.target), None)


def test_rescore_scratch_is_held_by_one_call(corpus):
    """The host rescore answers alike into its kept buffer and into fresh
    ones (while another call holds the buffer), and calls on many threads
    at once each rescore their own rows."""
    _, vectors, _, queries = corpus
    rng = np.random.default_rng(5)
    mul = (1.0 / np.linalg.norm(vectors, axis=1)).astype(np.float32)
    add = np.zeros(ROWS, np.float32)
    wins = [rng.integers(-1, ROWS, (16, WINDOW)) for _ in range(8)]  # -1: an invalid slot

    def rescore(i):
        return residency._host_rescore_topk(vectors, mul, add, None, queries[16 * i : 16 * (i + 1)], wins[i],
                                            ROWS, K, "cosine")

    kept = rescore(0)
    assert residency._SCRATCH._buf.size >= 16 * WINDOW * DIM
    with residency._SCRATCH.lend() as other:
        assert other is not None
        fresh = rescore(0)
    for a, b in zip(kept, fresh):
        np.testing.assert_array_equal(a, b)

    want = [rescore(i) for i in range(len(wins))]
    got: list = [None] * len(wins)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, rescore(i))) for i in range(len(wins))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
