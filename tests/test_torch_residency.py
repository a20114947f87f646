"""fenix_tpu_torch's host-corpus residency modes (int8-resident and
streaming) against the JAX package's on the same root, on the CPU.

Tolerances: ids exact; ``__DISTANCE__`` within rtol/atol 1e-5 (the two
packages take the fp32 scores in different summation orders; the host
rescore is the same numpy code in both). Windows and mirrors compare
exactly: window ids as sets, int8 codes and scales bit for bit.
"""

import hashlib
import os
import sys
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

import fenix_tpu
from fenix_tpu import expr as jexpr
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine import residency as jresidency
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu.ops import topk2 as jtopk2
from fenix_tpu.utils.metrics import GLOBAL as JMETRICS
from fenix_tpu_torch import expr
from fenix_tpu_torch.engine import executor, residency
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import batch, ingest, table
from fenix_tpu_torch.ops import topk2
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS
from tests.test_topk_adversarial import _tied_levels_corpus

torch.set_num_threads(2)

ROWS, DIM = 3 * 16384, 16  # three scan blocks: a 5 MB budget streams 3 chunks
STREAM_BUDGET = str(5 << 20)


def _make_root(path: str, vectors: np.ndarray, tags: "np.ndarray | None" = None) -> str:
    n = vectors.shape[0]
    table.make(
        path,
        "vec",
        pa.table(
            {
                "id": pa.array(np.arange(n, dtype=np.int64)),
                "tag": pa.array((np.arange(n) % 10 if tags is None else tags).astype(np.int64)),
                "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
            }
        ).to_reader(max_chunksize=16384),
    )
    return path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    rng = np.random.default_rng(7)
    vectors = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    return _make_root(str(tmp_path_factory.mktemp("residency")), vectors)


@pytest.fixture(scope="module")
def caches(root):
    """One cache per package over the module's root (single-device JAX)."""
    return DeviceCache(root, device="cpu"), JaxCache(root, mesh=None)


SMALL_ROWS = 4096  # one 4,096-row block: a window of all rows stays cheap at Q=100


@pytest.fixture(scope="module")
def small_caches(tmp_path_factory):
    rng = np.random.default_rng(11)
    path = _make_root(
        str(tmp_path_factory.mktemp("small")), rng.standard_normal((SMALL_ROWS, DIM)).astype(np.float32)
    )
    return (
        DeviceCache(path, block=SMALL_ROWS, device="cpu"),
        JaxCache(path, block=SMALL_ROWS, mesh=None),
    )


def _search_both(caches, **kw):
    port, jax = caches
    req = dict(source="vec", column="vector", **kw)
    got = executor.execute_search(port, executor.SearchRequest(**req))
    if req.get("filter") is not None:  # the same predicate, through the JSON wire form
        req["filter"] = jexpr.Expr.from_dict(req["filter"].to_dict())
    want = jexecutor.execute_search(jax, jexecutor.SearchRequest(**req))
    return got, want


def assert_tables_match(got: pa.Table, want: pa.Table) -> None:
    assert got.schema == want.schema
    for name in want.column_names:
        if name == "__DISTANCE__":
            np.testing.assert_allclose(
                got.column(name).to_numpy(), want.column(name).to_numpy(), rtol=1e-5, atol=1e-5
            )
        else:
            assert got.column(name).equals(want.column(name)), name


def _counter(name: str) -> tuple[float, float]:
    return METRICS.snapshot().get(name, 0.0), JMETRICS.snapshot().get(name, 0.0)


FILTER = expr.field("tag") < 7


# -- int8-resident ----------------------------------------------------------


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("q", [1, 3, 100])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_int8_resident_matches_jax(small_caches, metric, q, filtered):
    rng = np.random.default_rng(q)
    target = rng.standard_normal((q, DIM)).astype(np.float32)
    before = _counter("search.residency_int8")
    got, want = _search_both(
        small_caches, target=target, metric=metric, maxval=25, residency="int8",
        filter=FILTER if filtered else None, extra={"window": SMALL_ROWS},
    )
    after = _counter("search.residency_int8")
    assert after[0] == before[0] + 1 and after[1] == before[1] + 1
    assert got.num_rows == q * 25
    assert_tables_match(got, want)
    if filtered:
        assert (got.column("tag").to_numpy() < 7).all()


def test_auto_over_budget_routes_int8(caches, monkeypatch):
    target = np.random.default_rng(1).standard_normal((3, DIM)).astype(np.float32)
    dual, _ = _search_both(caches, target=target, metric="l2", maxval=25)
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(3 << 20))  # dual ≈ 3.9 MB, int8 ≈ 1.6 MB
    before = _counter("search.residency_int8")
    got, want = _search_both(caches, target=target, metric="l2", maxval=25, extra={"window": ROWS})
    after = _counter("search.residency_int8")
    assert after[0] == before[0] + 1 and after[1] == before[1] + 1
    assert_tables_match(got, want)
    assert got.column("id").equals(dual.column("id"))


# -- streaming --------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_stream_fp32_matches_jax(caches, monkeypatch, metric):
    target = np.random.default_rng(2).standard_normal((3, DIM)).astype(np.float32)
    monkeypatch.setenv("FENIX_HBM_BUDGET", STREAM_BUDGET)
    before = _counter("search.stream_chunks")
    got, want = _search_both(caches, target=target, metric=metric, maxval=25, residency="stream")
    after = _counter("search.stream_chunks")
    assert after[0] - before[0] == after[1] - before[1] == 3
    assert_tables_match(got, want)


@pytest.mark.parametrize("filtered", [False, True])
def test_stream_int8_matches_jax(caches, monkeypatch, filtered):
    target = np.random.default_rng(3).standard_normal((3, DIM)).astype(np.float32)
    monkeypatch.setenv("FENIX_HBM_BUDGET", STREAM_BUDGET)
    before = _counter("search.stream_chunks")
    got, want = _search_both(
        caches, target=target, metric="l2", maxval=25, residency="stream", precision="int8",
        filter=FILTER if filtered else None,
        extra={"window": ROWS},  # = the chunk: at 5 MB the int8 chunk holds the whole table
    )
    assert _counter("search.stream_chunks")[0] - before[0] == 1
    assert_tables_match(got, want)


@pytest.mark.parametrize(
    "mode", [("int8", "fp32"), ("stream", "fp32"), ("stream", "int8")], ids=["int8", "stream", "stream_int8"]
)
def test_fewer_valid_rows_than_k(caches, monkeypatch, mode):
    residency_mode, precision = mode
    monkeypatch.setenv("FENIX_HBM_BUDGET", STREAM_BUDGET)
    target = np.random.default_rng(4).standard_normal((2, DIM)).astype(np.float32)
    got, want = _search_both(
        caches, target=target, metric="dot", maxval=10, residency=residency_mode,
        precision=precision, filter=expr.field("id") < 3, extra={"window": ROWS},
    )
    # padding (+inf / −1) is dropped from the result rows: 3 per query
    assert got.num_rows == 2 * 3
    assert_tables_match(got, want)


# -- adversarial near-tie corpora (tests/test_topk_adversarial.py) -----------

MODES = [("int8", "fp32"), ("stream", "fp32"), ("stream", "int8")]


@pytest.fixture(scope="module")
def tied_roots(tmp_path_factory):
    roots = {}
    for metric in ("l2", "cosine", "dot"):
        corpus, query = _tied_levels_corpus(np.random.default_rng(0), metric)
        path = _make_root(str(tmp_path_factory.mktemp(f"tied_{metric}")), corpus)
        roots[metric] = ((DeviceCache(path, device="cpu"), JaxCache(path, mesh=None)), query)
    return roots


@pytest.mark.parametrize("mode", MODES, ids=["int8", "stream", "stream_int8"])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_tied_mass_matches_jax(tied_roots, monkeypatch, metric, mode):
    """Exact duplicates tied across far more buckets than the window:
    every mode returns the smallest ids, as the reference does."""
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(1 << 20))  # 16,384 × 32 streams in chunks
    cache_pair, query = tied_roots[metric]
    got, want = _search_both(
        cache_pair, target=query[None, :], metric=metric, maxval=16, residency=mode[0],
        precision=mode[1], extra={"window": 16384},
    )
    assert_tables_match(got, want)


@pytest.fixture(scope="module")
def near_tie_root(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = 32
    u = rng.standard_normal(d)
    u /= np.linalg.norm(u)
    corpus = (rng.standard_normal((16384, d)) * 0.05).astype(np.float32)
    ids = np.sort(rng.choice(16384, size=64, replace=False))
    scale = 2.0 * (1.0 - np.arange(64)[::-1] * 3e-6)  # true order reversed against bucket order
    corpus[ids] = (scale[:, None] * u[None, :]).astype(np.float32)
    path = _make_root(str(tmp_path_factory.mktemp("near_tie")), corpus)
    return (DeviceCache(path, device="cpu"), JaxCache(path, mesh=None)), u.astype(np.float32)


@pytest.mark.parametrize("q", [4, 256])
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("mode", MODES[:2], ids=["int8", "stream"])
def test_near_tied_maxima_match_jax(near_tie_root, monkeypatch, mode, metric, q):
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(1 << 20))
    cache_pair, u = near_tie_root
    queries = np.tile(u[None, :], (q, 1)) * (1.0 + np.arange(q, dtype=np.float32)[:, None] * 1e-3)
    # the default window (4,096 ≪ N): the int8 selection margin is under test
    got, want = _search_both(cache_pair, target=queries, metric=metric, maxval=16, residency=mode[0])
    assert_tables_match(got, want)


# -- stream against dual on phase 6's shape of rows --------------------------

DRAW_ROWS, DRAW_DIM, DRAW_DUP = 65_536, 64, 4096  # rows DUP..2·DUP−1 copy rows 0..DUP−1


def _drawn_rows(draw: str):
    """chip_smoke.py phase 6's kind of table at a small size: normal rows
    (numpy's generator, or torch's), duplicated rows, tags 0..99; with
    "planted", each query's source row also has 24 near copies (noise of
    1e-6, a few fp32 ulps) spread over every chunk, so their scores and
    distances tie up to fp32 rounding."""
    if draw == "torch":
        g = torch.Generator().manual_seed(7)
        vectors = torch.randn((DRAW_ROWS, DRAW_DIM), generator=g).numpy()
        tags = torch.randint(0, 100, (DRAW_ROWS,), generator=g).numpy()
    else:
        rng = np.random.default_rng(7)
        vectors = rng.standard_normal((DRAW_ROWS, DRAW_DIM), dtype=np.float32)
        tags = rng.integers(0, 100, DRAW_ROWS)
    vectors[DRAW_DUP : 2 * DRAW_DUP] = vectors[:DRAW_DUP]
    # sources whose both copies pass the filter, so exact ties reach each top-k
    pool = np.flatnonzero((tags[:DRAW_DUP] < 50) & (tags[DRAW_DUP : 2 * DRAW_DUP] < 50))[:4]
    if draw == "planted":
        rng = np.random.default_rng(8)
        slots = rng.choice(np.arange(2 * DRAW_DUP, DRAW_ROWS), size=(pool.size, 24), replace=False)
        for src, sl in zip(pool, slots):
            vectors[sl] = vectors[src] + (1e-6 * rng.standard_normal((24, DRAW_DIM))).astype(np.float32)
            tags[sl] = 0
    rng = np.random.default_rng(9)
    queries = rng.standard_normal((8, DRAW_DIM), dtype=np.float32)
    queries[: pool.size] = vectors[pool] + 0.05 * rng.standard_normal((pool.size, DRAW_DIM), dtype=np.float32)
    return vectors, tags, queries


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("draw", ["numpy", "torch", "planted"])
def test_stream_equals_dual_on_drawn_rows(tmp_path, monkeypatch, draw, metric):
    """The fp32 stream route (4 chunks) gives dual's answer position by
    position, in both the ids and the distances, on rows drawn by numpy,
    by torch's generator, and with near fp32 ties planted: each chunk is
    scored with the aux dual uses and the chunks merge by (score, id), the
    order of one pass over the table. Each mode returns the JAX package's
    ids: position by position on the drawn rows, as sets per query where
    ties are planted (the two packages sum the scores in different orders,
    which orders near ties otherwise). Distances are held to float64 within
    1e-5 · max(1, d): the JAX package's l2 distance is the expanded
    √(‖q‖² − s), which cancels for near rows (~1e-4 relative here)."""
    vectors, tags, queries = _drawn_rows(draw)
    path = _make_root(str(tmp_path / "drawn"), vectors, tags)
    pair = (DeviceCache(path, device="cpu"), JaxCache(path, mesh=None))
    kw = dict(target=queries, metric=metric, maxval=100, filter=expr.field("tag") < 50)
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(3 << 20))
    before = _counter("search.stream_chunks")[0]
    stream = _search_both(pair, residency="stream", **kw)
    assert _counter("search.stream_chunks")[0] - before == 4
    monkeypatch.delenv("FENIX_HBM_BUDGET")
    dual = _search_both(pair, residency="dual", **kw)

    def cols(t):
        ids = np.asarray(t.column("id")).reshape(queries.shape[0], 100)
        return ids, np.asarray(t.column("__DISTANCE__")).reshape(ids.shape)

    (s_ids, s_dist), (d_ids, d_dist) = cols(stream[0]), cols(dual[0])
    np.testing.assert_array_equal(s_ids, d_ids)
    np.testing.assert_array_equal(s_dist, d_dist)
    v64, q64 = vectors.astype(np.float64)[d_ids], queries.astype(np.float64)[:, None, :]
    if metric == "l2":
        truth = np.sqrt(np.sum(np.square(v64 - q64), axis=-1))
    else:
        truth = 0.5 - 0.5 * np.sum(v64 * q64, axis=-1) / (np.linalg.norm(v64, axis=-1) * np.linalg.norm(q64, axis=-1))
    assert np.all(np.abs(d_dist - truth) <= 1e-5 * np.maximum(1.0, truth))
    for got, want in (stream, dual):
        g_ids, w_ids = cols(got)[0], cols(want)[0]
        if draw == "planted":
            g_ids, w_ids = np.sort(g_ids, axis=1), np.sort(w_ids, axis=1)
        np.testing.assert_array_equal(g_ids, w_ids)


# -- the window op -------------------------------------------------------------


def _window_both(v, queries, mask, k, w, metric):
    """topk_window_int8 of both packages on the same numpy inputs."""
    v8, sv = topk2.quantize_rows_int8_np(v)
    mul, add = (np.asarray(a) for a in jtopk2.prepare_aux(v, mask, metric))
    want = np.asarray(jtopk2.topk_window_int8(v8, sv, queries, mul, add, k=k, w=w, metric=metric))
    t = torch.from_numpy
    got = topk2.topk_window_int8(t(v8), t(sv), t(queries), t(mul), t(add), k=k, w=w, metric=metric)
    return got.numpy(), want


@pytest.mark.parametrize("q", [3, 100])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_topk_window_int8_matches_jax(rng, metric, q):
    n, d = 4096, 32
    v = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    mask = rng.random(n) < 0.8
    # W ≥ N: every candidate row is in both windows
    got, want = _window_both(v, queries, mask, 16, n, metric)
    assert got.shape == want.shape
    for g, w in zip(got, want):
        assert set(g.tolist()) == set(w.tolist())
    # W < N on distinct scores: the same top-W rows
    got, want = _window_both(v, queries, mask, 16, 300, metric)
    assert got.shape == want.shape == (q, 300)
    for g, w in zip(got, want):
        assert set(g.tolist()) == set(w.tolist())


def test_quantize_rows_int8_np_is_the_reference(rng):
    block = rng.standard_normal((257, 48)).astype(np.float32) * 3.0
    block[5] = 0.0  # the 1e-30 floor
    got8, got_s = topk2.quantize_rows_int8_np(block)
    want8, want_s = jtopk2.quantize_rows_int8_np(block)
    assert got8.tobytes() == want8.tobytes() and got_s.tobytes() == want_s.tobytes()


# -- planning ----------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_plan_matches_jax(caches, monkeypatch, precision):
    port, jax = caches
    target = np.zeros((1, DIM), np.float32)
    for budget in (1 << 18, 1 << 20, 2 << 20, 3 << 20, 4 << 20, 5 << 20, 8 << 20, 1 << 30):
        monkeypatch.setenv("FENIX_HBM_BUDGET", str(budget))
        for maxval in (10, None):
            for forced in ("auto", "dual", "int8", "stream"):
                kw = dict(source="vec", column="vector", target=target, metric="l2",
                          maxval=maxval, precision=precision, residency=forced)
                assert residency.plan(port, executor.SearchRequest(**kw)) == jresidency.plan(
                    jax, jexecutor.SearchRequest(**kw)
                ), (budget, maxval, forced)
    monkeypatch.delenv("FENIX_HBM_BUDGET")
    req = executor.SearchRequest("vec", "vector", target, metric="l2", maxval=5)
    assert residency.plan(port, req) == "dual"  # a CPU device reports no budget


# -- the host int8 mirror and its sidecar ----------------------------------------------


def _sidecar_dir(root: str) -> str:
    return os.path.join(table.int8cache_dir(root, "vec"), hashlib.sha1(b"vector").hexdigest()[:16])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_int8_sidecar_is_shared_both_ways(tmp_path, writer):
    rng = np.random.default_rng(5)
    root = _make_root(str(tmp_path), rng.standard_normal((20_000, DIM)).astype(np.float32))
    port, jax = DeviceCache(root, device="cpu"), JaxCache(root, mesh=None)
    first, second = (jax, port) if writer == "jax" else (port, jax)
    w0 = _counter("cache.int8_sidecar_writes")
    codes, scales = first.host_int8("vec", "vector")
    assert os.path.isfile(os.path.join(_sidecar_dir(root), "meta.json"))
    l0 = _counter("cache.int8_sidecar_loads")
    codes2, scales2 = second.host_int8("vec", "vector")
    loads, writes = _counter("cache.int8_sidecar_loads"), _counter("cache.int8_sidecar_writes")
    reader_i = 0 if writer == "jax" else 1
    assert loads[reader_i] == l0[reader_i] + 1  # loaded, not rebuilt
    assert writes[1 - reader_i] == w0[1 - reader_i] + 1 and writes[reader_i] == w0[reader_i]
    assert isinstance(codes2, np.memmap)
    assert np.asarray(codes2).tobytes() == np.asarray(codes).tobytes()
    assert np.asarray(scales2).tobytes() == np.asarray(scales).tobytes()


def test_int8_sidecar_restart_and_invalidation(tmp_path):
    rng = np.random.default_rng(6)
    root = _make_root(str(tmp_path), rng.standard_normal((5_000, DIM)).astype(np.float32))
    codes, _ = DeviceCache(root, device="cpu").host_int8("vec", "vector")
    l0 = _counter("cache.int8_sidecar_loads")[0]
    assert np.array_equal(DeviceCache(root, device="cpu").host_int8("vec", "vector")[0], codes)
    assert _counter("cache.int8_sidecar_loads")[0] == l0 + 1
    # a new revision rebuilds; a corrupt file rebuilds; a drop removes it
    _make_root(root, rng.standard_normal((300, DIM)).astype(np.float32))
    assert DeviceCache(root, device="cpu").host_int8("vec", "vector")[0].shape == (300, DIM)
    with open(os.path.join(_sidecar_dir(root), "codes.npy"), "wb") as fh:
        fh.write(b"not a npy")
    w0 = _counter("cache.int8_sidecar_writes")[0]
    assert DeviceCache(root, device="cpu").host_int8("vec", "vector")[0].shape == (300, DIM)
    assert _counter("cache.int8_sidecar_writes")[0] == w0 + 1
    table.drop(root, "vec")
    assert not os.path.exists(_sidecar_dir(root))


def test_host_int8_concurrent_callers_build_once(tmp_path):
    root = _make_root(str(tmp_path), np.random.default_rng(8).standard_normal((8_000, DIM)).astype(np.float32))
    cache = DeviceCache(root, device="cpu")
    w0 = _counter("cache.int8_sidecar_writes")[0]
    out, errs = [], []

    def go():
        try:
            out.append(cache.host_int8("vec", "vector"))
        except Exception as e:  # surfaced by the assert below
            errs.append(e)

    threads = [threading.Thread(target=go) for _ in range(6)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the callers finely
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errs and len(out) == 6
    assert all(o[0] is out[0][0] for o in out)
    assert _counter("cache.int8_sidecar_writes")[0] == w0 + 1


def test_int8_route_builds_no_device_fp32(root):
    cache = DeviceCache(root, device="cpu")
    target = np.random.default_rng(9).standard_normal((2, DIM)).astype(np.float32)
    executor.execute_search(
        cache,
        executor.SearchRequest("vec", "vector", target, metric="l2", maxval=5, residency="int8"),
    )
    kinds = cache.device_entry_kinds()
    assert "matrix" not in kinds and kinds["int8_solo"] == 1, kinds
    v8, sv = cache.int8_solo("vec", "vector")
    aux = cache.int8_solo_aux("vec", "vector", "l2")
    assert cache.device_bytes() == v8.data.numel() + 4 * sv.data.numel() + 8 * aux[0].numel()


# -- end to end over Flight --------------------------------------------------------------


def test_flight_serves_oversized_table_end_to_end(root, monkeypatch):
    import fenix_tpu_torch

    monkeypatch.setenv("FENIX_HBM_BUDGET", str(1 << 20))  # under even the int8 copy: auto streams
    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    try:
        client = fenix_tpu.Flight(host="127.0.0.1", port=server.port)  # the unchanged client
        target = np.random.default_rng(10).standard_normal(DIM).astype(np.float32)
        host = ingest.fixed_size_list_to_numpy(table.load(root, "vec").column("vector"))
        sel = np.nonzero(np.arange(ROWS) % 10 == 3)[0]
        d = np.sqrt(((host[sel] - target) ** 2).sum(1))
        want = sel[np.lexsort((sel, d))][:20]

        before = client.stats()
        for name in ("search.residency_int8", "search.residency_stream", "search.stream_chunks",
                     "cache.int8_sidecar_loads", "cache.int8_sidecar_writes"):
            assert name in before  # the reference's counters, shown from the start
        out = client.search(target, "vec", "vector", metric="l2", maxval=20,
                            filter=jexpr.field("tag") == 3)
        assert np.array_equal(np.asarray(out.column("id")), want)
        stats = client.stats()
        assert stats["search.residency_stream"] == before.get("search.residency_stream", 0) + 1
        assert stats["search.stream_chunks"] > before.get("search.stream_chunks", 0)

        out = client.search(target, "vec", "vector", metric="l2", maxval=20,
                            filter=jexpr.field("tag") == 3, residency="int8",
                            extra={"window": ROWS})
        assert np.array_equal(np.asarray(out.column("id")), want)
        stats = client.stats()
        assert stats["search.residency_int8"] == before.get("search.residency_int8", 0) + 1
        assert stats.get("cache.device_entries.matrix", 0) == 0
        assert stats["cache.device_bytes"] <= 1 << 20  # the LRU keeps the budget
        client.close()
    finally:
        server.shutdown()


# -- the prefetch pipeline ---------------------------------------------------------------


def test_prefetch_keeps_order_on_cpu():
    items = [(np.full((4, 3), i, np.float32), np.arange(4) + i) for i in range(5)]
    got = list(batch.prefetch_to_device(iter(items), "cpu"))
    assert len(got) == 5
    for i, (a, b) in enumerate(got):
        assert a.device.type == "cpu" and (a == i).all() and torch.equal(b, torch.arange(4) + i)


def test_prefetch_propagates_producer_errors():
    def items():
        yield (np.zeros(3, np.float32),)
        raise RuntimeError("chunk assembly failed")

    it = batch.prefetch_to_device(items(), "cpu")
    assert next(it)[0].shape == (3,)
    with pytest.raises(RuntimeError, match="chunk assembly failed"):
        next(it)


def test_prefetch_refuses_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        next(batch.prefetch_to_device(iter([(np.zeros(1),)]), "meta"))


@pytest.mark.cuda
def test_prefetch_on_the_card_keeps_order():
    """The pinned double-buffered path; runs only where a card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    items = [(np.full((1024, 64), i, np.float32), np.arange(1024, dtype=np.int64) + i) for i in range(6)]
    got = [tuple(t.cpu() for t in ts) for ts in batch.prefetch_to_device(iter(items), "cuda")]
    for i, (a, b) in enumerate(got):
        assert (a == i).all() and torch.equal(b, torch.arange(1024) + i)

    def failing():
        yield items[0]
        raise RuntimeError("chunk assembly failed")

    with pytest.raises(RuntimeError, match="chunk assembly failed"):
        for _ in batch.prefetch_to_device(failing(), "cuda"):
            pass
