"""fenix_tpu_torch's table mutations against the JAX package, on the CPU.

Appends, deletes, upserts and compactions on one catalog root, the two
packages' device caches refreshing side by side: the port's matrix grows
by an append's rows and shrinks by the keep-mask lineage where the JAX
package's does (the same counters move), and every search equals the JAX
package's answer and a cold cache's. The host int8 mirror refreshes in
O(delta) and its sidecar reads both ways; the index files after each
mutation hold the JAX package's cell ids; and the Flight verbs are
driven through the unchanged JAX client against the port's server.

Tolerances: ids, codes, cell ids and counters exact; distances within
rtol/atol 1e-5 of the JAX package's (l2 at D=16, where the two l2 forms
agree far inside that).
"""

import concurrent.futures
import os
import shutil
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

import fenix_tpu
import fenix_tpu_torch
from fenix_tpu import coder as jcoder
from fenix_tpu import expr as jexpr
from fenix_tpu import index as jindex
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu.io import table as jtable
from fenix_tpu.utils.metrics import GLOBAL as JMETRICS
from fenix_tpu_torch import coder, expr, index
from fenix_tpu_torch.engine import executor
from fenix_tpu_torch.engine.session import DeviceCache, _npy_append_rows
from fenix_tpu_torch.io import arrow, ingest, table
from fenix_tpu_torch.ops import topk2
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

torch.set_num_threads(2)

DIM = 16
IVF = {"metric": "l2", "codebook_size": 8, "num_codebooks": 1, "batch_size": 128, "num_epochs": 1}


def _tbl(ids: np.ndarray, vecs: np.ndarray, tags: "np.ndarray | None" = None) -> pa.Table:
    cols = {"id": pa.array(ids), "vector": ingest.numpy_to_fixed_size_list(vecs.astype(np.float32), pa.float32())}
    if tags is not None:
        cols["tag"] = pa.array(tags)
    return pa.table(cols)


def _caches(root: str, block: int):
    return JaxCache(root, block=block, mesh=None), DeviceCache(root, block=block, device="cpu")


def _search(cache, target, maxval=3, **kw):
    module = executor if isinstance(cache, DeviceCache) else jexecutor
    req = module.SearchRequest(source="t", column="vector", target=target, metric="l2", maxval=maxval, **kw)
    return module.execute_search(cache, req)


def _assert_same(got: pa.Table, want: pa.Table, target: np.ndarray, ordered: bool = True) -> None:
    """``got`` (the port's) against ``want``: the same ids, in the same
    order unless ``ordered`` is False (then per query as a set, for a long
    result whose far rows tie within fp32); the port's distances within
    1e-5 · max(1, d) of float64 over the returned rows; the JAX package's
    within 1e-5 · max(1, d) of the port's plus the cancellation of its l2
    form ``sqrt(‖q‖² − s)``, about sqrt(ε)·‖q‖ (the port returns ‖q − v‖)."""
    assert got.column_names == want.column_names
    target = np.atleast_2d(target).astype(np.float64)
    qid = got.column("__QUERY_ID__").to_numpy() if "__QUERY_ID__" in got.column_names else np.zeros(
        got.num_rows, np.int64)
    ids, want_ids = got.column("id").to_numpy(), want.column("id").to_numpy()
    d, want_d = got.column("__DISTANCE__").to_numpy(), want.column("__DISTANCE__").to_numpy()
    if not ordered:
        order, want_order = np.lexsort((ids, qid)), np.lexsort((want_ids, qid))
        ids, d, want_ids, want_d = ids[order], d[order], want_ids[want_order], want_d[want_order]
        qid = qid[order]
    np.testing.assert_array_equal(ids, want_ids)
    vecs = ingest.fixed_size_list_to_numpy(got.column("vector").combine_chunks()).astype(np.float64)
    if not ordered:
        vecs = vecs[order]
    d64 = np.linalg.norm(vecs - target[qid], axis=1)
    np.testing.assert_array_less(np.abs(d - d64), 1e-5 * np.maximum(1.0, d64) + 1e-12)
    slack = 1e-5 * np.maximum(1.0, d64) + 4e-4 * np.linalg.norm(target[qid], axis=1)
    np.testing.assert_array_less(np.abs(d - want_d), slack)


def _both(jcache, pcache, target, maxval=3, ordered=True, **kw) -> pa.Table:
    """The port's answer, held to the JAX package's on the same root."""
    got = _search(pcache, target, maxval, **kw)
    _assert_same(got, _search(jcache, target, maxval, **kw), target, ordered)
    return got


def _counters(cache) -> tuple[int, int]:
    return cache.incremental_refreshes, cache.lineage_refreshes


def _full_builds(monkeypatch) -> list:
    builds: list = []
    real = ingest.to_device_matrix
    monkeypatch.setattr(ingest, "to_device_matrix", lambda *a, **k: builds.append(1) or real(*a, **k))
    return builds


# -- the device matrix: append grow (test_incremental_cache.py) ---------------------


def test_append_refreshes_incrementally(tmp_path, rng, monkeypatch):
    """An append grows the matrix by the delta's rows (past the padded
    capacity too), a delete refreshes by the lineage, and both caches move
    the same counters and answer alike, as a cold cache does."""
    root = str(tmp_path)
    vecs = rng.standard_normal((1000, DIM)).astype(np.float32)
    table.make(root, "t", _tbl(np.arange(1000), vecs).to_reader())
    jcache, pcache = _caches(root, 256)
    _both(jcache, pcache, vecs[3])  # warm both matrices
    builds = _full_builds(monkeypatch)

    extra = rng.standard_normal((40, DIM)).astype(np.float32) + 25.0
    table.append(root, "t", _tbl(np.arange(1000, 1040), extra))
    hit = _both(jcache, pcache, extra[7], maxval=1)
    assert hit.column("id").to_pylist() == [1007]
    assert _counters(pcache) == _counters(jcache) == (1, 0)
    assert pcache.matrix("t", "vector").rows_padded == 1280  # a cold build's capacity

    # past the padded capacity: a bigger buffer, still only the delta uploaded
    extra2 = rng.standard_normal((400, DIM)).astype(np.float32) - 25.0
    table.append(root, "t", _tbl(np.arange(1040, 1440), extra2))
    hit = _both(jcache, pcache, extra2[5], maxval=1)
    assert hit.column("id").to_pylist() == [1045]
    assert _counters(pcache) == _counters(jcache) == (2, 0)
    assert not builds, "an append re-read the corpus"
    grown = pcache.matrix("t", "vector")
    assert grown.rows_padded == 1536 and not grown.data[grown.rows :].any()  # zero padding rows

    cold = DeviceCache(root, block=256, device="cpu")
    q = rng.standard_normal(DIM).astype(np.float32)
    _assert_same(_search(pcache, q, maxval=10), _search(cold, q, maxval=10), q)
    torch.testing.assert_close(grown.data, cold.matrix("t", "vector").data, rtol=0, atol=0)

    assert index.delete_rows(root, "t", expr.field("id") >= 1400) == 40
    out = _both(jcache, pcache, extra2[5], maxval=1000, ordered=False)
    assert out.num_rows == 1000 and (out.column("id").to_numpy() < 1400).all()
    assert _counters(pcache) == _counters(jcache) == (2, 1)


def test_concurrent_appends_and_searches(tmp_path, rng):
    """Writers and readers race through the port's engine: no search fails
    or sees a torn table while appends land; the end state is the JAX
    package's answer."""
    root = str(tmp_path)
    vecs = rng.standard_normal((2048, DIM)).astype(np.float32)
    table.make(root, "t", _tbl(np.arange(2048), vecs).to_reader())
    cache = DeviceCache(root, block=256, device="cpu")
    _search(cache, vecs[0])
    payloads = [
        _tbl(np.arange(2048 + i * 32, 2048 + (i + 1) * 32), rng.standard_normal((32, DIM)).astype(np.float32))
        for i in range(8)
    ]
    queries = rng.standard_normal((24, DIM)).astype(np.float32)
    errors: list = []

    def appender(i: int) -> None:
        try:
            table.append(root, "t", payloads[i])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def searcher(q: np.ndarray) -> None:
        try:
            ids = _search(cache, q, maxval=5).column("id").to_numpy()
            assert ids.shape == (5,) and (ids >= 0).all() and (ids < 2048 + 256).all()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    with concurrent.futures.ThreadPoolExecutor(12) as pool:
        futures = [pool.submit(appender, i) for i in range(8)] + [pool.submit(searcher, q) for q in queries]
        [f.result() for f in futures]
    assert not errors, errors[:3]
    last = payloads[7].column("vector")[0].values.to_numpy()
    final = _search(cache, last, maxval=1)
    assert final.column("id").to_pylist() == [2048 + 7 * 32]
    _assert_same(_search(cache, queries[0], maxval=10),
                 _search(JaxCache(root, block=256, mesh=None), queries[0], maxval=10), queries[0])


# -- the device matrix: lineage (test_lineage_refresh.py) ---------------------------


def test_delete_compacts_on_device(tmp_path, rng, monkeypatch):
    root = str(tmp_path)
    vecs = rng.standard_normal((900, DIM)).astype(np.float32)
    table.make(root, "t", _tbl(np.arange(900), vecs).to_reader())
    jcache, pcache = _caches(root, 128)
    _both(jcache, pcache, vecs[0])
    builds = _full_builds(monkeypatch)
    assert index.delete_rows(root, "t", expr.field("id") % 3 == 0) == 300
    out = _both(jcache, pcache, vecs[4], maxval=600, ordered=False)
    assert out.num_rows == 600 and (out.column("id").to_numpy() % 3 != 0).all()
    assert _counters(pcache) == _counters(jcache) == (0, 1)
    assert not builds, "a delete must gather on the device"
    shrunk = pcache.matrix("t", "vector")
    assert shrunk.rows == 600 and shrunk.rows_padded == 640 and not shrunk.data[600:].any()
    cold = DeviceCache(root, block=128, device="cpu")
    q = rng.standard_normal(DIM).astype(np.float32)
    _assert_same(_search(pcache, q, maxval=20), _search(cold, q, maxval=20), q)


def test_compaction_reuses_buffer(tmp_path, rng, monkeypatch):
    """A compaction changes the base, not a row: the cached buffer is
    reused as it is (an identity hop)."""
    root = str(tmp_path)
    vecs = rng.standard_normal((600, DIM)).astype(np.float32)
    table.make(root, "t", _tbl(np.arange(600), vecs).to_reader())
    jcache, pcache = _caches(root, 128)
    extra = rng.standard_normal((50, DIM)).astype(np.float32) + 9.0
    table.append(root, "t", _tbl(np.arange(600, 650), extra))
    _both(jcache, pcache, vecs[0])  # warm at base + part
    before = pcache.matrix("t", "vector").data
    builds = _full_builds(monkeypatch)
    table.compact(root, "t")
    assert _both(jcache, pcache, extra[3], maxval=1).column("id").to_pylist() == [603]
    assert _counters(pcache) == _counters(jcache) == (0, 1)
    assert not builds
    assert pcache.matrix("t", "vector").data is before, "an identity hop reuses the buffer"


def test_upsert_composes_shrink_and_grow(tmp_path, rng, monkeypatch):
    """upsert = delete + append in one lock scope: the refresh applies the
    keep-mask hop, then grows by the appended part (one lineage refresh,
    as the JAX package counts it)."""
    root = str(tmp_path)
    vecs = rng.standard_normal((700, DIM)).astype(np.float32)
    table.make(root, "t", _tbl(np.arange(700), vecs).to_reader())
    jcache, pcache = _caches(root, 128)
    _both(jcache, pcache, vecs[0])
    builds = _full_builds(monkeypatch)
    repl = rng.standard_normal((30, DIM)).astype(np.float32) - 11.0
    assert index.upsert_rows(root, "t", _tbl(np.arange(680, 710), repl), device="cpu") == (20, 10)
    assert _both(jcache, pcache, repl[5], maxval=1).column("id").to_pylist() == [685]
    assert _counters(pcache) == _counters(jcache) == (0, 1)
    assert not builds, "an upsert must shrink and grow on the device"
    cold = DeviceCache(root, block=128, device="cpu")
    q = rng.standard_normal(DIM).astype(np.float32)
    _assert_same(_search(pcache, q, maxval=20), _search(cold, q, maxval=20), q)


def test_corrupt_lineage_falls_back(tmp_path, rng, monkeypatch):
    """A garbage, empty or truncated lineage file reads as None (a full
    rebuild), never as an error or a wrong refresh."""
    root = str(tmp_path)
    vecs = rng.standard_normal((400, DIM)).astype(np.float32)
    table.make(root, "t", _tbl(np.arange(400), vecs).to_reader())
    jcache, pcache = _caches(root, 128)
    _both(jcache, pcache, vecs[0])
    assert index.delete_rows(root, "t", expr.field("id") >= 300) == 100
    path = table._lineage_path(root, "t")
    for junk in (b"\x00garbage", b"", b"PK\x03\x04" + b"\x00" * 8):
        with open(path, "wb") as fh:
            fh.write(junk)
        assert table.lineage(root, "t") is None and jtable.lineage(root, "t") is None
    builds = _full_builds(monkeypatch)
    assert _both(jcache, pcache, vecs[4], maxval=400, ordered=False).num_rows == 300
    assert _counters(pcache) == _counters(jcache) == (0, 0)
    assert builds, "a corrupt lineage must rebuild"


def test_lineage_cleared_on_drop_and_recreate(tmp_path, rng):
    """drop removes the lineage file; a table made again under the name
    inherits no hop. The port's lineage file is the JAX package's."""
    root = str(tmp_path)
    vecs = rng.standard_normal((300, DIM)).astype(np.float32)
    table.make(root, "t", _tbl(np.arange(300), vecs).to_reader())
    assert index.delete_rows(root, "t", expr.field("id") >= 200) == 100
    lin, jlin = table.lineage(root, "t"), jtable.lineage(root, "t")
    assert lin[:2] == jlin[:2] and np.array_equal(lin[2], jlin[2]) and lin[2].sum() == 200
    table.drop(root, "t")
    assert not os.path.exists(table._lineage_path(root, "t"))


def test_two_hops_behind_falls_back(tmp_path, rng, monkeypatch):
    """Only the latest hop is recorded: a cache two deletes behind cannot
    prove its rows and rebuilds from the host."""
    root = str(tmp_path)
    vecs = rng.standard_normal((500, DIM)).astype(np.float32)
    table.make(root, "t", _tbl(np.arange(500), vecs).to_reader())
    jcache, pcache = _caches(root, 128)
    _both(jcache, pcache, vecs[0])
    builds = _full_builds(monkeypatch)
    assert index.delete_rows(root, "t", expr.field("id") >= 450) == 50
    assert index.delete_rows(root, "t", expr.field("id") >= 400) == 50
    out = _both(jcache, pcache, vecs[4], maxval=500, ordered=False)
    assert out.num_rows == 400 and (out.column("id").to_numpy() < 400).all()
    assert _counters(pcache) == _counters(jcache) == (0, 0)
    assert builds, "a stale lineage must rebuild"


def test_delete_then_append_refreshes_the_derived_entries(tmp_path, rng, monkeypatch):
    """A delete then an append: the matrix shrinks and grows, and the
    scan copies, the aux and a device filter rebuild from it under the
    new stamp, every precision answering as the JAX package."""
    root = str(tmp_path)
    vecs = rng.standard_normal((1200, DIM)).astype(np.float32)
    tags = (np.arange(1200) % 7).astype(np.int32)
    table.make(root, "t", _tbl(np.arange(1200), vecs, tags).to_reader())
    jcache, pcache = _caches(root, 256)
    filt = {"port": expr.field("tag") < 4, "jax": jexpr.field("tag") < 4}
    for precision in ("fp32", "bf16", "int8"):
        _search(pcache, vecs[:3], maxval=10, precision=precision, filter=filt["port"])
    builds = _full_builds(monkeypatch)
    assert index.delete_rows(root, "t", expr.field("id") < 100) == 100
    extra = rng.standard_normal((64, DIM)).astype(np.float32)
    table.append(root, "t", _tbl(np.arange(1200, 1264), extra, np.zeros(64, np.int32)))
    target = np.concatenate([extra[:2], vecs[200:202]])
    for precision in ("fp32", "bf16", "int8"):
        got = _search(pcache, target, maxval=10, precision=precision, filter=filt["port"])
        _assert_same(got, _search(jcache, target, maxval=10, precision=precision, filter=filt["jax"]), target)
        assert got.column("id").to_pylist()[0] == 1200
    assert pcache.lineage_refreshes == 1 and not builds


# -- the host int8 mirror (test_mirror_incremental.py) ------------------------------

ROWS, MDIM = 2048, 24


def _vec_table(rows, rng, start=0):
    return _tbl(np.arange(start, start + rows), rng.standard_normal((rows, MDIM)).astype(np.float32))


@pytest.fixture
def mroot(tmp_path, rng):
    root = str(tmp_path)
    table.make(root, "vec", _vec_table(ROWS, rng).to_reader())
    return root


def _oracle(cache):
    return topk2.quantize_rows_int8_np(cache.host_matrix("vec", "vector"))


def _metric(name: str) -> float:
    return METRICS.snapshot().get(name, 0)


def _assert_mirror(codes, scales, cache) -> None:
    want_c, want_s = _oracle(cache)
    np.testing.assert_array_equal(np.asarray(codes), want_c)
    np.testing.assert_array_equal(np.asarray(scales), want_s)


def test_append_refresh_quantizes_only_delta(mroot, rng):
    cache = DeviceCache(mroot, device="cpu")
    before = _metric("cache.mirror_rows_quantized")
    cache.host_int8("vec", "vector")
    assert _metric("cache.mirror_rows_quantized") == before + ROWS
    table.append(mroot, "vec", _vec_table(100, rng, start=ROWS))
    before, refreshes = _metric("cache.mirror_rows_quantized"), _metric("cache.mirror_delta_refreshes")
    codes, scales = cache.host_int8("vec", "vector")
    assert _metric("cache.mirror_rows_quantized") == before + 100  # the delta alone
    assert _metric("cache.mirror_delta_refreshes") == refreshes + 1
    assert codes.shape[0] == ROWS + 100
    _assert_mirror(codes, scales, cache)


def test_append_grows_sidecar_in_place(mroot, rng):
    """The port grows the sidecar in place; a fresh JAX cache (another
    process) loads it whole, and the reverse."""
    cache = DeviceCache(mroot, device="cpu")
    cache.host_int8("vec", "vector")
    cdir = cache._int8_cdir(("vec",), "vector")
    inode = os.stat(os.path.join(cdir, "codes.npy")).st_ino
    table.append(mroot, "vec", _vec_table(64, rng, start=ROWS))
    codes, scales = cache.host_int8("vec", "vector")
    assert codes.shape[0] == ROWS + 64
    assert os.stat(os.path.join(cdir, "codes.npy")).st_ino == inode  # grown in place
    loads = JMETRICS.snapshot().get("cache.int8_sidecar_loads", 0)
    jcodes, jscales = JaxCache(mroot, mesh=None).host_int8("vec", "vector")
    assert JMETRICS.snapshot().get("cache.int8_sidecar_loads", 0) == loads + 1
    np.testing.assert_array_equal(np.asarray(jcodes), np.asarray(codes))
    np.testing.assert_array_equal(jscales, scales)

    # the JAX package grows it in place; the port loads it
    table.append(mroot, "vec", _vec_table(32, rng, start=ROWS + 64))
    jcodes, _ = JaxCache(mroot, mesh=None).host_int8("vec", "vector")
    assert os.stat(os.path.join(cdir, "codes.npy")).st_ino == inode
    loads = _metric("cache.int8_sidecar_loads")
    codes, scales = DeviceCache(mroot, device="cpu").host_int8("vec", "vector")
    assert _metric("cache.int8_sidecar_loads") == loads + 1 and codes.shape[0] == ROWS + 96
    np.testing.assert_array_equal(np.asarray(codes), np.asarray(jcodes))
    _assert_mirror(codes, scales, cache)


def test_restart_then_append_refreshes_from_sidecar(mroot, rng):
    """A restart (a new cache) finds an old-stamp sidecar, here the JAX
    package's, and quantizes only the appended rows."""
    JaxCache(mroot, mesh=None).host_int8("vec", "vector")
    table.append(mroot, "vec", _vec_table(50, rng, start=ROWS))
    cache = DeviceCache(mroot, device="cpu")
    before = _metric("cache.mirror_rows_quantized")
    codes, scales = cache.host_int8("vec", "vector")
    assert _metric("cache.mirror_rows_quantized") == before + 50
    _assert_mirror(codes, scales, cache)


def test_delete_refresh_never_requantizes(mroot, rng):
    cache = DeviceCache(mroot, device="cpu")
    cache.host_int8("vec", "vector")
    assert index.delete_rows(mroot, "vec", expr.field("id") % 3 == 0) > 0
    before, refreshes = _metric("cache.mirror_rows_quantized"), _metric("cache.mirror_delta_refreshes")
    codes, scales = cache.host_int8("vec", "vector")
    assert _metric("cache.mirror_rows_quantized") == before  # a keep-mask gather
    assert _metric("cache.mirror_delta_refreshes") == refreshes + 1
    _assert_mirror(codes, scales, cache)


def test_delete_then_append_composes(mroot, rng):
    cache = DeviceCache(mroot, device="cpu")
    cache.host_int8("vec", "vector")
    index.delete_rows(mroot, "vec", expr.field("id") < 100)
    table.append(mroot, "vec", _vec_table(80, rng, start=ROWS))
    before = _metric("cache.mirror_rows_quantized")
    codes, scales = cache.host_int8("vec", "vector")
    assert _metric("cache.mirror_rows_quantized") == before + 80
    _assert_mirror(codes, scales, cache)


def test_device_int8_solo_grows_on_append(mroot, rng):
    """The int8-resident copy grows by the appended rows' codes, counted
    as the JAX package counts it; its search equals the dual answer."""
    cache, jcache = DeviceCache(mroot, device="cpu"), JaxCache(mroot, mesh=None)
    assert cache.int8_solo("vec", "vector")[0].rows == ROWS
    jcache.int8_solo("vec", "vector")
    table.append(mroot, "vec", _vec_table(100, rng, start=ROWS))
    v8, sv = cache.int8_solo("vec", "vector")
    jv8, jsv = jcache.int8_solo("vec", "vector")
    assert cache.incremental_refreshes == jcache.incremental_refreshes == 1
    assert v8.rows == ROWS + 100 and v8.rows_padded == jv8.rows_padded
    want_c, want_s = _oracle(cache)
    np.testing.assert_array_equal(v8.data[: ROWS + 100].numpy(), want_c)
    np.testing.assert_array_equal(v8.data.numpy(), np.asarray(jv8.data))
    np.testing.assert_array_equal(sv.data.numpy(), np.asarray(jsv.data))
    assert not v8.data[ROWS + 100 :].any() and (sv.data[ROWS + 100 :] == np.float32(1e-30)).all()
    target = rng.standard_normal((2, MDIM)).astype(np.float32)
    req = dict(source="vec", column="vector", target=target, metric="l2", maxval=7)
    dual = executor.execute_search(cache, executor.SearchRequest(**req))
    got = executor.execute_search(cache, executor.SearchRequest(**req, residency="int8",
                                                                extra={"window": ROWS + 100}))
    assert got.column("id").equals(dual.column("id"))


def test_int8_resident_search_grows_after_append(mroot, rng):
    """Through the search path the int8-resident copy grows too (the port
    keeps it across the host table's reload; the JAX package drops it and
    uploads the refreshed mirror): one incremental refresh, the delta
    quantized once, the answer the JAX package's."""
    cache, jcache = DeviceCache(mroot, device="cpu"), JaxCache(mroot, mesh=None)
    target = rng.standard_normal((3, MDIM)).astype(np.float32)
    req = dict(source="vec", column="vector", target=target, metric="l2", maxval=9, residency="int8",
               extra={"window": 4096})
    executor.execute_search(cache, executor.SearchRequest(**req))
    extra = rng.standard_normal((70, MDIM)).astype(np.float32)
    extra[0] = target[0]
    table.append(mroot, "vec", _tbl(np.arange(ROWS, ROWS + 70), extra))
    before = _metric("cache.mirror_rows_quantized")
    got = executor.execute_search(cache, executor.SearchRequest(**req))
    assert _metric("cache.mirror_rows_quantized") == before + 70
    assert cache.incremental_refreshes == 1 and got.column("id").to_pylist()[0] == ROWS
    _assert_same(got, jexecutor.execute_search(jcache, jexecutor.SearchRequest(**req)), target)


def test_torn_inplace_append_rebuilds_silently(mroot, rng):
    """A crash between the data append and the meta write leaves no meta:
    a fresh cache rebuilds without a sound."""
    cache = DeviceCache(mroot, device="cpu")
    cache.host_int8("vec", "vector")
    cdir = cache._int8_cdir(("vec",), "vector")
    os.unlink(os.path.join(cdir, "meta.json"))
    with open(os.path.join(cdir, "codes.npy"), "ab") as fh:
        fh.write(b"\x01" * (MDIM * 7))
    fresh = DeviceCache(mroot, device="cpu")
    codes, scales = fresh.host_int8("vec", "vector")
    assert codes.shape[0] == ROWS
    _assert_mirror(codes, scales, fresh)


def test_npy_append_rows_guards(tmp_path):
    path = str(tmp_path / "a.npy")
    base = np.arange(12, dtype=np.int8).reshape(4, 3)
    np.save(path, base)
    delta = np.arange(6, dtype=np.int8).reshape(2, 3)
    assert _npy_append_rows(path, delta, expect_rows=4)
    got = np.load(path)
    np.testing.assert_array_equal(got, np.concatenate([base, delta]))
    assert not _npy_append_rows(path, delta, expect_rows=4)  # a concurrent writer won
    np.testing.assert_array_equal(np.load(path), got)
    assert not _npy_append_rows(path, delta.astype(np.int16), expect_rows=6)  # another dtype


# -- index files (index.extend_for_source / delete_rows / upsert_rows) --------------


def _codes(root: str) -> np.ndarray:
    return arrow.load(index.path_of(root, "ivf", "t", "vector")).column("__CODED_ID__").to_numpy()


def test_index_mutations_write_the_jax_codes(tmp_path, rng):
    """The same mutations through each package on two copies of one root
    (a coder and an index the JAX package built) leave equal index files
    and tables; the port's file is the JAX package's format, read by it."""
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    vecs = rng.standard_normal((3000, DIM)).astype(np.float32)
    table.make(jroot, "t", _tbl(np.arange(3000), vecs).to_reader())
    jcoder.make(jroot, "ivf", "t", "vector", IVF, seed=0)
    jindex.make(jroot, "ivf", "t", "vector")
    shutil.copytree(jroot, proot)
    extra = _tbl(np.arange(3000, 3200), rng.standard_normal((200, DIM)).astype(np.float32) + 2.0)
    upsert = _tbl(np.arange(3100, 3300), rng.standard_normal((200, DIM)).astype(np.float32) - 2.0)

    jtable.append(jroot, "t", extra)
    jindex.extend_for_source(jroot, "t", extra)
    table.append(proot, "t", extra)
    index.extend_for_source(proot, "t", extra, device="cpu")
    np.testing.assert_array_equal(_codes(proot), _codes(jroot))
    assert _codes(proot).shape == (3200,)

    assert index.delete_rows(proot, "t", expr.field("id") % 5 == 1) == jindex.delete_rows(
        jroot, "t", jexpr.field("id") % 5 == 1) == 640
    np.testing.assert_array_equal(_codes(proot), _codes(jroot))

    replaced, inserted = index.upsert_rows(proot, "t", upsert, device="cpu")
    assert (replaced, inserted) == jindex.upsert_rows(jroot, "t", upsert) == (80, 120)
    np.testing.assert_array_equal(_codes(proot), _codes(jroot))
    assert table.load(proot, "t").equals(jtable.load(jroot, "t"))
    loaded = jindex.load(proot, "ivf", "t", "vector")
    assert loaded.num_rows == 3200 - 640 - 80 + 200
    np.testing.assert_array_equal(loaded.column("__CODED_ID__").to_numpy(), _codes(jroot))

    # a desynced index refuses a delete
    arrow.make(index.path_of(proot, "ivf", "t", "vector"),
               arrow.load(index.path_of(proot, "ivf", "t", "vector")).slice(0, 10).to_reader())
    with pytest.raises(RuntimeError, match="re-run sync_index"):
        index.delete_rows(proot, "t", expr.field("id") < 3)


def test_extend_assigns_on_the_host_past_the_budget(tmp_path, rng, monkeypatch):
    """Past the budget the appended rows are assigned on the host
    (index.host_assigns), to the same cells."""
    root = str(tmp_path)
    table.make(root, "t", _tbl(np.arange(2000), rng.standard_normal((2000, DIM)).astype(np.float32)).to_reader())
    coder.make(root, "ivf", "t", "vector", IVF, seed=0, device="cpu")
    index.make(root, "ivf", "t", "vector", device="cpu")
    extra = _tbl(np.arange(2000, 2300), rng.standard_normal((300, DIM)).astype(np.float32))
    table.append(root, "t", extra)
    monkeypatch.setenv("FENIX_HBM_BUDGET", "1000")
    before = _metric("index.host_assigns")
    index.extend_for_source(root, "t", extra, device="cpu")
    assert _metric("index.host_assigns") == before + 1
    incremental = _codes(root)
    monkeypatch.delenv("FENIX_HBM_BUDGET")
    index.make(root, "ivf", "t", "vector", device="cpu")
    np.testing.assert_array_equal(incremental, _codes(root))


# -- Flight: the unchanged JAX client against the port's server (test_flight.py) ----

VECTOR_SIZE, NUM_VECTORS, BATCH_SIZE = 32, 2_048, 256
SCHEMA = pa.schema({"id": pa.int64(), "vector": pa.list_(pa.float32(), VECTOR_SIZE)})
CONFIG = {"metric": "l2", "codebook_size": 4, "num_codebooks": 2, "batch_size": 256, "num_epochs": 2}


def _batches(seed: int):
    rng = np.random.default_rng(seed)
    for start in range(0, NUM_VECTORS, BATCH_SIZE):
        x = rng.standard_normal((BATCH_SIZE, VECTOR_SIZE)).astype(np.float32)
        yield pa.record_batch([pa.array(np.arange(start, start + BATCH_SIZE)),
                               ingest.numpy_to_fixed_size_list(x, pa.float32())], schema=SCHEMA)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mutations_flight"))
    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    client = fenix_tpu.Flight(host="127.0.0.1", port=server.port)
    yield server, client
    client.close()
    server.shutdown()


def test_append_delete_and_overwrite_lifecycle(served, rng):
    """An append extends the index by the new rows alone (equal to a full
    re-assignment); delete-rows filters the table and the index by one
    mask; compact-table folds the parts; an overwrite drops the index."""
    server, flight = served
    src = pa.Table.from_batches(_batches(7), SCHEMA)
    flight.make_table("test/mut", src.to_reader())
    flight.make_index(name="test/mutcoder", source="test/mut", column="vector", config=CONFIG)
    x = rng.standard_normal((BATCH_SIZE, VECTOR_SIZE)).astype(np.float32) + 100.0
    ids = np.arange(NUM_VECTORS, NUM_VECTORS + BATCH_SIZE)
    extra = pa.record_batch([pa.array(ids), ingest.numpy_to_fixed_size_list(x, pa.float32())], schema=SCHEMA)
    flight.append_table("test/mut", pa.RecordBatchReader.from_batches(SCHEMA, iter([extra])))
    total = NUM_VECTORS + BATCH_SIZE
    assert flight.read_table("test/mut").read_all().num_rows == total
    coded = flight.read_table("test/mut", coding="test/mutcoder", column="vector").read_all()
    incremental = coded.column("__CODED_ID__").to_numpy()
    assert incremental.shape == (total,)
    hit = flight.search(target=x[3], source="test/mut", column="vector", metric="l2", maxval=1)
    assert hit.column("id").to_pylist() == [ids[3]]
    flight.sync_index(name="test/mutcoder", source="test/mut", column="vector")
    full = flight.read_table("test/mut", coding="test/mutcoder", column="vector").read_all()
    np.testing.assert_array_equal(incremental, full.column("__CODED_ID__").to_numpy())
    bad = pa.record_batch([pa.array([1.5])], names=["id"])
    with pytest.raises(Exception, match="schema mismatch"):
        flight.append_table("test/mut", pa.RecordBatchReader.from_batches(bad.schema, iter([bad])))

    assert flight.delete_rows("test/mut", jexpr.field("id") < 100) == 100
    remaining = flight.read_table("test/mut").read_all()
    assert remaining.num_rows == total - 100 and (remaining.column("id").to_numpy() >= 100).all()
    kept = flight.read_table("test/mut", coding="test/mutcoder", column="vector").read_all()
    np.testing.assert_array_equal(kept.column("__CODED_ID__").to_numpy(),
                                  full.column("__CODED_ID__").to_numpy()[100:])
    probed = flight.search(target=x[3], source="test/mut", column="vector", metric="l2",
                           coding="test/mutcoder", maxval=10, probes=16)
    assert (probed.column("id").to_numpy() >= 100).all()

    flight.append_table("test/mut", pa.RecordBatchReader.from_batches(SCHEMA, iter([extra])))
    flight.delete_rows("test/mut", jexpr.field("id") >= NUM_VECTORS)
    flight.append_table("test/mut", pa.RecordBatchReader.from_batches(SCHEMA, iter([extra])))
    parts = table.path_of(server.root, "test/mut") + ".parts"
    assert os.listdir(parts)  # the append left a delta part
    hit = flight.search(target=x[5], source="test/mut", column="vector", metric="l2", maxval=1)
    before = flight.stats()
    flight.compact_table("test/mut")
    assert not [p for p in os.listdir(parts) if p.endswith(".part")]
    assert flight.read_table("test/mut").read_all().num_rows == total - 100
    assert flight.search(target=x[5], source="test/mut", column="vector", metric="l2", maxval=1) == hit
    assert hit.column("id").to_pylist() == [ids[5]]
    after = flight.stats()
    assert after["cache.lineage_refreshes"] - before["cache.lineage_refreshes"] == 1  # the compaction's hop
    flight.delete_rows("test/mut", jexpr.field("id") >= NUM_VECTORS)

    flight.make_table("test/mut", src.to_reader())
    assert "test/mut/vector/test/mutcoder" not in flight.list_indexes()
    flight.drop_index("test/mutcoder")
    flight.drop_table("test/mut")


def test_concurrent_appends_lose_no_rows(served, rng):
    """Appends serialize on the catalog lock: eight concurrent appenders
    through the threaded gRPC server all land."""
    _, flight = served
    flight.make_table("test/conc", pa.Table.from_batches([next(_batches(3))], SCHEMA).to_reader())
    payloads = [
        pa.record_batch([pa.array(np.arange(i * 50, (i + 1) * 50) + 10_000),
                         ingest.numpy_to_fixed_size_list(
                             rng.standard_normal((50, VECTOR_SIZE)).astype(np.float32), pa.float32())],
                        schema=SCHEMA)
        for i in range(8)
    ]

    def append(i: int) -> None:
        client = fenix_tpu.Flight(host=flight.host, port=flight.port)
        client.append_table("test/conc", pa.RecordBatchReader.from_batches(SCHEMA, iter([payloads[i]])))
        client.close()

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        [*pool.map(append, range(8))]
    got = flight.read_table("test/conc").read_all()
    assert got.num_rows == BATCH_SIZE + 8 * 50
    assert np.unique(got.column("id").to_numpy()).size == got.num_rows
    flight.drop_table("test/conc")


def test_upsert_rows(served, rng):
    """Replace or insert by key through the port's client and the JAX
    client: matched keys take the new vectors, others append, the index
    follows both, and the stats count the refreshes."""
    _, flight = served
    src = pa.Table.from_batches(_batches(12), SCHEMA)
    flight.make_table("test/ups", src.to_reader())
    flight.make_index(name="test/upscoder", source="test/ups", column="vector", config=CONFIG)
    flight.search(target=src.column("vector")[0].values.to_numpy(), source="test/ups", column="vector",
                  metric="l2", maxval=1)  # warm the device matrix
    x = rng.standard_normal((4, VECTOR_SIZE)).astype(np.float32) + 200.0
    payload = pa.table({"id": pa.array(np.array([10, 11, NUM_VECTORS, NUM_VECTORS + 1])),
                        "vector": ingest.numpy_to_fixed_size_list(x, pa.float32())})
    assert flight.upsert_rows("test/ups", payload.to_reader()) == {"replaced": 2, "inserted": 2}
    got = flight.read_table("test/ups").read_all()
    assert got.num_rows == NUM_VECTORS + 2 and np.unique(got.column("id").to_numpy()).size == got.num_rows
    before = flight.stats()
    hit = flight.search(target=x[0], source="test/ups", column="vector", metric="l2", maxval=1)
    assert hit.column("id").to_pylist() == [10] and hit.column("__DISTANCE__")[0].as_py() < 1e-3
    after = flight.stats()
    assert after["cache.lineage_refreshes"] - before["cache.lineage_refreshes"] == 1
    probed = flight.search(target=x[2], source="test/ups", column="vector", metric="l2",
                           coding="test/upscoder", maxval=1, probes=16)
    assert probed.column("id").to_pylist() == [NUM_VECTORS]

    port_client = fenix_tpu_torch.Flight(host=flight.host, port=flight.port)
    again = pa.table({"id": pa.array(np.array([10, NUM_VECTORS + 5])),
                      "vector": ingest.numpy_to_fixed_size_list(x[:2] - 400.0, pa.float32())})
    assert port_client.upsert_rows("test/ups", again.to_reader()) == {"replaced": 1, "inserted": 1}
    port_client.append_table("test/ups", again.slice(1).to_reader())
    assert port_client.delete_rows("test/ups", expr.field("id") == NUM_VECTORS + 5) == 2
    port_client.compact_table("test/ups")
    assert port_client.read_table("test/ups").read_all().num_rows == NUM_VECTORS + 2
    port_client.close()
    flight.drop_index("test/upscoder")
    flight.drop_table("test/ups")
