"""fenix_tpu_torch's IVF past the device budget against the JAX package,
on the CPU: the probed host search (``residency.probed_topk`` over the
cell-sorted host int8 layout and its IVF sidecar), the probed host
no-top-k read, and the streamed coder training
(``kmeans.train_streaming``, ``coder.make`` past 0.9 × the budget).

One root, a coder and an index the JAX package built; both packages'
caches serve it (the JAX cache pinned to one device). Tolerances: ids
exact; the port's distances within 1e-5 of its dual answer and of
float64, the JAX package's l2 within its expanded form's cancellation of
the port's; trained codebooks within 1e-5 relative of the JAX trainer's
for the same seed.
"""

import shutil

import numpy as np
import pyarrow as pa
import pytest
import torch

from fenix_tpu import coder as jcoder
from fenix_tpu import expr as jexpr
from fenix_tpu import index as jindex
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine import residency as jresidency
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu.ops import kmeans as jkmeans
from fenix_tpu.ops import topk2 as jtopk2
from fenix_tpu.parallel import mesh as jmesh
from fenix_tpu.utils.metrics import GLOBAL as JMETRICS
from fenix_tpu_torch import coder, expr, index
from fenix_tpu_torch.engine import executor, residency
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.ops import kmeans
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

torch.set_num_threads(2)

ROWS, DIM = 3 * 16384, 16
CODER = {"metric": "l2", "codebook_size": 4, "num_codebooks": 2, "batch_size": 512, "num_epochs": 2}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    rng = np.random.default_rng(21)
    root = str(tmp_path_factory.mktemp("ivf_host"))
    vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    table.make(root, "vec", pa.table({
        "id": pa.array(np.arange(ROWS)),
        "tag": pa.array((np.arange(ROWS) % 10).astype(np.int64)),
        "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32()),
    }).to_reader())
    jcoder.make(root, "c", "vec", "vector", CODER, seed=0)
    jindex.make(root, "c", "vec", "vector")
    return root


def _metric(metrics, name: str) -> float:
    return metrics.snapshot().get(name, 0)


def _ids_dists(out: pa.Table, q: int):
    return (out.column("id").to_numpy().reshape(q, -1),
            out.column("__DISTANCE__").to_numpy().reshape(q, -1))


def _check_float64(out: pa.Table, target: np.ndarray, q: int) -> None:
    """Every returned l2 distance within 1e-5 · max(1, d) of float64."""
    vecs = ingest.fixed_size_list_to_numpy(out.column("vector").combine_chunks()).astype(np.float64)
    qid = out.column("__QUERY_ID__").to_numpy() if q > 1 else np.zeros(out.num_rows, np.int64)
    d64 = np.linalg.norm(vecs - target.astype(np.float64).reshape(q, -1)[qid], axis=1)
    np.testing.assert_array_less(np.abs(out.column("__DISTANCE__").to_numpy() - d64),
                                 1e-5 * np.maximum(1.0, d64) + 1e-12)


def _against_jax(got: pa.Table, want: pa.Table, target: np.ndarray, q: int) -> None:
    """Ids exact; distances held to float64, and the JAX package's within
    its l2 form's cancellation (about sqrt(ε)·‖q‖) of the port's."""
    assert got.column_names == want.column_names
    ids_a, d_a = _ids_dists(got, q)
    ids_b, d_b = _ids_dists(want, q)
    np.testing.assert_array_equal(ids_a, ids_b)
    _check_float64(got, target, q)
    slack = 1e-5 * np.maximum(1.0, d_a) + 4e-4 * np.linalg.norm(target.reshape(q, -1), axis=1)[:, None]
    np.testing.assert_array_less(np.abs(d_a - d_b), slack)


def _requests(target, **kw):
    base = dict(source="vec", column="vector", target=target, metric="l2", maxval=25, coding="c", probes=8)
    jkw = {k: (jexpr.Expr.from_dict(v.to_dict()) if k == "filter" and v is not None else v) for k, v in kw.items()}
    return executor.SearchRequest(**{**base, **kw}), jexecutor.SearchRequest(**{**base, **jkw})


# -- the probed host search (test_residency.py:235-316) ----------------------------


@pytest.mark.parametrize("mode", ["int8", "stream"])
def test_probed_residency_matches_dual(root, rng, mode):
    """A probed request past the device residency runs on the host over
    the cell-sorted layout; with a window covering the corpus it is the
    dual probed answer exactly, and the JAX package's host answer."""
    cache, jcache = DeviceCache(root, device="cpu"), JaxCache(root, mesh=None)
    target = rng.standard_normal((3, DIM)).astype(np.float32)
    dual = executor.execute_search(cache, _requests(target)[0])
    before = _metric(METRICS, "search.residency_probed_host")
    req, jreq = _requests(target, residency=mode, extra={"window": ROWS})
    got = executor.execute_search(cache, req)
    assert _metric(METRICS, "search.residency_probed_host") == before + 1
    ids_a, d_a = _ids_dists(dual, 3)
    ids_b, d_b = _ids_dists(got, 3)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, atol=1e-5, rtol=1e-5)
    assert dual.column_names == got.column_names  # __CODED_ID__ included
    _against_jax(got, jexecutor.execute_search(jcache, jreq), target, 3)


def test_probed_residency_filtered(root, rng):
    cache, jcache = DeviceCache(root, device="cpu"), JaxCache(root, mesh=None)
    filt = (expr.field("tag") >= 2) & (expr.field("id") < 40000)
    target = rng.standard_normal((3, DIM)).astype(np.float32)
    dual = executor.execute_search(cache, _requests(target, filter=filt)[0])
    req, jreq = _requests(target, filter=filt, residency="int8", extra={"window": ROWS})
    got = executor.execute_search(cache, req)
    np.testing.assert_array_equal(_ids_dists(dual, 3)[0], _ids_dists(got, 3)[0])
    np.testing.assert_allclose(_ids_dists(dual, 3)[1], _ids_dists(got, 3)[1], atol=1e-5, rtol=1e-5)
    assert ((got.column("tag").to_numpy() >= 2) & (got.column("id").to_numpy() < 40000)).all()
    _against_jax(got, jexecutor.execute_search(jcache, jreq), target, 3)


def test_probed_residency_auto_under_budget(root, rng, monkeypatch):
    """auto past the budget serves probed requests on the host; the IVF
    sidecar is written once and a restart memory-maps it, whichever
    package wrote it."""
    cache = DeviceCache(root, device="cpu")
    target = rng.standard_normal((3, DIM)).astype(np.float32)
    dual = executor.execute_search(cache, _requests(target)[0])
    shutil.rmtree(table.int8cache_dir(root, "vec"), ignore_errors=True)  # no sidecar of an earlier test
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(1 << 20))
    req, jreq = _requests(target, extra={"window": ROWS})
    writes = _metric(METRICS, "cache.ivf_sidecar_writes")
    got = executor.execute_search(DeviceCache(root, device="cpu"), req)
    assert _metric(METRICS, "cache.ivf_sidecar_writes") == writes + 1
    np.testing.assert_array_equal(_ids_dists(dual, 3)[0], _ids_dists(got, 3)[0])
    loads = _metric(METRICS, "cache.ivf_sidecar_loads")
    again = executor.execute_search(DeviceCache(root, device="cpu"), req)
    assert _metric(METRICS, "cache.ivf_sidecar_loads") == loads + 1
    np.testing.assert_array_equal(_ids_dists(dual, 3)[0], _ids_dists(again, 3)[0])

    # the JAX package loads the port's sidecar, and the port the JAX package's
    jloads = _metric(JMETRICS, "cache.ivf_sidecar_loads")
    jgot = jexecutor.execute_search(JaxCache(root, mesh=None), jreq)
    assert _metric(JMETRICS, "cache.ivf_sidecar_loads") == jloads + 1
    _against_jax(got, jgot, target, 3)
    port_arrays = DeviceCache(root, device="cpu").host_clustered_int8("c", "vec", "vector")
    shutil.rmtree(table.int8cache_dir(root, "vec"))
    jwrites = _metric(JMETRICS, "cache.ivf_sidecar_writes")
    jarrays = JaxCache(root, mesh=None).host_clustered_int8("c", "vec", "vector")
    assert _metric(JMETRICS, "cache.ivf_sidecar_writes") == jwrites + 1
    loads = _metric(METRICS, "cache.ivf_sidecar_loads")
    arrays = DeviceCache(root, device="cpu").host_clustered_int8("c", "vec", "vector")
    assert _metric(METRICS, "cache.ivf_sidecar_loads") == loads + 1
    for a, b, c in zip(arrays, jarrays, port_arrays):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_probed_residency_default_window_recall(root, rng):
    """The default window (4096 ≫ k) keeps the probed host search's
    recall at 1.0 against the dual probed answer at this size."""
    cache = DeviceCache(root, device="cpu")
    target = rng.standard_normal((4, DIM)).astype(np.float32)
    req = _requests(target, maxval=10, probes=4)[0]
    dual = executor.execute_search(cache, executor.SearchRequest(**{**req.__dict__}))
    got = executor.execute_search(cache, executor.SearchRequest(**{**req.__dict__, "residency": "stream"}))
    assert set(dual.column("id").to_pylist()) == set(got.column("id").to_pylist())


def test_probed_host_search_takes_the_coders_metric(root, rng):
    """With no metric sent, the probed host search ranks and scores with
    the coder's, as the device routes do."""
    cache = DeviceCache(root, device="cpu")
    target = rng.standard_normal((2, DIM)).astype(np.float32)
    req = _requests(target)[0]
    want = executor.execute_search(cache, executor.SearchRequest(**{**req.__dict__, "residency": "int8"}))
    got = executor.execute_search(cache, executor.SearchRequest(**{**req.__dict__, "metric": None,
                                                                   "residency": "int8"}))
    assert got.equals(want)


# -- the probed host no-top-k read -------------------------------------------------


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filtered"])
def test_probed_nomax_over_the_host_corpus(root, rng, monkeypatch, filtered):
    """maxval=None with probes over a host corpus: each query's rows are
    exactly its probe cells' rows that pass the filter, in table order
    (those of the device read and of the JAX package's host read)."""
    cache = DeviceCache(root, device="cpu")
    target = rng.standard_normal((3, DIM)).astype(np.float32)
    filt = (expr.field("tag") < 4) if filtered else None
    req, jreq = _requests(target, maxval=None, probes=2, filter=filt, select=["id", "vector"])
    device = executor.execute_search(cache, req)
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(1 << 20))
    before = _metric(METRICS, "search.residency_host_nomax")
    got = executor.execute_search(cache, req)
    assert _metric(METRICS, "search.residency_host_nomax") == before + 1
    want = jexecutor.execute_search(JaxCache(root, mesh=None), jreq)
    assert got.column_names == want.column_names == ["id", "vector", "__DISTANCE__", "__QUERY_ID__"]
    for other in (want, device):
        assert got.column("id").equals(other.column("id"))
        assert got.column("__QUERY_ID__").equals(other.column("__QUERY_ID__"))
    _check_float64(got, target, 3)
    # the rows: the probe cells' (ranked by topk_cells_np), in table order
    codes = index.load(root, "c", "vec", "vector").column("__CODED_ID__").to_numpy()
    cells = coder.call(target, (root, "c"), maxval=2, device="cpu")
    tags = np.arange(ROWS) % 10
    for qi in range(3):
        rows = np.flatnonzero(np.isin(codes, cells[qi]) & ((tags < 4) if filtered else True))
        np.testing.assert_array_equal(got.column("id").to_numpy()[got.column("__QUERY_ID__").to_numpy() == qi],
                                      rows)


def test_ranges_to_positions_match_jax(rng):
    starts = rng.integers(0, 1000, 50)
    ends = starts + rng.integers(0, 30, 50)
    want = jresidency._ranges_to_positions(starts, ends)
    np.testing.assert_array_equal(residency._ranges_to_positions(starts, ends), want)
    np.testing.assert_array_equal(want, np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)]))
    assert residency._ranges_to_positions(starts[:0], ends[:0]).shape == (0,)


# -- streamed training (test_coder_index.py:347-434) --------------------------------


def test_train_streaming_matches_per_step_oracle(rng):
    """Chunks (several, the last one short) do not change the update
    sequence: the same as per-step Lloyd updates over the same host
    permutation."""
    n, d, books, k, b, epochs, seed = 2048, 8, 2, 4, 64, 2, 7
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    got = kmeans.train_streaming(matrix, seed, num_codebooks=books, codebook_size=k, batch_size=b,
                                 num_epochs=epochs, metric="l2", chunk_rows=384, device="cpu")
    oracle = np.random.default_rng(seed)
    cbs = torch.from_numpy(matrix[oracle.choice(n, k * books, replace=False)].reshape(books, k, d))
    per_step = books * b
    for _ in range(epochs):
        perm = oracle.permutation(n)[: (n // per_step) * per_step]
        for s in range(n // per_step):
            sample = torch.from_numpy(matrix[perm[s * per_step : (s + 1) * per_step]].reshape(books, b, d))
            cbs = kmeans.lloyd_step(cbs, sample, "l2")
    torch.testing.assert_close(got, cbs, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("precision", kmeans.TRANSPORTS)
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_train_streaming_is_the_jax_trainers(rng, precision, metric):
    """The same seed, corpus and chunking give the JAX package's
    train_streaming codebooks, in each transport."""
    n, d = 2048, 8
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    kw = dict(num_codebooks=2, codebook_size=4, batch_size=64, num_epochs=2, metric=metric,
              chunk_rows=384, precision=precision)
    want = np.asarray(jkmeans.train_streaming(matrix, 11, **kw))
    got = kmeans.train_streaming(matrix, 11, device="cpu", **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_train_streaming_int8_transport_pins_to_dequantized_fp32(rng):
    """int8 transport is fp32 streaming over the dequantized corpus (same
    seed, same draws); a prebuilt mirror gives the same run; on a
    clusterable corpus it tracks true fp32 within the quantization noise."""
    n, d = 2048, 8
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    codes, scales = jtopk2.quantize_rows_int8_np(matrix)
    deq = codes.astype(np.float32) * scales[:, None]
    kw = dict(num_codebooks=2, codebook_size=4, batch_size=64, num_epochs=2, metric="l2", chunk_rows=384,
              device="cpu")
    got = kmeans.train_streaming(matrix, 11, precision="int8", **kw)
    torch.testing.assert_close(got, kmeans.train_streaming(deq, 11, **kw), atol=1e-6, rtol=1e-6)
    mirror = kmeans.train_streaming(matrix, 11, precision="int8", int8_mirror=(codes, scales), **kw)
    torch.testing.assert_close(mirror, got, atol=1e-6, rtol=1e-6)
    centers = rng.standard_normal((4, d)).astype(np.float32) * 3
    blob = (centers[rng.integers(0, 4, n)] + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    f32 = kmeans.train_streaming(blob, 11, **kw)
    i8 = kmeans.train_streaming(blob, 11, precision="int8", **kw)
    assert float((i8 - f32).norm() / f32.norm()) < 0.02


def test_train_streaming_bf16_transport_close_to_fp32(rng):
    n, d = 2048, 8
    centers = rng.standard_normal((4, d)).astype(np.float32) * 3
    matrix = (centers[rng.integers(0, 4, n)] + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    kw = dict(num_codebooks=2, codebook_size=4, batch_size=64, num_epochs=1, metric="l2", chunk_rows=384,
              device="cpu")
    f32 = kmeans.train_streaming(matrix, 3, **kw)
    b16 = kmeans.train_streaming(matrix, 3, precision="bf16", **kw)
    assert float((b16 - f32).norm() / f32.norm()) < 0.02


def test_train_streaming_refuses_an_unknown_transport(rng):
    with pytest.raises(ValueError, match="precision"):
        kmeans.train_streaming(rng.standard_normal((64, 4)).astype(np.float32), 0, num_codebooks=1,
                               codebook_size=2, batch_size=8, num_epochs=1, metric="l2", device="cpu",
                               precision="fp16")


@pytest.mark.parametrize("stream_precision", [None, "int8"])
def test_coder_make_streams_past_the_budget(tmp_path, rng, monkeypatch, stream_precision):
    """Past 0.9 × the budget coder.make streams the corpus (int8 when the
    config asks, through the serving cache's mirror, quantized once): the
    JAX package's coder for the seed, and a servable one."""
    monkeypatch.setattr(jmesh, "_SERVING_MESH", None)  # the JAX trainer on one device
    root = str(tmp_path)
    n, d = 4096, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    table.make(root, "t", pa.table({"id": pa.array(np.arange(n)),
                                    "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32())}).to_reader())
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(64 << 10))
    config = {"metric": "l2", "codebook_size": 4, "num_codebooks": 2, "batch_size": 128, "num_epochs": 1}
    if stream_precision:
        config["stream_precision"] = stream_precision
    before = _metric(METRICS, "cache.mirror_rows_quantized")
    got = coder.make(root, "c", "t", "vector", config, seed=0, device="cpu")
    assert _metric(METRICS, "cache.mirror_rows_quantized") == before + (n if stream_precision else 0)
    want = jcoder.make(root, "jc", "t", "vector", config, seed=0)
    np.testing.assert_allclose(got["tensor"], want["tensor"], rtol=1e-5, atol=1e-5 * np.abs(want["tensor"]).max())
    assert got["config"] == dict(config)
    index.make(root, "c", "t", "vector", device="cpu")
    hit = executor.execute_search(DeviceCache(root, device="cpu"), executor.SearchRequest(
        "t", "vector", vecs[17], metric="l2", maxval=1, coding="c", probes=8))
    assert hit.column("id").to_pylist() == [17]
