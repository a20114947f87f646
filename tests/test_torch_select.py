"""fenix_tpu_torch's device filters and no-top-k reads against the JAX
package on the same numpy inputs, on the CPU: the device half of
``expr`` (and its masks through both caches), the selection ops
(``ops/relational.compact_indices``, ``ops/select``), ``maxval=None``
through ``execute_search`` on a root the JAX package trained and indexed
(device residency and the host corpus), filter pushdown on the flat and
clustered layouts, ``probes=0`` with a coder, and the numpy threefry
draws of the k-means trainer against ``jax.random``.

Tolerances: masks, counts, compaction indices and ids exact; cosine and
dot distances within 1e-5 * max(1, d) of JAX's; l2 distances within
1e-4 * max(1, d) of float64 (the port returns ``‖q − v‖``, the JAX
package the expanded form); trained coders within 3.3e-7 of the largest
codebook entry.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import jax
import jax.numpy as jnp

from fenix_tpu import coder as jcoder
from fenix_tpu import expr as jexpr
from fenix_tpu import index as jindex
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu.ops import kmeans as jkmeans
from fenix_tpu.ops import relational as jrelational
from fenix_tpu.ops import select as jselect
from fenix_tpu.parallel import mesh as jmesh
from fenix_tpu_torch import coder, expr
from fenix_tpu_torch.engine import executor, session
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.ops import kmeans, relational
from fenix_tpu_torch.ops import select as select_ops
from fenix_tpu_torch.utils import threefry
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

torch.set_num_threads(2)

ROWS, DIM, BLOCK = 3_000, 16, 256
CONFIG = {"metric": "l2", "codebook_size": 4, "num_codebooks": 2, "batch_size": 512, "num_epochs": 2}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One table with bool, int8, int64 (one past int32), float32, float64
    and string columns, and a coder and index the JAX package built."""
    rng = np.random.default_rng(13)
    root = str(tmp_path_factory.mktemp("select_root"))
    vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    vecs[1500:1520] = vecs[:20]  # exact duplicates
    big = rng.integers(0, 100, ROWS)
    big[7] = 1 << 40
    table.make(root, "t", pa.table({
        "id": pa.array(np.arange(ROWS)),
        "tag": pa.array(rng.integers(0, 5, ROWS)),
        "small": pa.array(rng.integers(-100, 100, ROWS).astype(np.int8)),
        "flag": pa.array(rng.random(ROWS) < 0.3),
        "score": pa.array(rng.standard_normal(ROWS).astype(np.float32)),
        "wide": pa.array(rng.standard_normal(ROWS)),
        "big": pa.array(big),
        "name": pa.array([f"row-{i}" for i in range(ROWS)]),
        "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32()),
    }).to_reader(max_chunksize=1000))
    jcoder.make(root, "c", "t", "vector", CONFIG, seed=0)
    jindex.make(root, "c", "t", "vector")
    return root


def jax_filter(filt):
    return None if filt is None else jexpr.Expr.from_dict(filt.to_dict())


# -- expr: the device half -------------------------------------------------------

f = expr.field
DEVICE_PREDICATES = [
    f("tag") == 3,
    f("tag") != 3,
    f("tag") < 2,
    f("tag") <= 2,
    f("tag") > 2,
    f("tag") >= 4,
    (f("tag") >= 1) & (f("id") < 900),
    (f("tag") == 0) | (f("id") > 2500),
    ~(f("tag") == 0),
    f("id").isin([1, 5, 9, 100, 600, 1500]),
    f("tag").isin([2, 4]) & ~f("flag"),
    f("score") > 0.25,  # f32-exact literal on an f32 column
    f("score") < 0,  # int literal on an f32 column
    f("tag") < 2.5,  # float literal on an int column: compared in float32
    (f("id") % 7) == 2,
    (f("id") + f("tag")) % 5 == 1,
    (f("score") * 2 - 1).abs() < 0.5,
    (f("id") - 1500).abs() <= 100,
    f("id") * 3 > 4000,
    (f("score") % 0.5) < 0.25,
    f("small") < 50,  # int8 column
    f("flag") == True,  # noqa: E712 — a bool column against a bool literal
    (f("small") * f("tag")) >= -60,
]
REFUSED = [
    (f("tag") / 2) < 1,  # true division runs in f64 on the host
    f("name").starts_with("row-1"),
    f("score").is_null(),
    f("wide") > 0,  # float64 column
    f("id") < 2**31,  # literal past int32
    f("score") > 0.1,  # not f32-exact
    f("id").isin([1, 2**40]),
]


@pytest.mark.parametrize("filt", DEVICE_PREDICATES, ids=[p.to_json() for p in DEVICE_PREDICATES])
def test_device_mask_matches_jax_and_host(root, filt):
    data = table.load(root, "t")
    assert filt.device_evaluable(data.schema) == jax_filter(filt).device_evaluable(data.schema) is True
    skeleton, literals = filt.split_literals()
    jskeleton, jliterals = jax_filter(filt).split_literals()
    assert skeleton.to_json() == jskeleton.to_json()
    assert [(type(v), v) for v in literals] == [(type(v), v) for v in jliterals]
    assert filt.fields() == jax_filter(filt).fields()
    got = DeviceCache(root, block=BLOCK, device="cpu").device_filter_mask("t", filt)
    assert got.dtype == torch.bool and got.shape == (3072,)
    np.testing.assert_array_equal(got.numpy()[:ROWS], filt.mask(data))
    want = JaxCache(root, block=BLOCK, mesh=None).device_filter_mask("t", jax_filter(filt))
    if "flag" in filt.fields():
        # the JAX package's zero-copy column read refuses Arrow's bit-packed
        # bools, so it answers bool predicates from the host mask
        assert want is None
    else:
        np.testing.assert_array_equal(got.numpy()[:ROWS], np.asarray(want)[:ROWS])


@pytest.mark.parametrize("filt", REFUSED, ids=[p.to_json() for p in REFUSED])
def test_refused_predicates_match_jax(root, filt):
    data = table.load(root, "t")
    assert filt.device_evaluable(data.schema) is jax_filter(filt).device_evaluable(data.schema) is False
    try:
        jskeleton, jliterals = jax_filter(filt).split_literals()
    except OverflowError:  # a literal past int32 has no slot in either package
        with pytest.raises(OverflowError):
            filt.split_literals()
        return
    skeleton, literals = filt.split_literals()
    assert skeleton.to_json() == jskeleton.to_json() and len(literals) == len(jliterals)


def test_device_mask_refuses_columns_past_int32(root):
    """An int64 column with a value past int32 has no device form: both
    packages return no mask and the host mask answers."""
    filt = f("big") > 50
    assert filt.device_evaluable(table.load(root, "t").schema)
    assert DeviceCache(root, device="cpu").device_filter_mask("t", filt) is None
    assert JaxCache(root, mesh=None).device_filter_mask("t", jax_filter(filt)) is None


# -- ops: compaction, counts, chunks ---------------------------------------------


@pytest.mark.parametrize("width", [None, 7, 64])
def test_compact_indices_match_jax(rng, width):
    mask = rng.random((5, 64)) < 0.3
    mask[2] = False
    got_idx, got_count = relational.compact_indices(torch.from_numpy(mask), width)
    want_idx, want_count = jrelational.compact_indices(jnp.asarray(mask), width=width)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_count.numpy(), np.asarray(want_count))
    one, n = relational.compact(torch.from_numpy(mask[0]))
    np.testing.assert_array_equal(one.numpy()[: int(n)], np.flatnonzero(mask[0]))


def _select_inputs(rng, n_pad=4096, rows=4000, q=3, p=5, cells=40):
    fmask = rng.random(n_pad) < 0.6
    coded = rng.integers(0, cells, n_pad).astype(np.int32)
    coded[rows:] = -1
    probes = np.stack([rng.choice(cells, p, replace=False) for _ in range(q)])
    probes = np.sort(probes, axis=1).astype(np.int32)
    return fmask, coded, probes, rows


def test_count_selected_match_jax(rng):
    fmask, coded, probes, rows = _select_inputs(rng)
    assert select_ops.chunk_for(4096, 3, 1024) == jselect.chunk_for(4096, 3, 1024) == 1024
    assert select_ops.chunk_for(1 << 20, 64, 16384) == jselect.chunk_for(1 << 20, 64, 16384)
    got = select_ops.count_selected_mask(torch.from_numpy(fmask), rows, chunk=512)
    want = jselect.count_selected_mask(jnp.asarray(fmask), jnp.int32(rows), chunk=512)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for fm in (fmask, None):
        got = select_ops.count_selected_probed(
            None if fm is None else torch.from_numpy(fm), torch.from_numpy(coded), torch.from_numpy(probes),
            rows, chunk=256)
        want = jselect.count_selected_probed(
            None if fm is None else jnp.asarray(fm), jnp.asarray(coded), jnp.asarray(probes),
            jnp.int32(rows), chunk=256)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_count_selected_probed_in_several_spans(rng, monkeypatch):
    fmask, coded, probes, rows = _select_inputs(rng)
    args = (torch.from_numpy(fmask), torch.from_numpy(coded), torch.from_numpy(probes), rows)
    whole = select_ops.count_selected_probed(*args, chunk=256)
    monkeypatch.setattr(select_ops, "_MEMBER_ENTRIES", 3 * 256)  # one chunk a span
    np.testing.assert_array_equal(select_ops.count_selected_probed(*args, chunk=256).numpy(), whole.numpy())


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("probed", [False, True], ids=["filter", "probed"])
def test_compact_chunk_matches_jax(rng, metric, probed):
    fmask, coded, probes, rows = _select_inputs(rng)
    corpus = rng.standard_normal((4096, DIM)).astype(np.float32)
    queries = rng.standard_normal((3, DIM)).astype(np.float32)
    for start in (0, 3072):  # a full chunk and the one holding the padding rows
        kw = dict(metric=metric, chunk=1024, width=512)
        got_ids, got_d = select_ops.compact_chunk(
            torch.from_numpy(corpus), torch.from_numpy(queries), torch.from_numpy(fmask),
            torch.from_numpy(coded) if probed else None, torch.from_numpy(probes) if probed else None,
            start, rows, **kw)
        want_ids, want_d = jselect.compact_chunk(
            jnp.asarray(corpus), jnp.asarray(queries), jnp.asarray(fmask),
            jnp.asarray(coded) if probed else None, jnp.asarray(probes) if probed else None,
            jnp.int32(start), jnp.int32(rows), **kw)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        got_d, want_d = got_d.numpy(), np.asarray(want_d)
        assert np.array_equal(np.isinf(got_d), np.isinf(want_d))
        fin = np.isfinite(want_d)
        if metric == "l2":
            ids = got_ids.numpy()
            want_d = np.linalg.norm(corpus[np.where(ids >= 0, ids, 0)].astype(np.float64)
                                    - queries[:, None, :], axis=-1)
        tol = 1e-4 if metric == "l2" else 1e-5
        assert (np.abs(got_d[fin] - want_d[fin]) <= tol * np.maximum(1.0, np.abs(want_d[fin]))).all()


# -- maxval=None through execute_search -----------------------------------------


def _both(root, jax_cache=None, **kw):
    req = dict(source="t", column="vector", maxval=None, **kw)
    got = executor.execute_search(DeviceCache(root, block=BLOCK, device="cpu"), executor.SearchRequest(**req))
    req["filter"] = jax_filter(req.get("filter"))
    want = jexecutor.execute_search(jax_cache or JaxCache(root, block=BLOCK, mesh=None),
                                    jexecutor.SearchRequest(**req))
    return got, want


def assert_nomax_match(root, got, want, target, metric):
    """Same schema and every column but the distance equal; distances
    within 1e-5 * max(1, d) of JAX's (cosine, dot) or 1e-4 * max(1, d) of
    float64 (l2)."""
    assert got.schema == want.schema
    for name in want.column_names:
        if name != "__DISTANCE__":
            assert got.column(name).equals(want.column(name)), name
    d = got.column("__DISTANCE__").to_numpy()
    if metric == "l2":
        vecs = ingest.fixed_size_list_to_numpy(table.load(root, "t").column("vector")).astype(np.float64)
        qid = got.column("__QUERY_ID__").to_numpy() if "__QUERY_ID__" in got.column_names else 0
        want_d = np.linalg.norm(vecs[got.column("id").to_numpy()] - np.atleast_2d(target)[qid], axis=1)
        tol = 1e-4
    else:
        want_d, tol = want.column("__DISTANCE__").to_numpy(), 1e-5
    assert (np.abs(d - want_d) <= tol * np.maximum(1.0, np.abs(want_d))).all()


NOMAX = [
    # name, queries, metric, filter, probes, select
    ("filtered_l2", 2, "l2", (f("tag") == 2) | (f("id") < 50), None, None),
    ("filtered_cosine", 3, "cosine", f("score") > 0.25, None, ["id", "score"]),
    ("filtered_dot_host_route", 2, "dot", f("name").ends_with("7"), None, ["id"]),
    ("probed", 3, "l2", f("id") < 2_500, 4, None),
    ("probed_no_filter", 1, "l2", None, 3, ["id", "__CODED_ID__"]),
    ("large_q", 150, "l2", f("tag") == 1, None, ["id"]),
    ("full_read_q1", 1, "l2", None, None, None),
    ("full_read_q3", 3, "cosine", None, None, ["id", "tag"]),
]


@pytest.mark.parametrize("name,q,metric,filt,probes,select", NOMAX, ids=[c[0] for c in NOMAX])
@pytest.mark.parametrize("block", [BLOCK, None], ids=["chunked", "one_chunk"])
def test_nomax_matches_jax(root, monkeypatch, name, q, metric, filt, probes, select, block):
    if block is not None:  # several row chunks: chunk-major concatenation
        monkeypatch.setattr(executor, "_NOMAX_BLOCK", block)
    target = np.random.default_rng(q).standard_normal((q, DIM)).astype(np.float32)
    target = target[0] if q == 1 else target
    kw = dict(target=target, metric=metric, filter=filt, select=select)
    if probes is not None:
        kw.update(coding="c", probes=probes)
    got, want = _both(root, **kw)
    assert got.num_rows == want.num_rows > 0
    assert_nomax_match(root, got, want, target, metric)


def test_nomax_rows_are_the_filter_and_probe_oracle(root):
    """Mirrors tests/test_nomax_stream.py: each query's rows are those of
    the filter AND the query's probe cells, in table order."""
    target = np.random.default_rng(4).standard_normal((3, DIM)).astype(np.float32)
    filt = f("id") < 2_500
    got, _ = _both(root, target=target, metric="l2", filter=filt, coding="c", probes=4)
    cache = DeviceCache(root, device="cpu")
    data = cache.coded_table("c", "t", "vector")
    codes = data.column("__CODED_ID__").to_numpy()
    cells, _ = executor._rank_cells(cache, "c", target, "l2", 4)
    for qi in range(3):
        keep = filt.mask(data) & np.isin(codes, cells[qi])
        part = got.filter(pc.equal(got.column("__QUERY_ID__"), qi))
        assert part.column("id").to_pylist() == np.flatnonzero(keep).tolist()


def test_nomax_empty_selection(root):
    for q in (1, 2):
        target = np.zeros((q, DIM), np.float32)
        got, want = _both(root, target=target, metric="l2", filter=f("id") < 0)
        assert got.num_rows == 0 and got.schema == want.schema


def test_nomax_over_the_host_corpus(root, monkeypatch):
    """Under a budget the fp32 matrix does not fit, maxval=None reads the
    host corpus (counted as search.residency_host_nomax) and answers as
    the device read does, probed or not."""
    cache = DeviceCache(root, block=BLOCK, device="cpu")
    target = np.random.default_rng(8).standard_normal((3, DIM)).astype(np.float32)
    for metric, filt in (("l2", f("tag") == 4), ("cosine", f("name").starts_with("row-2")), ("dot", None)):
        req = executor.SearchRequest("t", "vector", target, metric=metric, filter=filt, select=["id", "tag"])
        dual = executor.execute_search(cache, req)
        monkeypatch.setenv("FENIX_HBM_BUDGET", str(1 << 16))
        before = METRICS.snapshot().get("search.residency_host_nomax", 0)
        host = executor.execute_search(cache, req)
        assert METRICS.snapshot()["search.residency_host_nomax"] - before == 1
        monkeypatch.delenv("FENIX_HBM_BUDGET")
        assert host.schema == dual.schema and host.column("id").equals(dual.column("id"))
        np.testing.assert_allclose(host.column("__DISTANCE__").to_numpy(),
                                   dual.column("__DISTANCE__").to_numpy(), rtol=1e-5, atol=1e-5)
    # the probed host read: the probe cells' rows that pass the filter
    req = executor.SearchRequest("t", "vector", target, metric="l2", coding="c", probes=2,
                                 filter=f("tag") == 4, select=["id", "tag"])
    device = executor.execute_search(cache, req)
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(1 << 16))
    host = executor.execute_search(cache, req)
    assert host.column("id").equals(device.column("id")) and 0 < host.num_rows < device.num_rows + 1
    np.testing.assert_allclose(host.column("__DISTANCE__").to_numpy(),
                               device.column("__DISTANCE__").to_numpy(), rtol=1e-5, atol=1e-5)


# -- filter pushdown -----------------------------------------------------------------

PUSHDOWN = [
    f("tag") == 3,
    (f("tag") >= 1) & (f("id") < 900),
    f("id").isin([1, 5, 9, 100, 600, 1500]),
    f("score") > 0.25,
    (f("id") % 7) == 2,
    ~(f("tag") == 0),
]


def _routes():
    snap = METRICS.snapshot()
    return snap.get("filter.device_pushdown", 0), snap.get("filter.host_upload", 0)


def _topk_both(root, filt, q=3, **kw):
    target = np.random.default_rng(3).standard_normal((q, DIM)).astype(np.float32)
    req = dict(source="t", column="vector", metric="l2", target=target, maxval=8, filter=filt, **kw)
    before = _routes()
    got = executor.execute_search(DeviceCache(root, block=BLOCK, device="cpu"), executor.SearchRequest(**req))
    after = _routes()
    req["filter"] = jax_filter(filt)
    want = jexecutor.execute_search(JaxCache(root, block=BLOCK, mesh=None), jexecutor.SearchRequest(**req))
    assert got.column("id").equals(want.column("id"))
    np.testing.assert_allclose(got.column("__DISTANCE__").to_numpy(), want.column("__DISTANCE__").to_numpy(),
                               rtol=1e-4, atol=1e-4)
    return got, (after[0] - before[0], after[1] - before[1])


@pytest.mark.parametrize("filt", PUSHDOWN, ids=[p.to_json() for p in PUSHDOWN])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_pushdown_flat_matches_jax_and_uploads_nothing(root, filt, precision):
    got, rises = _topk_both(root, filt, precision=precision)
    assert rises == (1, 0)
    mask = filt.mask(table.load(root, "t"))
    assert all(mask[i] for i in got.column("id").to_pylist())


def test_pushdown_clustered_matches_jax(root):
    """The clustered layout permutes the device mask into its sorted order
    on the card (session.clustered_perm)."""
    before = METRICS.snapshot().get("search.ivf_clustered", 0)
    got, rises = _topk_both(root, f("tag") == 2, q=1, coding="c", probes=2)
    assert METRICS.snapshot()["search.ivf_clustered"] - before == 1
    assert rises == (1, 0) and set(got.column("tag").to_pylist()) == {2}


@pytest.mark.parametrize("filt", [f("name").starts_with("row-1"), f("score") > 0.1, f("big") > 50],
                         ids=["string", "f64-literal", "int64-past-int32"])
def test_host_route_still_answers(root, filt):
    got, rises = _topk_both(root, filt)
    assert rises == (0, 1)


def test_parametric_literals_share_one_skeleton(root):
    cache = DeviceCache(root, block=BLOCK, device="cpu")
    session._mask_eval_fn.cache_clear()
    builds = cache.device_mask_builds
    for threshold in (100, 200, 300, 400, 100):
        m = cache.device_filter_mask("t", f("id") < threshold)
        assert int(m[:ROWS].sum()) == threshold
    info = session._mask_eval_fn.cache_info()
    assert info.misses == 1 and info.hits == 3, info
    assert cache.device_mask_builds - builds == 4  # the repeated predicate is memoized


# -- probes=0 with a coder -------------------------------------------------------------


@pytest.mark.parametrize("q", [1, 8])
def test_probes_zero_is_the_exact_search_over_the_coded_table(root, q):
    target = np.random.default_rng(q).standard_normal((q, DIM)).astype(np.float32)
    req = dict(source="t", column="vector", target=target, metric="l2", maxval=5, coding="c", probes=0)
    got = executor.execute_search(DeviceCache(root, device="cpu"), executor.SearchRequest(**req))
    want = jexecutor.execute_search(JaxCache(root, mesh=None), jexecutor.SearchRequest(**req))
    assert "__CODED_ID__" in got.column_names and got.schema == want.schema
    assert got.column("id").equals(want.column("id"))
    exact = executor.execute_search(DeviceCache(root, device="cpu"),
                                    executor.SearchRequest(**{**req, "coding": None, "probes": None}))
    assert got.column("id").equals(exact.column("id"))


# -- the k-means draws: numpy threefry against jax.random ------------------------


@pytest.mark.parametrize("n", [1, 2, 10, 1000, 100_003, (1 << 20) + 7])
def test_threefry_permutation_matches_jax(n):
    for seed in (0, 123_456_789):
        key = jax.random.PRNGKey(np.uint32(seed))
        assert tuple(int(v) for v in np.asarray(key)) == threefry.prng_key(seed)
        np.testing.assert_array_equal(threefry.permutation(threefry.prng_key(seed), n),
                                      np.asarray(jax.random.permutation(key, n)))


def test_threefry_split_and_bits_match_jax():
    assert jax.config.jax_threefry_partitionable  # the mode the numpy copy follows
    key = jax.random.PRNGKey(np.uint32(7))
    keys = [tuple(int(v) for v in k) for k in np.asarray(jax.random.split(key, 5))]
    assert keys == threefry.split(threefry.prng_key(7), 5)
    np.testing.assert_array_equal(threefry.random_bits(keys[3], 200_000),
                                  np.asarray(jax.random.bits(jnp.asarray(keys[3], jnp.uint32), (200_000,))))
    assert [threefry.shuffle_rounds(n) for n in (1, 2, 1 << 20, 8_388_608)] == [0, 1, 2, 3]


def test_draw_indices_are_the_jax_trainers_draws():
    """The rows fenix_tpu/ops/kmeans.py:train reads for a seed."""
    n, seed, nc, cs, bs, ne = 5_000, 11, 2, 8, 128, 3
    init, epochs = kmeans.draw_indices(n, seed, nc, cs, bs, ne)
    key = jax.random.PRNGKey(np.uint32(seed))
    key, init_key = jax.random.split(key)
    np.testing.assert_array_equal(init.numpy(), np.asarray(
        jax.random.choice(init_key, n, (nc * cs,), replace=False)))
    steps = n // (nc * bs)
    for got, ekey in zip(epochs, jax.random.split(key, ne), strict=True):
        want = np.asarray(jax.random.permutation(ekey, n))[: steps * nc * bs].reshape(steps, nc, bs)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_port_coder_is_the_jax_coder_of_the_seed(tmp_path, monkeypatch, metric):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4_000, DIM)).astype(np.float32)
    x[:2000] += 2.0
    root = str(tmp_path)
    table.make(root, "t", pa.table({"vector": ingest.numpy_to_fixed_size_list(x, pa.float32())}).to_reader())
    cfg = {**CONFIG, "metric": metric, "codebook_size": 8}
    # the JAX package's single-device trainer (its serving mesh would
    # train sharded, with per-shard sampling)
    monkeypatch.setattr(jmesh, "_SERVING_MESH", None)
    got = coder.make(root, "port", "t", "vector", cfg, seed=5, device="cpu")["tensor"]
    want = jcoder.make(root, "jax", "t", "vector", cfg, seed=5)["tensor"]
    assert np.abs(got - want).max() <= 3.3e-7 * np.abs(want).max()
    direct = np.asarray(jkmeans.train(jnp.asarray(x), np.uint32(5), 2, 8, 512, 2, metric))
    np.testing.assert_array_equal(want, direct)
