"""fenix_tpu_torch's multi-device serving against the JAX package's, on
the CPU.

The port's mesh is S shards on ``cpu`` (``make_mesh(devices=["cpu"] *
S)``), the JAX package's S of the virtual CPU devices the suite forces
(``tests/conftest.py``); both caches sit on one root and take the same
numpy inputs. The cases are those of ``test_serving_mesh.py``,
``test_parallel.py``, ``test_ring.py``, ``test_residency_mesh.py`` and
``test_incremental_cache.py::test_incremental_refresh_under_mesh``, plus
the ``threefry`` draws that ``train_sharded`` adds, bit for bit against
``jax.random``.

Tolerances: ids exact against the JAX mesh's answer and the port's
single-device answer, in order (against one device with the rows whose
fp32 distances tie put in id order, since the mesh merges by (distance,
id) and one device orders by score; a result of 2,000 rows against the
JAX mesh per query as a set, its far rows tying within fp32); distances
within 1e-5 · max(1, d) (the two packages sum fp32 products in other
orders), against the JAX package's l2 plus 4e-4 · ‖q‖, the cancellation
of its expanded form sqrt(‖q‖² − s) where the port returns ‖q − v‖;
refresh counters equal; a ``train_sharded`` coder within 3.3e-7 of its largest
entry of the JAX package's for the same seed and shard count (fp32 sums
in another order). The JAX serving mesh is pinned per test with
``monkeypatch``, so no test leaks a mesh into its worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from fenix_tpu import coder as jcoder
from fenix_tpu import expr as jexpr
from fenix_tpu import index as jindex
from fenix_tpu.engine import analytics as janalytics
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine import residency as jresidency
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu.ops import kmeans as jkmeans
from fenix_tpu.ops import topk2 as jtopk2
from fenix_tpu.parallel import mesh as jmesh
from fenix_tpu.parallel import search as jsearch
from fenix_tpu.utils.metrics import GLOBAL as JMETRICS
from tests import oracles
from fenix_tpu_torch import expr
from fenix_tpu_torch import index as index_mod
from fenix_tpu_torch.engine import analytics, executor, residency
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.ops import kmeans, topk2
from fenix_tpu_torch.parallel import mesh as mesh_mod
from fenix_tpu_torch.parallel import search as psearch
from fenix_tpu_torch.utils import threefry
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

torch.set_num_threads(2)

S = 4  # shards of the port's and the JAX package's meshes
DIM = 32
CONFIG = {"metric": "l2", "codebook_size": 4, "num_codebooks": 2, "batch_size": 512, "num_epochs": 2}


@pytest.fixture(autouse=True)
def _one_device_jax(monkeypatch):
    """The JAX package's process-wide serving mesh stays unset (its coder
    trains on one device) unless a test builds a mesh itself."""
    monkeypatch.setattr(jmesh, "_SERVING_MESH", None)


def port_mesh(n: int = S, model_parallel: int = 1) -> mesh_mod.Mesh:
    return mesh_mod.make_mesh(devices=["cpu"] * n, model_parallel=model_parallel)


def jax_mesh(n: int = S, model_parallel: int = 1):
    return jmesh.make_mesh(devices=jax.devices()[:n], model_parallel=model_parallel)


def _table(vecs: np.ndarray, tags: np.ndarray) -> pa.Table:
    return pa.table({
        "id": pa.array(np.arange(vecs.shape[0])),
        "tag": pa.array(tags),
        "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32()),
    })


def _caches(root: str, block: int, n: int = S, model_parallel: int = 1):
    """(JAX mesh, port mesh, port single device) caches on ``root``."""
    return (
        JaxCache(root, block=block, mesh=jax_mesh(n, model_parallel)),
        DeviceCache(root, block=block, device="cpu", mesh=port_mesh(n, model_parallel)),
        DeviceCache(root, block=block, device="cpu", mesh=None),
    )


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """``test_serving_mesh.py``'s root: 3,000 x 32 rows in two clusters,
    an IVF coder (2 x 4) and its index, built by the JAX package."""
    rng = np.random.default_rng(11)
    path = str(tmp_path_factory.mktemp("mesh_root"))
    vecs = rng.standard_normal((3000, DIM)).astype(np.float32)
    vecs[1000:] += 4.0
    table.make(path, "t", _table(vecs, rng.integers(0, 5, 3000)).to_reader())
    jmesh._SERVING_MESH = None
    jcoder.make(path, "c", "t", "vector", CONFIG, seed=0)
    jindex.make(path, "c", "t", "vector")
    jmesh._SERVING_MESH = "unset"
    return path


@pytest.fixture(scope="module")
def caches(root):
    return _caches(root, block=128)


def _filters(pred):
    """The same predicate in both packages' ``expr``: ``(column, op,
    value)`` or None."""
    if pred is None:
        return None, None
    name, op, value = pred
    ops = {"==": lambda f: f == value, "<": lambda f: f < value, "!=": lambda f: f != value}
    return ops[op](jexpr.field(name)), ops[op](expr.field(name))


def _search(cache, pred=None, **kw):
    module = executor if isinstance(cache, DeviceCache) else jexecutor
    jf, pf = _filters(pred)
    kw.setdefault("source", "t")
    kw.setdefault("column", "vector")
    kw.setdefault("metric", "l2")
    return module.execute_search(cache, module.SearchRequest(filter=pf if module is executor else jf, **kw))


def _qids(t: pa.Table) -> np.ndarray:
    if "__QUERY_ID__" in t.column_names:
        return t.column("__QUERY_ID__").to_numpy()
    return np.zeros(t.num_rows, np.int64)


def _tie_order(t: pa.Table) -> np.ndarray:
    """Row order of ``t`` with each query's rows put in (distance, id)
    order: ties of equal fp32 distance in id order."""
    return np.lexsort((t.column("id").to_numpy(), t.column("__DISTANCE__").to_numpy(), _qids(t)))


def assert_mesh_answer(got: pa.Table, single: pa.Table, want_jax: pa.Table, ordered: bool = True,
                       l2_target: "np.ndarray | None" = None) -> None:
    """The port's mesh answer ``got`` against the port's single-device
    answer (ids in order up to fp32 distance ties, distances within 1e-5)
    and the JAX mesh's (ids in order, or per query as a set when
    ``ordered`` is False; distances within 1e-5, plus, for an l2 search of
    ``l2_target``, the cancellation of the JAX package's expanded l2 form,
    about sqrt(ε)·‖q‖: the port returns ‖q − v‖)."""
    assert got.column_names == single.column_names == want_jax.column_names
    ids, d = got.column("id").to_numpy(), got.column("__DISTANCE__").to_numpy()
    g, s = _tie_order(got), _tie_order(single)
    np.testing.assert_array_equal(ids[g], single.column("id").to_numpy()[s])
    np.testing.assert_allclose(d[g], single.column("__DISTANCE__").to_numpy()[s], rtol=1e-5, atol=1e-5)
    for name in got.column_names:
        if name not in ("id", "__DISTANCE__", "vector"):
            assert got.column(name).to_numpy()[g].tolist() == single.column(name).to_numpy()[s].tolist()
    want_ids, want_d = want_jax.column("id").to_numpy(), want_jax.column("__DISTANCE__").to_numpy()
    a, b = np.arange(ids.shape[0]), np.arange(want_ids.shape[0])
    if not ordered:
        a, b = np.lexsort((ids, _qids(got))), np.lexsort((want_ids, _qids(want_jax)))
    np.testing.assert_array_equal(ids[a], want_ids[b])
    slack = 1e-5 * np.maximum(1.0, np.abs(d[a]))
    if l2_target is not None:
        slack = slack + 4e-4 * np.linalg.norm(np.atleast_2d(l2_target), axis=1)[_qids(got)[a]]
    np.testing.assert_array_less(np.abs(d[a] - want_d[b]), slack)


def _three(caches, **kw):
    jax_c, mesh_c, single_c = caches
    return _search(mesh_c, **kw), _search(single_c, **kw), _search(jax_c, **kw)


def _l2(kw: dict) -> "np.ndarray | None":
    """The target of an l2 search (for the JAX l2 slack), else None."""
    return kw["target"] if kw.get("metric", "l2") == "l2" else None


# -- test_serving_mesh.py -----------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [
        dict(maxval=10),
        dict(maxval=10, metric="cosine"),
        dict(maxval=10, metric="dot"),
        dict(maxval=7, pred=("tag", "==", 2)),
        dict(maxval=10, precision="bf16"),
        dict(maxval=10, precision="int8"),
        dict(maxval=5, coding="c", probes=3),
        dict(maxval=5, coding="c", probes=3, pred=("tag", "<", 3)),
        dict(maxval=2000),  # k > rows a shard: the merge pads local candidates
        dict(maxval=None, pred=("tag", "==", 2)),
        dict(maxval=None, coding="c", probes=2),
        dict(maxval=None),
    ],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()),
)
def test_sharded_equals_single_device(caches, rng, kw):
    target = rng.standard_normal((4, DIM)).astype(np.float32)
    got, single, want = _three(caches, target=target, **kw)
    assert_mesh_answer(got, single, want, ordered=kw["maxval"] is not None and kw["maxval"] <= 10,
                       l2_target=_l2({"target": target, **kw}))


def test_sharded_single_query_table(caches, rng):
    target = rng.standard_normal(DIM).astype(np.float32)
    got, single, want = _three(caches, target=target, maxval=10)
    assert_mesh_answer(got, single, want, l2_target=target)
    assert "__QUERY_ID__" not in got.column_names


def test_sharded_batched_dispatch(caches, rng):
    """Coalesced requests through the mesh: each member's table is its
    solo single-device one and the JAX mesh's batched one."""
    jax_c, mesh_c, single_c = caches
    targets = [rng.standard_normal(s).astype(np.float32) for s in ((3, DIM), (DIM,), (2, DIM))]

    def reqs(module):
        return [module.SearchRequest("t", "vector", t, metric="l2", maxval=m) for t, m in zip(targets, (4, 9, 6))]

    got = executor.execute_search_batched(mesh_c, reqs(executor))
    want = jexecutor.execute_search_batched(jax_c, reqs(jexecutor))
    for g, w, r in zip(got, want, reqs(executor)):
        assert_mesh_answer(g, executor.execute_search(single_c, r), w, l2_target=r.target)


def test_sharded_batched_probed(caches, rng):
    jax_c, mesh_c, single_c = caches
    targets = [rng.standard_normal((2, DIM)).astype(np.float32) for _ in range(3)]

    def reqs(module):
        return [module.SearchRequest("t", "vector", t, metric="l2", maxval=4, coding="c", probes=3) for t in targets]

    got = executor.execute_search_batched(mesh_c, reqs(executor))
    want = jexecutor.execute_search_batched(jax_c, reqs(jexecutor))
    for g, w, r in zip(got, want, reqs(executor)):
        assert_mesh_answer(g, executor.execute_search(single_c, r), w, l2_target=r.target)


@pytest.mark.parametrize(
    "aggspec",
    [None, {"group_by": "tag", "agg": "count", "max_groups": 16}, {"group_by": "tag", "agg": "sum", "value": "id",
                                                                   "max_groups": 16}],
    ids=["enrich", "count", "sum"],
)
def test_mesh_joins_raise(caches, rng, aggspec):
    """Joins and aggregates over a mesh (the test's name is from when they
    raised) answer as the JAX mesh and one device do: the fused route joined
    to the search table itself, enrichment rows in order up to fp32 ties,
    integer aggregates equal and int64. ``tests/test_torch_mesh_analytics.py``
    holds the routes and placements."""
    jax_c, mesh_c, single_c = caches
    target = rng.standard_normal((2, DIM)).astype(np.float32)
    got, single, want = (
        amod.execute_search_join(
            cache, module.SearchRequest("t", "vector", target, metric="l2", maxval=5, select=["id"]),
            amod.JoinSpec(source="t", right_on="id"),
            amod.AggregateSpec.from_dict(aggspec) if aggspec else None,
        )
        for cache, module, amod in ((mesh_c, executor, analytics), (single_c, executor, analytics),
                                    (jax_c, jexecutor, janalytics))
    )
    if aggspec is None:
        assert_mesh_answer(got, single, want, l2_target=target)
    else:
        assert got.schema.field("__AGG__").type == pa.int64()
        assert got.equals(single) and got.to_pylist() == want.to_pylist()


def test_mesh_env(root, monkeypatch):
    """``FENIX_MESH`` off / <n> / auto over a stubbed card count, resolved
    once per process; a CPU cache has no serving mesh."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for env, size in (("off", None), ("2", 2), ("auto", 4), ("9", 4)):
        monkeypatch.setattr(mesh_mod, "_SERVING_MESH", "unset")
        monkeypatch.setenv("FENIX_MESH", env)
        got = DeviceCache(root, device="cuda").mesh
        assert (got.size if got is not None else None) == size
        if got is not None:
            assert got.devices == [torch.device("cuda", i) for i in range(size)]
            assert got.shape == {"data": size, "model": 1}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_mod.serving_mesh() is not None  # resolved once: the count is not read again
    monkeypatch.setattr(mesh_mod, "_SERVING_MESH", "unset")
    monkeypatch.setenv("FENIX_MESH", "auto")
    assert mesh_mod.serving_mesh() is None  # one card: no mesh
    assert DeviceCache(root, device="cpu").mesh is None
    monkeypatch.setattr(mesh_mod, "_SERVING_MESH", "unset")


def test_sharded_clustered_ivf_route(tmp_path, rng):
    """Selective probes over many rows take the per-shard clustered
    gather, answer as one device and the JAX mesh do, and build the layout
    once per revision however filters and probes interleave."""
    root = str(tmp_path)
    n, d = 65_536, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs += (np.arange(n)[:, None] % 16) * 2.0
    table.make(root, "big", _table(vecs, np.arange(n) % 5).to_reader())
    cfg = {"metric": "l2", "codebook_size": 4, "num_codebooks": 2, "batch_size": 1024, "num_epochs": 1}
    jcoder.make(root, "cc", "big", "vector", cfg, seed=0)
    jindex.make(root, "cc", "big", "vector")
    jax_c, mesh_c, single_c = _caches(root, block=1024)
    for pred in (None, ("tag", "==", 2)):
        target = rng.standard_normal(d).astype(np.float32)
        kw = dict(source="big", coding="cc", probes=2, maxval=8, target=target, pred=pred)
        before = METRICS.snapshot().get("search.ivf_clustered", 0)
        got = _search(mesh_c, **kw)
        assert METRICS.snapshot()["search.ivf_clustered"] == before + 1
        assert_mesh_answer(got, _search(single_c, **kw), _search(jax_c, **kw), l2_target=target)
    assert any("sharded_clustered" in key for key in mesh_c._device), sorted(map(str, mesh_c._device))
    builds = mesh_c.clustered_builds
    for pred in (None, ("tag", "==", 2), None):
        _search(mesh_c, source="big", coding="cc", probes=2, maxval=8, pred=pred,
                target=rng.standard_normal(d).astype(np.float32))
    assert mesh_c.clustered_builds == builds == 1


def test_cross_shard_tie_break(tmp_path, rng):
    """One vector duplicated on all 8 shards: the merged top-k orders the
    ties by ascending global id, as one device does."""
    root = str(tmp_path)
    n, d = 1024, 8
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    dup_ids = [3, 200, 333, 470, 601, 777, 900, 1021]
    vecs[dup_ids] = vecs[3]
    table.make(root, "t", _table(vecs, np.zeros(n, np.int64)).to_reader())
    jax_c, mesh_c, single_c = _caches(root, block=16, n=8)
    for cache in (mesh_c, single_c, jax_c):
        got = _search(cache, target=vecs[3], maxval=len(dup_ids))
        assert got.column("id").to_pylist() == dup_ids


# -- test_parallel.py ---------------------------------------------------------------


def _place(corpus, block, mask=None, model_parallel=1):
    """The corpus on both meshes: ``((jax corpus, jax mask), (port corpus,
    port mask), port mesh, jax mesh)``."""
    jm, pm = jax_mesh(8, model_parallel), port_mesh(8, model_parallel)
    return jsearch.shard_corpus(jm, corpus, mask, block=block), psearch.shard_corpus(pm, corpus, mask, block=block), pm, jm


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_sharded_search_matches_single_device(rng, metric):
    n, d, q, k = 3000, 32, 4, 10
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    (jc, jmask), (pc, pmask), pm, jm = _place(corpus, 128, model_parallel=2)
    got_d, got_i = psearch.build_sharded_search(pm, k, metric, block=128)(pc, torch.from_numpy(queries), pmask)
    want_d, want_i = jsearch.build_sharded_search(jm, k, metric, block=128)(jc, jnp.asarray(queries), jmask)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
    t = torch.from_numpy(corpus)
    one_d, one_i = topk2.topk_two_phase(t, torch.from_numpy(queries), *topk2.prepare_aux(t, None, metric), k=k,
                                        metric=metric)
    np.testing.assert_array_equal(got_i.numpy(), one_i.numpy())


def test_sharded_search_respects_mask(rng):
    n, d, k = 2048, 16, 12
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    mask = rng.random(n) < 0.3
    queries = rng.standard_normal((3, d)).astype(np.float32)
    (jc, jmask), (pc, pmask), pm, jm = _place(corpus, 64, mask)
    got_d, got_i = psearch.build_sharded_search(pm, k, "l2")(pc, torch.from_numpy(queries), pmask)
    want_d, want_i = jsearch.build_sharded_search(jm, k, "l2")(jc, jnp.asarray(queries), jmask)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
    assert mask[got_i.numpy()].all()


def test_sharded_probed_search(rng):
    n, d, k, n_cells, probes = 2048, 16, 8, 32, 6
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    coded = rng.integers(0, n_cells, n).astype(np.int32)
    queries = rng.standard_normal((3, d)).astype(np.float32)
    cells = np.stack([rng.choice(n_cells, probes, replace=False) for _ in range(3)]).astype(np.int32)
    (jc, jmask), (pc, pmask), pm, jm = _place(corpus, 64)
    coded_pad = np.full(pc.shape[0], -1, np.int32)
    coded_pad[:n] = coded
    jcoded = jax.device_put(coded_pad, jmesh.row_sharding(jm, 1))
    pcoded = psearch.put_rows(pm, coded_pad, coded_pad.shape[0])
    got_d, got_i = psearch.build_sharded_search_probed(pm, k, "l2", block=64)(
        pc, torch.from_numpy(queries), pmask, pcoded, torch.from_numpy(cells))
    want_d, want_i = jsearch.build_sharded_search_probed(jm, k, "l2", block=64)(
        jc, jnp.asarray(queries), jmask, jcoded, jnp.asarray(cells))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
    for qi in range(3):
        assert np.isin(coded[got_i.numpy()[qi]], cells[qi]).all()


def test_sharded_search_with_precomputed_aux_matches(rng):
    n, d, k = 1024, 16, 7
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = torch.from_numpy(rng.standard_normal((4, d)).astype(np.float32))
    _, (pc, pmask), pm, _ = _place(corpus, 128)
    d1, i1 = psearch.build_sharded_search(pm, k, "l2", block=128)(pc, queries, pmask)
    mul, add = psearch.shard_aux(pc, pmask, "l2")
    d2, i2 = psearch.build_sharded_search(pm, k, "l2", with_aux=True)(pc, queries, pmask, mul, add)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=1e-6)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_sharded_search_precision_scan_modes(rng, precision):
    n, d, q, k = 3000, 32, 4, 10
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    (jc, jmask), (pc, pmask), pm, jm = _place(corpus, 128)
    if precision == "int8":
        jscan, pscan = jsearch.shard_scan_int8(jc), psearch.shard_scan_int8(pc)
        assert pscan[0].dtype == torch.int8 and pscan[0].shape == pc.shape
    else:
        jscan, pscan = (jsearch.shard_scan_bf16(jc),), (psearch.shard_scan_bf16(pc),)
        assert pscan[0].dtype == torch.bfloat16
    got_d, got_i = psearch.build_sharded_search(pm, k, "l2", precision=precision)(
        pc, torch.from_numpy(queries), pmask, *pscan)
    want_d, want_i = jsearch.build_sharded_search(jm, k, "l2", precision=precision)(
        jc, jnp.asarray(queries), jmask, *jscan)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_train_sharded_matches_jax(rng, n_shards, metric):
    """``train_sharded`` is the JAX package's coder of the same seed and
    shard count: the same initial rows, per-shard samples and weights."""
    n, d = 3000, 16  # 3,000 rows: the last shard holds a partial block
    data = rng.standard_normal((n, d)).astype(np.float32)
    data[1500:] += 5.0
    kw = dict(num_codebooks=2, codebook_size=4, batch_size=256, num_epochs=3, metric=metric)
    jm, pm = jax_mesh(n_shards), port_mesh(n_shards)
    jc, _ = jsearch.shard_corpus(jm, data, block=128)
    pc, _ = psearch.shard_corpus(pm, data, block=128)
    want = np.asarray(jkmeans.train_sharded(jm, jc, n, np.uint32(7), **kw))
    got = kmeans.train_sharded(pm, pc, n, 7, **kw).numpy()
    assert got.shape == want.shape == (2, 4, d)
    assert np.abs(got - want).max() <= 3.3e-7 * np.abs(want).max()


def _dim_inputs(corpus: np.ndarray, queries: np.ndarray, metric: str, block: int, model_parallel: int = 2):
    """Both packages' dim-sharded inputs from one host corpus on 8 shards
    in a (4, 2) grid: the aux of the full-D padded rows (computed before
    placement, as the JAX tests do), prepared queries and raw ‖q‖²."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jm, pm = jax_mesh(8, model_parallel), port_mesh(8, model_parallel)
    jc, _ = jsearch.shard_corpus_dim(jm, corpus, block=block)
    pc, pmask = psearch.shard_corpus_dim(pm, corpus, block=block)
    n_pad, d = jc.shape
    assert pc.shape == (n_pad, d)
    full = np.zeros((n_pad, d), np.float32)
    full[: corpus.shape[0]] = corpus
    mask = np.zeros(n_pad, bool)
    mask[: corpus.shape[0]] = True
    np.testing.assert_array_equal(torch.cat(pmask).numpy(), mask)
    jmul, jadd = jtopk2.prepare_aux(jnp.asarray(full), jnp.asarray(mask), metric)
    q_sq = (queries.astype(np.float64) ** 2).sum(1).astype(np.float32)
    jargs = (jc, jax.device_put(np.asarray(jtopk2.prepare_queries(jnp.asarray(queries), metric)),
                                NamedSharding(jm, P(None, jmesh.MODEL_AXIS))),
             jax.device_put(np.asarray(jmul), NamedSharding(jm, P(jmesh.DATA_AXIS))),
             jax.device_put(np.asarray(jadd), NamedSharding(jm, P(jmesh.DATA_AXIS))), jnp.asarray(q_sq))
    pmul, padd = topk2.prepare_aux(torch.from_numpy(full), torch.from_numpy(mask), metric)
    pargs = (pc, topk2.prepare_queries(torch.from_numpy(queries), metric), pc.data_rows(pmul), pc.data_rows(padd),
             torch.from_numpy(q_sq))
    return jm, pm, jargs, pargs


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_dim_sharded_search_matches_oracle(rng, metric):
    """``test_parallel.py::test_dim_sharded_search_matches_oracle``: D
    split over the model axis, partials added per data shard; ids exact
    against the float oracle (a tie spanning data shards in id order),
    distances within rtol 1e-4 / atol 1e-5; and the JAX mesh's answer."""
    n, d, q, k = 3000, 32, 8, 10
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus[777] = corpus[13]  # tie spanning data shards
    queries = rng.standard_normal((q, d)).astype(np.float32)
    # the tied pair at the top, far enough that l2's expanded form keeps 1e-5
    queries[0] = corpus[13] + 0.1 * rng.standard_normal(d).astype(np.float32)
    jm, pm, jargs, pargs = _dim_inputs(corpus, queries, metric, block=128)
    dist, ids = psearch.build_dim_sharded_search(pm, k, metric)(*pargs)
    assert dist.shape == ids.shape == (q, k) and ids[0, :2].tolist() == [13, 777]
    want_d, want_i = oracles.topk(oracles.distance(queries, corpus, metric), k)
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_allclose(dist.numpy(), want_d, rtol=1e-4, atol=1e-5)
    jd, ji = jtopk2.unpack_result(np.asarray(jsearch.build_dim_sharded_search(jm, k=k, metric=metric)(*jargs)))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_dim_sharded_search_raises():
    """Once the route raised; now the port answers as the JAX mesh does,
    also where k passes a data shard's rows and masked (−inf) rows pad the
    result: a masked corpus, k beyond the valid rows, (−1, +inf) padding."""
    rng = np.random.default_rng(5)
    n, d, k = 40, 8, 64  # 4 data shards of 16 rows (8 real rows padded): k > rows_local
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((3, d)).astype(np.float32)
    for metric in ("l2", "cosine", "dot"):
        jm, pm, jargs, pargs = _dim_inputs(corpus, queries, metric, block=8)
        dist, ids = psearch.build_dim_sharded_search(pm, k, metric)(*pargs)
        jd, ji = jtopk2.unpack_result(np.asarray(jsearch.build_dim_sharded_search(jm, k=k, metric=metric)(*jargs)))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
        np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
        assert (ids.numpy() == -1).sum(axis=1).tolist() == [k - n] * 3 and np.isinf(dist.numpy()[:, n:]).all()
    with pytest.raises(AssertionError):
        psearch.shard_corpus_dim(port_mesh(8, 2), np.zeros((8, 5), np.float32))  # D must split over M


@pytest.mark.parametrize("model_axis", ["model", None])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_sharded_lloyd_step_matches_local(rng, model_axis, metric):
    """``test_parallel.py::test_sharded_lloyd_step_matches_local``: books
    over the model axis (or not), batch rows over the data axis, within
    rtol 1e-4 / atol 1e-5 of the float oracle and 1e-5 of the largest
    entry of the port's ``lloyd_step_single`` and of the JAX step."""
    n_books, k, d, b = 2, 8, 16, 128
    q = rng.standard_normal((n_books, k, d)).astype(np.float32)
    v = rng.standard_normal((n_books, b, d)).astype(np.float32)
    got = kmeans.sharded_lloyd_step(port_mesh(8, 2), mesh_mod.DATA_AXIS, model_axis, metric)(
        torch.from_numpy(q), torch.from_numpy(v)).numpy()
    want = np.stack([oracles.lloyd_step(q[j], v[j], metric) for j in range(n_books)])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    single = torch.stack([kmeans.lloyd_step_single(torch.from_numpy(q[j]), torch.from_numpy(v[j]), metric)
                          for j in range(n_books)]).numpy()
    jstep = jkmeans.sharded_lloyd_step(jax_mesh(8, 2), jmesh.DATA_AXIS, model_axis, metric)
    jgot = np.asarray(jstep(jnp.asarray(q), jnp.asarray(v)))
    for other in (single, jgot):
        assert np.abs(got - other).max() <= 1e-5 * np.abs(other).max()
    with pytest.raises(ValueError, match="split"):
        kmeans.sharded_lloyd_step(port_mesh(8, 2), "data", "model", metric)(torch.from_numpy(q[:1]),
                                                                          torch.from_numpy(v[:1]))


# -- test_ring.py -------------------------------------------------------------------


@pytest.fixture(scope="module")
def ring_root(tmp_path_factory):
    rng = np.random.default_rng(3)
    path = str(tmp_path_factory.mktemp("ring_root"))
    vecs = rng.standard_normal((2048, 24)).astype(np.float32)
    vecs[100] = vecs[7]  # exact duplicates: distance ties across shards
    vecs[1500] = vecs[7]
    table.make(path, "t", _table(vecs, (np.arange(2048) % 3).astype(np.int64)).to_reader())
    cfg = {"metric": "l2", "codebook_size": 4, "num_codebooks": 2, "batch_size": 512, "num_epochs": 1}
    jmesh._SERVING_MESH = None
    jcoder.make(path, "cc", "t", "vector", cfg, seed=0)
    jindex.make(path, "cc", "t", "vector")
    jmesh._SERVING_MESH = "unset"
    return path, vecs


@pytest.fixture(scope="module")
def ring_caches(ring_root):
    return _caches(ring_root[0], block=64)


@pytest.mark.parametrize("model_parallel", [1, 2], ids=["flat", "model_parallel_2"])
def test_ring_kernel_matches_allgather_merge(rng, model_parallel):
    """The ring's answer is the all-gather merge's, ties included, over
    the flattened (data, model) ring too, and the JAX ring's."""
    n, d, q, k = 1024, 16, 64, 12
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus[77] = corpus[13]
    corpus[901] = corpus[3]  # a tie across the model-axis boundary
    queries = rng.standard_normal((q, d)).astype(np.float32)
    (jc, jmask), (pc, pmask), pm, jm = _place(corpus, 16, model_parallel=model_parallel)
    mul, add = psearch.shard_aux(pc, pmask, "l2")
    ref_d, ref_i = psearch.build_serving_search(pm, k, "l2")(pc, torch.from_numpy(queries), mul, add)
    got_d, got_i = psearch.build_ring_search(pm, k, "l2")(pc, torch.from_numpy(queries), mul, add)
    np.testing.assert_array_equal(got_i.numpy(), ref_i.numpy())
    np.testing.assert_array_equal(got_d.numpy(), ref_d.numpy())
    jmul, jadd = jsearch.shard_aux(jc, jmask, "l2")
    q_sharded = jax.device_put(queries, jmesh.row_sharding(jm, 2))
    want_d, want_i = jtopk2.unpack_result(np.asarray(jsearch.build_ring_search(jm, k=k, metric="l2")(
        jc, q_sharded, jmul, jadd)))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-5, atol=1e-5)


def _ring_target(vecs, rng, q: int = 8) -> np.ndarray:
    """A query near the tied triplet, then random ones."""
    return np.concatenate([vecs[7:8] + 1e-4, rng.standard_normal((q - 1, vecs.shape[1])).astype(np.float32)])


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("mode", ["plain", "filtered", "probed", "probed_filtered"])
def test_ring_matrix_matches_single_device(ring_root, ring_caches, monkeypatch, precision, mode):
    """{ring} x {fp32, bf16, int8} x {filtered, probed}: the single device's
    rows and the JAX ring's (the probed ring takes the masked scan with
    each block's probe cells riding along)."""
    monkeypatch.setenv("FENIX_RING", "8")
    _, vecs = ring_root
    probed = "probed" in mode
    kw = dict(target=_ring_target(vecs, np.random.default_rng(9)), maxval=9, precision=precision,
              pred=("tag", "!=", 1) if "filtered" in mode else None,
              coding="cc" if probed else None, probes=3 if probed else None)
    before = METRICS.snapshot().get("search.mesh_ring", 0)
    got, single, want = _three(ring_caches, **kw)
    assert METRICS.snapshot()["search.mesh_ring"] == before + 1
    assert_mesh_answer(got, single, want, l2_target=kw["target"])


def test_ring_pads_query_remainder(ring_caches, rng, monkeypatch):
    """Q not divisible by the shard count pads with zero queries, sliced
    off, instead of leaving the ring."""
    monkeypatch.setenv("FENIX_RING", "1")
    target = rng.standard_normal((3, 24)).astype(np.float32)
    before = METRICS.snapshot().get("search.mesh_ring", 0)
    got, single, want = _three(ring_caches, target=target, maxval=5)
    assert METRICS.snapshot()["search.mesh_ring"] == before + 1
    assert_mesh_answer(got, single, want, l2_target=target)


def test_ring_route_off_by_default_at_small_q(ring_caches, rng, monkeypatch):
    """``FENIX_RING=auto`` keeps small batches on the all-gather route
    (threshold 512 queries, padded as the JAX package pads); ``off``
    keeps even large ones there."""
    monkeypatch.delenv("FENIX_RING", raising=False)
    assert executor._ring_threshold() == jexecutor._ring_threshold() == 512
    _, mesh_c, _ = ring_caches
    for q, ring in ((8, False), (300, True)):
        before = METRICS.snapshot().get("search.mesh_ring", 0)
        _search(mesh_c, target=rng.standard_normal((q, 24)).astype(np.float32), maxval=4)
        assert METRICS.snapshot().get("search.mesh_ring", 0) == before + ring
    monkeypatch.setenv("FENIX_RING", "off")
    assert executor._ring_threshold() is None


def test_shard_threads_answer_as_the_shards_in_turn(ring_root, rng, monkeypatch):
    """The one-thread-per-card dispatch (``Mesh.map`` on distinct cards),
    forced over 8 CPU shards with a short thread switch interval: the ring
    and the all-gather searches answer as the shards run in turn do."""
    import sys

    vecs = ring_root[1]
    corpus, mask = psearch.shard_corpus(port_mesh(8), vecs, block=16)
    mul, add = psearch.shard_aux(corpus, mask, "l2")
    queries = torch.from_numpy(_ring_target(vecs, rng, q=64))
    in_turn = [psearch.build_ring_search(corpus.mesh, 9, "l2")(corpus, queries, mul, add),
               psearch.build_serving_search(corpus.mesh, 9, "l2")(corpus, queries, mul, add)]
    monkeypatch.setattr(mesh_mod.Mesh, "concurrent", property(lambda self: True))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(4):
            threaded = [psearch.build_ring_search(corpus.mesh, 9, "l2")(corpus, queries, mul, add),
                        psearch.build_serving_search(corpus.mesh, 9, "l2")(corpus, queries, mul, add)]
            for (d, i), (want_d, want_i) in zip(threaded, in_turn):
                assert torch.equal(i, want_i) and torch.equal(d, want_d)
    finally:
        sys.setswitchinterval(interval)
    assert corpus.mesh._pool is not None  # the threads ran


# -- test_residency_mesh.py ---------------------------------------------------------

RES_ROWS, RES_DIM, RES_BLOCK = 9 * 1024, 16, 128


@pytest.fixture(scope="module")
def res_caches(tmp_path_factory):
    rng = np.random.default_rng(7)
    path = str(tmp_path_factory.mktemp("resmesh"))
    vecs = rng.standard_normal((RES_ROWS, RES_DIM)).astype(np.float32)
    table.make(path, "vec", _table(vecs, (np.arange(RES_ROWS) % 10).astype(np.int64)).to_reader())
    return _caches(path, block=RES_BLOCK, n=8)


def _res(cache, **kw):
    kw.setdefault("maxval", 25)
    return _search(cache, source="vec", **kw)


def _ids_dists(t: pa.Table, q: int):
    return t.column("id").to_numpy().reshape(q, -1), t.column("__DISTANCE__").to_numpy().reshape(q, -1)


def _assert_same_ids(a: pa.Table, b: pa.Table, q: int) -> None:
    ids_a, d_a = _ids_dists(a, q)
    ids_b, d_b = _ids_dists(b, q)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_int8_mesh_matches_dual_and_single(res_caches, rng, metric):
    jax_c, mesh_c, single_c = res_caches
    kw = dict(target=rng.standard_normal((3, RES_DIM)).astype(np.float32), metric=metric)
    dual = _res(mesh_c, **kw)
    before = METRICS.snapshot().get("search.residency_int8", 0)
    got = _res(mesh_c, **kw, residency="int8", extra={"window": RES_ROWS})
    assert METRICS.snapshot()["search.residency_int8"] == before + 1
    assert "sharded_int8_solo" in mesh_c.device_entry_kinds()
    _assert_same_ids(dual, got, 3)
    _assert_same_ids(_res(single_c, **kw, residency="int8", extra={"window": RES_ROWS}), got, 3)
    _assert_same_ids(_res(jax_c, **kw, residency="int8", extra={"window": RES_ROWS}), got, 3)


@pytest.mark.parametrize("pred", [("tag", "==", 3), ("tag", "<", 7)])
def test_int8_mesh_filtered(res_caches, rng, pred):
    jax_c, mesh_c, _ = res_caches
    kw = dict(target=rng.standard_normal((3, RES_DIM)).astype(np.float32), pred=pred)
    got = _res(mesh_c, **kw, residency="int8", extra={"window": RES_ROWS})
    _assert_same_ids(_res(mesh_c, **kw), got, 3)
    _assert_same_ids(_res(jax_c, **kw, residency="int8", extra={"window": RES_ROWS}), got, 3)


def test_stream_fp32_mesh_matches_dual(res_caches, rng, monkeypatch):
    """A 150 kB per-device budget streams 384-row slices a device, 8 x 384
    rows a chunk: three chunks, each row-sharded, as the JAX mesh counts."""
    jax_c, mesh_c, single_c = res_caches
    target = rng.standard_normal((3, RES_DIM)).astype(np.float32)
    dual = _res(mesh_c, target=target)
    monkeypatch.setenv("FENIX_HBM_BUDGET", "150000")
    n_chunks = -(-RES_ROWS // (residency._stream_chunk_rows(150000, RES_DIM, RES_BLOCK, 4) * 8))
    assert n_chunks == 3
    before, jbefore = METRICS.snapshot().get("search.stream_chunks", 0), JMETRICS.snapshot().get(
        "search.stream_chunks", 0)
    got = _res(mesh_c, target=target, residency="stream")
    want = _res(jax_c, target=target, residency="stream")
    assert METRICS.snapshot()["search.stream_chunks"] - before == JMETRICS.snapshot()["search.stream_chunks"] - jbefore
    assert METRICS.snapshot()["search.stream_chunks"] - before == n_chunks
    _assert_same_ids(dual, got, 3)
    _assert_same_ids(want, got, 3)
    _assert_same_ids(_res(single_c, target=target, residency="stream"), got, 3)


def test_stream_int8_mesh_matches_dual(res_caches, rng, monkeypatch):
    jax_c, mesh_c, _ = res_caches
    target = rng.standard_normal((3, RES_DIM)).astype(np.float32)
    pred = ("tag", "<", 7)
    dual = _res(mesh_c, target=target, pred=pred)
    monkeypatch.setenv("FENIX_HBM_BUDGET", "150000")
    kw = dict(target=target, pred=pred, residency="stream", precision="int8", extra={"window": RES_ROWS})
    got = _res(mesh_c, **kw)
    _assert_same_ids(dual, got, 3)
    _assert_same_ids(_res(jax_c, **kw), got, 3)


def test_batch_1024_through_residency_modes(res_caches, rng, monkeypatch):
    _, mesh_c, _ = res_caches
    target = rng.standard_normal((1024, RES_DIM)).astype(np.float32)
    dual = _res(mesh_c, target=target, maxval=10)
    int8 = _res(mesh_c, target=target, maxval=10, residency="int8", extra={"window": RES_ROWS})
    monkeypatch.setenv("FENIX_HBM_BUDGET", "150000")
    stream = _res(mesh_c, target=target, maxval=10, residency="stream")
    _assert_same_ids(dual, int8, 1024)
    _assert_same_ids(dual, stream, 1024)


def test_plan_budgets_per_device(res_caches, monkeypatch):
    """One budget, two routes: the whole int8 copy passes one device's
    budget (stream) while each device's slice fits the 8-shard mesh's
    (int8), in both packages; room for the dual slice keeps dual."""
    jax_c, mesh_c, single_c = res_caches
    monkeypatch.setenv("FENIX_HBM_BUDGET", "100000")
    req = executor.SearchRequest("vec", "vector", np.zeros((1, RES_DIM), np.float32), metric="l2", maxval=5)
    jreq = jexecutor.SearchRequest("vec", "vector", np.zeros((1, RES_DIM), np.float32), metric="l2", maxval=5)
    assert residency.plan(single_c, req) == residency.STREAM
    assert residency.plan(mesh_c, req) == jresidency.plan(jax_c, jreq) == residency.INT8
    monkeypatch.setenv("FENIX_HBM_BUDGET", "9e9")
    assert residency.plan(mesh_c, req) == residency.DUAL


def test_auto_mode_serves_oversized_table_on_mesh(res_caches, rng, monkeypatch):
    _, mesh_c, _ = res_caches
    target = rng.standard_normal((2, RES_DIM)).astype(np.float32)
    dual = _res(mesh_c, target=target)
    monkeypatch.setenv("FENIX_HBM_BUDGET", "100000")
    before = METRICS.snapshot().get("search.residency_int8", 0)
    got = _res(mesh_c, target=target, extra={"window": RES_ROWS})
    assert METRICS.snapshot()["search.residency_int8"] == before + 1
    _assert_same_ids(dual, got, 2)


# -- test_incremental_cache.py:78 ---------------------------------------------------


def _inc_table(ids: np.ndarray, vecs: np.ndarray) -> pa.Table:
    return pa.table({"id": pa.array(ids), "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32())})


def test_incremental_refresh_under_mesh(tmp_path, rng, monkeypatch):
    """Appends grow the row-sharded matrix (past its capacity too, the
    existing rows moving between shards) and upload only their rows; an
    append that folds the parts rebuilds; a delete shrinks by the lineage.
    Both packages' mesh caches move the same counters and answer as a
    cold cache does."""
    root = str(tmp_path)
    d = 16
    vecs = rng.standard_normal((512, d)).astype(np.float32)
    table.make(root, "t", _inc_table(np.arange(512), vecs).to_reader())
    jax_c = JaxCache(root, block=64, mesh=jax_mesh(8))
    mesh_c = DeviceCache(root, block=64, device="cpu", mesh=port_mesh(8))

    def both(target, maxval):
        got = _search(mesh_c, target=target, maxval=maxval)
        want = _search(jax_c, target=target, maxval=maxval)
        assert got.column("id").to_pylist() == want.column("id").to_pylist()
        assert (mesh_c.incremental_refreshes, mesh_c.lineage_refreshes) == (
            jax_c.incremental_refreshes, jax_c.lineage_refreshes)
        return got

    both(vecs[0], 3)  # warm the sharded matrix and aux
    full_builds = []
    real = psearch.to_sharded_matrix
    monkeypatch.setattr(psearch, "to_sharded_matrix", lambda *a, **k: full_builds.append(1) or real(*a, **k))

    extra = rng.standard_normal((16, d)).astype(np.float32) + 30.0  # past the 512-row capacity
    table.append(root, "t", _inc_table(np.arange(512, 528), extra))
    assert both(extra[3], 1).column("id").to_pylist() == [515]
    assert mesh_c.incremental_refreshes == 1 and not full_builds
    assert mesh_c.sharded_matrix("t", "vector").data.shape[0] == 1024

    mid = rng.standard_normal((300, d)).astype(np.float32) - 30.0  # inside the grown capacity
    table.append(root, "t", _inc_table(np.arange(528, 828), mid))
    assert both(mid[7], 1).column("id").to_pylist() == [535]
    assert mesh_c.incremental_refreshes == 2 and not full_builds

    cold = DeviceCache(root, block=64, device="cpu", mesh=port_mesh(8))
    q = rng.standard_normal(d).astype(np.float32)
    assert _search(mesh_c, target=q, maxval=10) == _search(cold, target=q, maxval=10)
    grown = mesh_c.sharded_matrix("t", "vector")
    np.testing.assert_array_equal(grown.data.gather().numpy(), cold.sharded_matrix("t", "vector").data.gather().numpy())

    big = rng.standard_normal((1500, d)).astype(np.float32) + 60.0  # folds the parts: a new base
    table.append(root, "t", _inc_table(np.arange(828, 2328), big))
    assert both(big[11], 1).column("id").to_pylist() == [839]
    assert mesh_c.incremental_refreshes == 2 and full_builds

    full_builds.clear()
    assert index_mod.delete_rows(root, "t", expr.field("id") >= 2300) == 28
    assert both(big[11], 1).column("id").to_pylist() == [839]
    assert (mesh_c.incremental_refreshes, mesh_c.lineage_refreshes) == (2, 1) and not full_builds
    shrunk = mesh_c.sharded_matrix("t", "vector")
    cold = DeviceCache(root, block=64, device="cpu", mesh=port_mesh(8)).sharded_matrix("t", "vector")
    assert shrunk.rows == cold.rows == 2300
    np.testing.assert_array_equal(shrunk.data.gather().numpy(), cold.data.gather().numpy())


# -- the draws of train_sharded -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_threefry_fold_in_randint_choice_match_jax(seed):
    """``fold_in``, ``randint`` (spans small, past 2¹⁶ where the
    multiplier's square wraps, and empty) and ``choice(replace=False)``
    bit for bit against ``jax.random``."""
    key = jax.random.PRNGKey(np.uint32(seed))
    mine = threefry.prng_key(seed)
    for data in (0, 1, 3, 12345, 2**32 - 1):
        want = tuple(int(x) for x in np.asarray(jax.random.key_data(jax.random.fold_in(key, np.uint32(data)))))
        assert threefry.fold_in(mine, data) == want
    for maxval, shape in ((1, (4,)), (7, (2, 9)), (1000, (3, 5)), (65_536, (50,)), (65_537, (50,)),
                          (123_456, (1000,)), (2**31 - 1, (6,)), (0, (3,))):
        want = np.asarray(jax.random.randint(key, shape, 0, maxval))
        np.testing.assert_array_equal(threefry.randint(mine, shape, 0, maxval), want)
    traced = jax.jit(lambda m: jax.random.randint(key, (5, 7), 0, jnp.maximum(m, 1)))(jnp.int32(513))
    np.testing.assert_array_equal(threefry.randint(mine, (5, 7), 0, 513), np.asarray(traced))
    np.testing.assert_array_equal(threefry.choice(mine, 1000, 37),
                                  np.asarray(jax.random.choice(key, 1000, (37,), replace=False)))
