"""fenix_tpu_torch's engine (DeviceCache + executor + catalog) against the
JAX package's on the same root, on the CPU.

Result tables must be equal column by column — ids and every gathered
column exactly — with ``__DISTANCE__`` within rtol/atol 1e-5 (the two
packages sum the fp32 rescore in different orders).
"""

import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from fenix_tpu import expr as jexpr
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine import service as jservice
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu.io import table as jtable
from fenix_tpu_torch import coder, expr, index
from fenix_tpu_torch.engine import executor, residency, service
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.ops import kernels, topk2
from fenix_tpu_torch.parallel import distributed
from fenix_tpu_torch.parallel import search as psearch
from fenix_tpu_torch.parallel.mesh import make_mesh
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

torch.set_num_threads(2)

N, DIM = 20_000, 32


def make_table(rng, n=N, dim=DIM) -> pa.Table:
    vectors = rng.standard_normal((n, dim)).astype(np.float32)
    dup = min(100, n // 2)
    vectors[n // 2 : n // 2 + dup] = vectors[:dup]  # exact duplicate rows
    return pa.table(
        {
            "id": pa.array(np.arange(n, dtype=np.int64)),
            "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
            "tag": pa.array(rng.integers(0, 10, n).astype(np.int32)),
            "name": pa.array([f"row{i}" for i in range(n)]),
        }
    )


@pytest.fixture
def root(tmp_path, rng):
    # several record batches → several chunks per column, as a table
    # streamed in over Flight has
    table.make(str(tmp_path), "items", make_table(rng).to_reader(max_chunksize=3000))
    return str(tmp_path)


def _search_both(root, **kw):
    req = dict(source="items", column="vector", **kw)
    got = executor.execute_search(DeviceCache(root, device="cpu"), executor.SearchRequest(**req))
    if req.get("filter") is not None:  # the same predicate, through the JSON wire form
        req["filter"] = jexpr.Expr.from_dict(req["filter"].to_dict())
    want = jexecutor.execute_search(JaxCache(root, mesh=None), jexecutor.SearchRequest(**req))
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


QUERIES = [1, 20]


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_execute_search_matches_jax(root, rng, q, precision):
    target = rng.standard_normal((q, DIM)).astype(np.float32)
    target[0] = make_table(np.random.default_rng(0)).column("vector")[3].values.to_numpy()
    got, want = _search_both(
        root, target=target, metric="cosine", maxval=12, precision=precision
    )
    assert got.num_rows == q * 12
    assert_tables_match(got, want)


@pytest.mark.parametrize("metric", ["l2", "dot", "euclidean"])
def test_execute_search_filtered_matches_jax(root, rng, metric):
    target = rng.standard_normal((5, DIM)).astype(np.float32)
    filt = (expr.field("tag") < 3) & ~expr.field("name").ends_with("7")
    got, want = _search_both(
        root, target=target, metric=metric, maxval=20, filter=filt, select=["id", "name", "tag"]
    )
    assert_tables_match(got, want)
    assert (got.column("tag").to_numpy() < 3).all()


def test_flat_target_and_maxval_above_rows(tmp_path, rng):
    root = str(tmp_path)
    table.make(root, "items", make_table(rng, n=30).to_reader())
    flat = rng.standard_normal(DIM).astype(np.float32)  # one query, flat wire shape
    got, want = _search_both(root, target=pa.array(flat), metric="l2", maxval=50)
    assert got.num_rows == 30 and "__QUERY_ID__" not in got.column_names
    assert_tables_match(got, want)


def test_catalog_is_shared_both_ways(tmp_path, rng):
    """A root written by either package reads identically through the other."""
    root = str(tmp_path)
    a, b = make_table(rng, n=500), make_table(rng, n=700)
    table.make(root, "from_torch", a.to_reader())
    jtable.make(root, "from_jax", b.to_reader())
    assert jtable.load(root, "from_torch").equals(a)
    assert table.load(root, "from_jax").equals(b)
    assert [*table.list(root)] == [*jtable.list(root)] == ["from_jax", "from_torch"]
    assert table.stamp(root, "from_jax") == jtable.stamp(root, "from_jax")


def test_index_catalog_helpers_match_jax(tmp_path, rng):
    from fenix_tpu import coder as jcoder
    from fenix_tpu import index as jindex

    root = str(tmp_path)
    table.make(root, "t", make_table(rng, n=64).to_reader())
    table.make(root, "t/sub", make_table(rng, n=64).to_reader())
    for name, source in (("ivf", "t"), ("other", "t/sub")):
        os.makedirs(os.path.dirname(jcoder.path_of(root, name)), exist_ok=True)
        open(jcoder.path_of(root, name), "wb").close()
        path = index.path_of(root, name, source, "vector")
        assert path == jindex.path_of(root, name, source, "vector")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()
    assert [*index.list(root)] == [*jindex.list(root)]
    assert [*index.indexes_for_source(root, "t")] == [*jindex.indexes_for_source(root, "t")]
    index.drop_for_source(root, "t")
    assert [*index.list(root)] == ["t/sub/vector/other"]  # the nested sibling keeps its index
    assert [*coder.list(root)] == [*jcoder.list(root)] == ["ivf", "other"]
    coder.drop(root, "ivf")
    assert [*jcoder.list(root)] == ["other"]


def test_state_from_numpy_round_trips(rng):
    corpus = rng.standard_normal((256, 8)).astype(np.float32)
    aux_mul, aux_add = np.ones(256, np.float32), np.zeros(256, np.float32)
    v8 = rng.integers(-127, 128, (256, 8)).astype(np.int8)
    sv = rng.random(256).astype(np.float32)
    c, m, a, (t8, tsv) = topk2.state_from_numpy(corpus, aux_mul, aux_add, v8, sv, device="cpu")
    assert c.dtype == torch.float32 and t8.dtype == torch.int8
    np.testing.assert_array_equal(c.numpy(), corpus)
    np.testing.assert_array_equal(t8.numpy(), v8)
    assert topk2.state_from_numpy(corpus, aux_mul, aux_add, device="cpu")[3] is None


def test_device_cache_follows_revisions(root, rng):
    cache = DeviceCache(root, device="cpu")
    first = cache.matrix("items", "vector")
    assert first.rows == N and first.rows_padded == 32768
    assert first.data.device.type == "cpu"
    assert (first.data[N:] == 0).all()
    assert cache.matrix("items", "vector") is first  # memoized per revision
    cache.matrix_bf16("items", "vector")
    cache.matrix_int8("items", "vector")
    assert cache.device_bytes() == 32768 * DIM * (4 + 2 + 1) + 32768 * 4

    table.make(root, "items", make_table(rng, n=100).to_reader())
    second = cache.matrix("items", "vector")
    assert second.rows == 100 and second.rows_padded == 16384
    data, matrix, stamp = cache.snapshot("items", "vector")
    assert data.num_rows == 100 and matrix is second and stamp == cache.snapshot_stamp("items")
    # the host reload freed the old revision's scan copies
    assert cache.device_bytes() == 16384 * DIM * 4


def test_budget_eviction_keeps_latest(root, monkeypatch):
    cache = DeviceCache(root, device="cpu")
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(32768 * DIM * 4 + 1))
    cache.matrix("items", "vector")
    cache.matrix_bf16("items", "vector")
    assert cache.evictions == 1 and cache.device_bytes() == 32768 * DIM * 2


def test_unported_requests_raise(root, rng, monkeypatch, tmp_path):
    """Bad precisions and missing metrics raise; IVF, maxval=None on the
    device and over the host corpus, the int8-resident and streaming
    modes, requests over the budget, probed search over the host corpus
    (top-k and maxval=None), coder training past the budget, joins (the
    JAX package's answer) and an aggregate without a join are served. Over
    a mesh a plain search, joins and aggregates (``partitioned`` too, the
    one device's answers), repartition's device shuffle (the host path's
    shard tables), the dim-sharded search (the row-sharded answer) and a
    sharded coder are served, and ``initialize`` with more than one process
    but no coordinator gives the JAX package's local mesh (fault 9)."""
    cache = DeviceCache(root, device="cpu")
    target = rng.standard_normal((2, DIM)).astype(np.float32)

    def run(**kw):
        base = dict(source="items", column="vector", target=target, metric="l2", maxval=5)
        return executor.execute_search(cache, executor.SearchRequest(**{**base, **kw}))

    config = {"metric": "l2", "codebook_size": 8, "num_codebooks": 1, "batch_size": 512,
              "num_epochs": 1}
    coder.make(root, "ivf", "items", "vector", config, seed=0, device="cpu")
    index.make(root, "ivf", "items", "vector", device="cpu")
    probed = run(coding="ivf", probes=4, metric=None)  # the coder's metric
    assert probed.num_rows == 10 and "__CODED_ID__" in probed.column_names
    nomax = run(maxval=None)  # every row for each query, in table order
    assert nomax.num_rows == 2 * N and nomax.column("id").to_numpy()[:N].tolist() == [*range(N)]
    dual = run()
    for mode in ("int8", "stream"):
        assert run(residency=mode).column("id").equals(dual.column("id"))
    with pytest.raises(ValueError, match="precision"):
        run(precision="fp16")
    with pytest.raises(ValueError, match="metric is required"):
        run(metric=None)
    monkeypatch.setenv("FENIX_HBM_BUDGET", "1000")
    assert residency.plan(cache, executor.SearchRequest("items", "vector", target, maxval=5)) == "stream"
    assert run().column("id").equals(dual.column("id"))
    assert run(maxval=None).column("id").equals(nomax.column("id"))  # the host-corpus read
    host = executor.execute_search(
        cache, executor.SearchRequest("items", "vector", target, metric="l2", residency="stream")
    )
    assert host.column("id").equals(nomax.column("id"))
    before = METRICS.snapshot().get("search.residency_probed_host", 0)
    host_probed = run(coding="ivf", probes=4, metric=None)  # on the host, the coder's metric
    assert METRICS.snapshot()["search.residency_probed_host"] == before + 1
    assert host_probed.column("id").equals(probed.column("id"))
    host_nomax = run(coding="ivf", probes=4, maxval=None)
    assert 0 < host_nomax.num_rows < 2 * N and "__CODED_ID__" not in host_nomax.column_names
    big = coder.make(root, "big", "items", "vector", config, seed=0, device="cpu")  # train_streaming
    assert big["tensor"].shape == (1, 8, DIM)
    monkeypatch.delenv("FENIX_HBM_BUDGET")
    assert residency.plan(cache, executor.SearchRequest("items", "vector", target)) == "dual"
    table.make(root, "attrs", pa.table({"key": pa.array(np.arange(0, N, 3, dtype=np.int64)),
                                        "grp": pa.array(np.arange(0, N, 3) % 4)}).to_reader())
    joined = {"source": "items", "column": "vector", "metric": "l2", "maxval": 5,
              "join": {"source": "attrs", "right_on": "key"}}
    for config in (joined, {**joined, "aggregate": {"group_by": "grp", "max_groups": 8}}):
        got = service.run_search_config(cache, config, target)
        want = jservice.run_search_config(JaxCache(root, mesh=None), config, target)
        assert_tables_match(got, want)
    plain = {"source": "items", "column": "vector", "metric": "l2", "maxval": 5}
    aggregated = service.run_search_config(cache, {**plain, "aggregate": {"group_by": "id"}}, target)
    assert aggregated.equals(service.run_search_config(cache, plain, target))
    # over a mesh: a plain search, joins and aggregates (partitioned or
    # not), repartition's device shuffle, the dim-sharded search and a
    # coder are served; only a second process raises
    meshed = DeviceCache(root, device="cpu", mesh=make_mesh(devices=["cpu"] * 2))
    for config in (joined, {**joined, "aggregate": {"group_by": "grp", "max_groups": 8}},
                   {**joined, "join": {**joined["join"], "partitioned": True}}):
        got = service.run_search_config(meshed, config, target)
        assert_tables_match(got, service.run_search_config(cache, config, target))
    host_root = str(tmp_path / "host")
    table.make(host_root, "attrs", table.load(root, "attrs").to_reader())
    distributed.repartition(root, "attrs", 2, key_column="key", mesh=meshed.mesh)  # the device shuffle
    distributed.repartition(host_root, "attrs", 2, key_column="key", mesh=None)
    for s in range(2):
        assert table.load(root, f"attrs@{s}").equals(table.load(host_root, f"attrs@{s}"))
    vectors = ingest.fixed_size_list_to_numpy(table.load(root, "items").column("vector").combine_chunks())
    dim_mesh = make_mesh(devices=["cpu"] * 2, model_parallel=2)
    corpus, mask = psearch.shard_corpus_dim(dim_mesh, vectors)
    padded = torch.zeros(corpus.shape)
    padded[:N] = torch.from_numpy(vectors)
    mul, add = topk2.prepare_aux(padded, torch.cat(mask), "l2")  # of the full-D rows, before placement
    q = torch.from_numpy(target)
    dist, ids = psearch.build_dim_sharded_search(dim_mesh, 5, "l2")(
        corpus, topk2.prepare_queries(q, "l2"), corpus.data_rows(mul), corpus.data_rows(add), (q * q).sum(1))
    assert ids.flatten().tolist() == dual.column("id").to_pylist()
    # the dim-sharded l2 is the expanded sqrt(‖q‖² − s): 1e-4, not the engine's 1e-5
    np.testing.assert_allclose(dist.flatten().numpy(), dual.column("__DISTANCE__").to_numpy(), rtol=1e-4, atol=1e-4)
    from fenix_tpu.parallel import distributed as jdistributed

    jm = jdistributed.initialize(jdistributed.ClusterConfig(num_processes=2))
    pm = distributed.initialize(distributed.ClusterConfig(num_processes=2), devices=["cpu"] * jm.devices.size)
    assert pm.shape == dict(jm.shape) and pm.process_count == 1 and pm.backend is None
    assert service.run_search_config(meshed, plain, target).column("id").equals(dual.column("id"))
    ivf = {"metric": "l2", "codebook_size": 8, "num_codebooks": 1, "batch_size": 512, "num_epochs": 1}
    sharded_coder = coder.make(root, "ivf2", "items", "vector", ivf, seed=0, device="cpu", mesh=meshed.mesh)
    assert sharded_coder["tensor"].shape == (1, 8, DIM)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_aggregate_without_join_is_the_plain_search(root, rng, metric):
    """A search config with an aggregate and no join is the plain search
    in both packages (the JAX package reads an aggregate only inside a
    join): the same ids and distances through each run_search_config."""
    target = rng.standard_normal((3, DIM)).astype(np.float32)
    config = {"source": "items", "column": "vector", "metric": metric, "maxval": 7, "select": ["id", "tag"],
              "aggregate": {"group_by": "tag", "agg": "count", "max_groups": 16}}
    got = service.run_search_config(DeviceCache(root, device="cpu"), config, target)
    want = jservice.run_search_config(JaxCache(root, mesh=None), config, target)
    assert_tables_match(got, want)
    assert got.num_rows == 21 and got.column_names == ["id", "tag", "__DISTANCE__", "__QUERY_ID__"]


def test_extension_vector_column_searches_as_jax(tmp_path, rng):
    """A tensor column the JAX package wrote is searched through its
    storage: the JAX package's answer, the typed column returned typed."""
    from fenix_tpu.types import tensor as jtensor

    root = str(tmp_path)
    vectors = rng.standard_normal((64, 4)).astype(np.float32)
    arr = jtensor.TensorArray.from_numpy(vectors)
    jtable.make(root, "typed", pa.table({"vector": arr}).to_reader())
    req = dict(source="typed", column="vector", target=vectors[:2] + 0.01, metric="cosine", maxval=3)
    got = executor.execute_search(DeviceCache(root, device="cpu"), executor.SearchRequest(**req))
    want = jexecutor.execute_search(JaxCache(root, mesh=None), jexecutor.SearchRequest(**req))
    assert_tables_match(got, want)
    assert isinstance(got.column("vector").type, jtensor.TensorType)


def test_port_imports_without_jax(tmp_path):
    """Importing every module of the port loads no JAX and no module of
    the JAX package, and registers no extension type: a typed file reads
    back in its storage form."""
    import pyarrow as pa_

    from fenix_tpu.types import quint8 as jquint8

    path = str(tmp_path / "q.arrow")
    arr = jquint8.from_numpy(np.ones((4, 8), np.float32))
    with pa_.OSFile(path, "wb") as sink, pa_.ipc.new_stream(sink, pa_.schema({"q": arr.type})) as w:
        w.write_table(pa_.table({"q": arr}))
    code = (
        "import sys, pyarrow as pa, fenix_tpu_torch, fenix_tpu_torch.launch, fenix_tpu_torch.ops.kernels, "
        "fenix_tpu_torch.ops.select, fenix_tpu_torch.ops.relational, "
        "fenix_tpu_torch.parallel.distributed, fenix_tpu_torch.parallel.mesh, fenix_tpu_torch.parallel.search, "
        "fenix_tpu_torch.utils.threefry, "
        "fenix_tpu_torch.types, fenix_tpu_torch.utils.profiling, fenix_tpu_torch.utils.replay, "
        "fenix_tpu_torch.examples.quickstart; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')) "
        "or m == 'fenix_tpu' or m.startswith('fenix_tpu.')); "
        "assert not bad, bad; "
        f"field = pa.ipc.open_stream({path!r}).read_all().schema.field('q'); "
        "assert not isinstance(field.type, pa.BaseExtensionType), field; "
        "assert field.metadata[b'ARROW:extension:name'] == b'fenix_tpu.quint8', field; "
        # the three names are free: the port's own registration succeeds
        "fenix_tpu_torch.types.register_all(); "
        f"assert isinstance(pa.ipc.open_stream({path!r}).read_all().column('q').type, "
        "fenix_tpu_torch.types.QUInt8TensorType)"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, env=env, timeout=120)


def test_residency_does_not_import_the_executor():
    """``engine/residency.py`` lies below the executor: it imports nothing
    of ``engine.executor``, in any form, so the request path runs one way."""
    import ast

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "fenix_tpu_torch", "engine", "residency.py")) as fh:
        tree = ast.parse(fh.read())
    package = ["fenix_tpu_torch", "engine"]
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(package[: len(package) - node.level + 1] if node.level else [])
            module = ".".join(x for x in (base, node.module or "") if x)
            imported += [module] + [f"{module}.{a.name}" for a in node.names]
    assert imported and "fenix_tpu_torch.engine.session" in imported
    assert not [m for m in imported if m.startswith("fenix_tpu_torch.engine.executor")], imported


# (route, request fields) of the retry test: one case per route of the shell
RETRY_ROUTES = {
    "dual_topk": dict(residency="dual", maxval=5),
    "int8_topk": dict(residency="int8", maxval=5),
    "stream_topk": dict(residency="stream", maxval=5),
    "probed_host_topk": dict(residency="stream", maxval=5, coding="ivf", probes=4, metric=None),
    "host_read": dict(residency="stream", maxval=None),
}


@pytest.mark.parametrize("route", list(RETRY_ROUTES))
def test_one_retry_on_every_route(root, rng, monkeypatch, route):
    """A catalog mutation that lands between the revision snapshot and the
    stamp check (the stamp moves once) is retried, and the answer is a
    cold cache's; a stamp that moves at every check raises ``kept
    changing`` after exactly four attempts. The device route and the
    host-corpus routes share the one retry."""
    kw = RETRY_ROUTES[route]
    if "coding" in kw:
        config = {"metric": "l2", "codebook_size": 8, "num_codebooks": 1, "batch_size": 512, "num_epochs": 1}
        coder.make(root, "ivf", "items", "vector", config, seed=0, device="cpu")
        index.make(root, "ivf", "items", "vector", device="cpu")
    target = rng.standard_normal((3, DIM)).astype(np.float32)
    req = executor.SearchRequest(**{"source": "items", "column": "vector", "target": target, "metric": "l2", **kw})
    cold = executor.execute_search(DeviceCache(root, device="cpu"), req)
    cache = DeviceCache(root, device="cpu")
    executor.execute_search(cache, req)  # warm: an attempt now reads the stamp a fixed number of times
    real = cache.snapshot_stamp
    calls, moved = [], set()

    def stamp(*args):
        calls.append(args)
        return real(*args) + (("moved", len(calls)) if len(calls) in moved else ())

    monkeypatch.setattr(cache, "snapshot_stamp", stamp)
    assert executor.execute_search(cache, req).equals(cold)
    per_attempt = len(calls)  # the last read of an attempt is its stamp check
    calls.clear()
    moved.add(per_attempt)
    assert executor.execute_search(cache, req).equals(cold)
    assert len(calls) == 2 * per_attempt  # one retry
    calls.clear()
    moved.update(per_attempt * i for i in range(1, 5))
    with pytest.raises(RuntimeError, match="kept changing during search"):
        executor.execute_search(cache, req)
    assert len(calls) == 4 * per_attempt


def _chip_smoke(*args):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # the script and its server subprocess
    return subprocess.run(
        [sys.executable, os.path.join(repo, "chip_smoke.py"), *args],
        capture_output=True, text=True, cwd=repo, env=env, timeout=300,
    )


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    done = _chip_smoke()
    assert done.returncode != 0 and '"ok": true' not in done.stdout


def _load_chip_smoke():
    """chip_smoke.py's helpers; the script itself runs only on a card."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load_chip_smoke()


@pytest.mark.parametrize("case", ["equal", "within", "off", "nan", "neginf"])
@pytest.mark.parametrize("route", ["f32", "bf16", "int8"])
def test_chip_smoke_check_close(rng, route, case):
    """The kernel-vs-plain check passes the plain maxima, and inside its
    tolerance, and refuses an error past it, a NaN and a lost -inf."""
    n, q, bucket = 4096, 8, 32
    v32 = torch.from_numpy(rng.standard_normal((n, smoke.D)).astype(np.float32))
    q32 = torch.from_numpy(rng.standard_normal((q, smoke.D)).astype(np.float32))
    mul = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    add = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    add[: 2 * bucket] = float("-inf")  # two whole buckets masked
    if route == "f32":
        args = (q32, v32, mul, add, None)
    elif route == "bf16":
        args = (q32.to(torch.bfloat16), v32.to(torch.bfloat16), mul, add, None)
    else:
        v8, sv = topk2.quantize_corpus_int8(v32)
        q8, inv_sq = topk2.quantize_queries_int8(q32)
        args = (q8, v8, mul * sv, add, inv_sq)
    qq, vv, mm, aa, isq = args
    want = kernels.bucket_scores_plain(qq, vv, mm, aa, bucket, isq)
    assert torch.isneginf(want[:, :2]).all() and torch.isfinite(want[:, 2:]).all()
    got = want.clone()
    if case == "within":
        got[:, 2:] += 1e-7 * want[:, 2:].abs()
    elif case == "off":
        got[0, 5] += 1.0 + 0.01 * float(want[:, 2:].abs().max())
    elif case == "nan":
        got[1, 3] = float("nan")
    elif case == "neginf":
        got[2, 0] = 0.0
    if case in ("equal", "within"):
        err = smoke.check_close(got, want, qq, vv, mm, aa, isq)
        assert err == 0.0 if case == "equal" else err > 0.0
    else:
        with pytest.raises(AssertionError):
            smoke.check_close(got, want, qq, vv, mm, aa, isq)


@pytest.mark.parametrize(
    "route,q,n,d,bucket,want_ms,want_by",
    [
        # by hand: (8,388,609 x 128 x 4 + 8 x 8,388,608 + 4 x 65,536) B / 3.35 TB/s
        ("f32", 1, 8_388_608, 128, 128, 4_362_338_816 / 3.35e12 * 1e3, "read"),
        # 2 x 1024 x 8,388,608 x 128 = 2.199 TFLOP / 67 TFLOP/s
        ("f32", 1024, 8_388_608, 128, 32, 2_199_023_255_552 / 67e12 * 1e3, "f32"),
        # 2 x 1024 x 4,194,304 x 768 = 6.597 TOP / 1,979 TOP/s
        ("int8", 1024, 4_194_304, 768, 32, 6_597_069_766_656 / 1979e12 * 1e3, "int8"),
        # (8,388,672 x 128 x 2 + 8 x 8,388,608 + 4 x 64 x 65,536) B / 3.35 TB/s
        ("bf16", 64, 8_388_608, 128, 128, 2_231_386_112 / 3.35e12 * 1e3, "read"),
    ],
)
def test_chip_smoke_bound(route, q, n, d, bucket, want_ms, want_by):
    """The bound of a phase-1 call against hand-computed rows: 1.302 ms
    (read), 32.82 ms (fp32), 3.334 ms (int8), 0.666 ms (read)."""
    got = smoke.bound(route, q, n, d, bucket)
    assert got["bound_by"] == want_by
    assert got["bound_ms"] == pytest.approx(want_ms, rel=1e-12)
    assert round(got["bound_ms"], 2) == {"f32": {1: 1.30, 1024: 32.82}, "int8": {1024: 3.33},
                                         "bf16": {64: 0.67}}[route][q]


def test_chip_smoke_library_fn(rng):
    """The library yardstick: matmul for f32/bf16, _int_mm for int8 where
    its shape rules allow: a chunk of more than 16 queries on the left, of
    16 or fewer (a multiple of 8) on the right as V8 · Q8ᵀ, else None; a
    width that is not a multiple of 8 on zero-padded copies (the same
    products)."""
    v = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    v8, _ = topk2.quantize_corpus_int8(v)
    for q in (v[:3], v[:3].to(torch.bfloat16)):
        smoke.library_fn(q, v.to(q.dtype))()
    smoke.library_fn(v8[:8], v8)()  # 8 queries: V8 · Q8ᵀ
    assert smoke.library_fn(v8[:3], v8) is None  # 3 queries fit neither side
    assert smoke.library_fn(v8[:33], v8, chunk=16) is None  # a 1-row last chunk
    smoke.library_fn(v8[:40], v8)()
    w8 = v8[:, :30].contiguous()  # 30 wide
    smoke.library_fn(w8[:40], w8)()
    smoke.library_fn(w8[:8], w8)()


def test_chip_smoke_kernel_entries():
    """The kernels line: one entry per design and K3, timed at the largest
    main-path shape, refused when a design misses a path it must run on
    (the generic designs: the glove100 path)."""
    def row(kernel, route, q, n, bucket, ms, search=None, d=smoke.D):
        return {"kernel": kernel, "route": route, "q": q, "n": n, "d": d, "bucket": bucket, "search": search,
                "max_abs_err": 1e-6 * q, "ms": ms, "plain_ms": 2 * ms, "library_ms": None,
                **smoke.bound(route, q, n, d, bucket)}
    glove_n = smoke.glove_rows_scanned()
    rows = [row("stream", "f32", 8, 1 << 20, 128, 1.0), row("stream", "f32", 8, 1 << 23, 128, 2.0, "q8"),
            row("tiled", "f32", 1024, 1 << 23, 32, 60.0, "q1024"), row("tiled", "f32", 64, 1 << 23, 128, 4.0),
            row("tensor_int8", "int8", 8, 1 << 22, 128, 1.5, "auto_q8"),
            row("generic_int8", "int8", 1024, 1 << 23, 32, 6.0, d=100),
            row("generic_int8", "int8", 1024, glove_n, 32, 0.9, "glove_q1024_int8", d=100),
            row("generic_int8", "int8", 8, glove_n, 128, 0.1, "glove_q8_int8", d=100),
            row("generic_bf16", "bf16", 1024, 1 << 23, 32, 9.0, d=100),
            row("generic_bf16", "bf16", 1024, glove_n, 32, 1.4, "glove_q1024_bf16", d=100),
            row("tensor_bf16", "bf16", 64, 1 << 23, 128, 0.8, "q64_bf16"), row("tensor_bf16", "bf16", 1024, 1 << 23, 32, 4.0)]
    for r in rows:
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    counts = {"f32": 3, "f32.bucket128": 2, "kernel.stream": 2, "kernel.tiled": 1, "kernel.tensor_int8": 4,
              "kernel.generic_int8": 0, "kernel.tensor_bf16": 1, "kernel.generic_bf16": 0}
    selection = {**{k: 0 for k in counts}, "f32": 1, "int8": 1, "kernel.tiled": 1, "kernel.tensor_int8": 1}
    bf16 = {"bf16": 4, "kernel.tensor_bf16": 4}
    glove = {**{k: 0 for k in counts}, "int8": 2, "bf16": 2, "kernel.generic_int8": 2, "kernel.generic_bf16": 2}
    by_path = {"exact": counts, "glove100": glove,
               "residency": {**counts, "kernel.tiled": 0, "kernel.tensor_bf16": 0},
               "selection": selection,
               "mutation": {**selection, "kernel.stream": 1}, "analytics": {**selection, "kernel.stream": 3},
               "batching": {**selection, "kernel.stream": 7, "kernel.tensor_int8": 0},
               "types": {**selection, "kernel.stream": 2, "bf16": 1, "kernel.tensor_bf16": 1},
               "mesh": {**selection, **bf16, "kernel.stream": 4, "f32.bucket128": 4},
               "mesh_analytics": {**selection, "kernel.stream": 4},
               "repartition": {**selection, **bf16, "kernel.stream": 4, "f32.bucket128": 4},
               "multihost": {**selection, **bf16, "kernel.stream": 4, "f32.bucket128": 4}}
    entries = {e["name"]: e for e in smoke.kernel_entries(rows, by_path)}
    assert set(entries) == {k[0] for k in smoke.KERNELS}
    for name in ("generic_int8", "generic_bf16"):  # timed at the glove100 path's Q=1024, not the forced rows
        generic = entries[f"bucket_scores.kernel.{name}"]
        assert generic["launches"] == 2 and generic["launches_by_path"]["glove100"] == 2
        assert generic["timed_at"]["search"].startswith("glove_q1024")
        assert generic["timed_at"]["n"] == glove_n and generic["timed_at"]["d"] == 100
        assert generic["source"] == "fenix_tpu_torch/csrc/bucket_scores_tensor.cu"
    assert entries["bucket_scores.kernel.generic_int8"]["ms"] == 0.9
    assert entries["bucket_scores.kernel.generic_bf16"]["replaces"] == "fenix_tpu/ops/topk2.py:453"
    assert entries["bucket_scores.kernel.tensor_int8"]["launches"] == 16
    tiled = entries["bucket_scores.kernel.tiled"]
    assert tiled["ms"] == 60.0 and tiled["bound_by"] == "operations" and tiled["launches"] == 10
    assert tiled["launches_by_path"] == {"exact": 1, "glove100": 0, "residency": 0, "selection": 1, "mutation": 1,
                                         "analytics": 1, "batching": 1, "types": 1, "mesh": 1,
                                         "mesh_analytics": 1, "repartition": 1, "multihost": 1}
    assert tiled["timed_at"]["search"] == "q1024"
    tensor_bf16 = entries["bucket_scores.kernel.tensor_bf16"]  # timed at its main-path shape, not the forced Q=1024
    assert tensor_bf16["ms"] == 0.8 and tensor_bf16["launches"] == 14
    assert tensor_bf16["replaces"] == "fenix_tpu/ops/topk2.py:453"
    assert tensor_bf16["source"] == entries["bucket_scores.kernel.tensor_int8"]["source"]
    stream = entries["bucket_scores.kernel.stream"]
    assert stream["ms"] == 2.0 and stream["bound_by"] == "bytes" and stream["launches"] == 33
    assert entries["bucket_scores.f32@bucket128"]["launches_by_path"]["repartition"] == 4
    assert entries["bucket_scores.f32@bucket128"]["launches_by_path"]["multihost"] == 4
    assert entries["bucket_scores.f32@bucket128"]["replaces"] == "fenix_tpu/ops/topk2.py:357"
    for e in entries.values():
        assert {"bound_ms", "library_ms", "max_abs_err", "plain_ms", "launches"} <= set(e)
    by_path["residency"]["kernel.stream"] = 0
    with pytest.raises(AssertionError, match="stream was not launched on the residency path"):
        smoke.kernel_entries(rows, by_path)
    by_path["residency"]["kernel.stream"], selection["kernel.tiled"] = 2, 0
    with pytest.raises(AssertionError, match="tiled was not launched on the selection path"):
        smoke.kernel_entries(rows, by_path)
    selection["kernel.tiled"], by_path["mutation"]["kernel.tensor_int8"] = 1, 0
    with pytest.raises(AssertionError, match="tensor_int8 was not launched on the mutation path"):
        smoke.kernel_entries(rows, by_path)
    by_path["mutation"]["kernel.tensor_int8"], by_path["batching"]["kernel.stream"] = 1, 0
    with pytest.raises(AssertionError, match="stream was not launched on the batching path"):
        smoke.kernel_entries(rows, by_path)
    by_path["batching"]["kernel.stream"], by_path["analytics"]["kernel.tensor_int8"] = 7, 0
    with pytest.raises(AssertionError, match="tensor_int8 was not launched on the analytics path"):
        smoke.kernel_entries(rows, by_path)
    by_path["analytics"]["kernel.tensor_int8"], by_path["types"]["kernel.stream"] = 1, 0
    with pytest.raises(AssertionError, match="stream was not launched on the types path"):
        smoke.kernel_entries(rows, by_path)
    by_path["types"]["kernel.stream"], by_path["mesh"]["f32.bucket128"] = 2, 0
    with pytest.raises(AssertionError, match="f32@bucket128 was not launched on the mesh path"):
        smoke.kernel_entries(rows, by_path)
    by_path["mesh"]["f32.bucket128"], by_path["mesh_analytics"]["kernel.tiled"] = 4, 0
    with pytest.raises(AssertionError, match="tiled was not launched on the mesh_analytics path"):
        smoke.kernel_entries(rows, by_path)
    by_path["mesh_analytics"]["kernel.tiled"], by_path["repartition"]["kernel.tensor_int8"] = 1, 0
    with pytest.raises(AssertionError, match="tensor_int8 was not launched on the repartition path"):
        smoke.kernel_entries(rows, by_path)
    by_path["repartition"]["kernel.tensor_int8"], by_path["repartition"]["f32.bucket128"] = 1, 0
    with pytest.raises(AssertionError, match="f32@bucket128 was not launched on the repartition path"):
        smoke.kernel_entries(rows, by_path)
    by_path["repartition"]["f32.bucket128"], by_path["multihost"]["kernel.tiled"] = 4, 0
    with pytest.raises(AssertionError, match="tiled was not launched on the multihost path"):
        smoke.kernel_entries(rows, by_path)
    by_path["multihost"]["kernel.tiled"], by_path["types"]["kernel.tensor_bf16"] = 1, 0
    with pytest.raises(AssertionError, match="tensor_bf16 was not launched on the types path"):
        smoke.kernel_entries(rows, by_path)
    by_path["types"]["kernel.tensor_bf16"], glove["kernel.generic_int8"] = 1, 0
    with pytest.raises(AssertionError, match="generic_int8 was not launched on the glove100 path"):
        smoke.kernel_entries(rows, by_path)
    glove["kernel.generic_int8"], glove["kernel.generic_bf16"] = 2, 0
    with pytest.raises(AssertionError, match="generic_bf16 was not launched on the glove100 path"):
        smoke.kernel_entries(rows, by_path)


SMOKE_ROWS = 16_384


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    """chip_smoke.py's table (duplicate rows, tags) at a small size."""
    vectors, ids, tags = smoke.make_data(SMOKE_ROWS, seed=0)
    root = str(tmp_path_factory.mktemp("smoke"))
    t = pa.table({"id": pa.array(ids),
                  "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
                  "tag": pa.array(tags)})
    table.make(root, "items", t.to_reader(max_chunksize=4096))
    return root, vectors, tags


def _smoke_search(smoke_root, i):
    """Search ``i`` of chip_smoke.py through the port's engine on the CPU,
    at no more than 100 queries."""
    root, vectors, tags = smoke_root
    name, qn, metric, k, precision, filtered, flat = smoke.SEARCHES[i]
    spec = (name, min(qn, 100), metric, k, precision, filtered, flat)
    queries = smoke.make_queries(vectors, spec[1], seed=10 + i)
    req = executor.SearchRequest(
        "items", "vector", queries[0] if flat else queries, metric=metric, maxval=k,
        precision=precision, filter=(expr.field("tag") < 50) if filtered else None,
    )
    result = executor.execute_search(DeviceCache(root, device="cpu"), req)
    mask = torch.from_numpy(tags < 50) if filtered else None
    return spec, queries, result, mask


@pytest.mark.parametrize("i", range(len(smoke.SEARCHES)), ids=[s[0] for s in smoke.SEARCHES])
def test_chip_smoke_oracle_accepts_the_port(smoke_root, i):
    """Each search of chip_smoke.py, answered by the port on the CPU,
    passes the script's float64 oracle check."""
    spec, queries, result, mask = _smoke_search(smoke_root, i)
    oracle = smoke.Oracle(smoke_root[1], "cpu")
    out = smoke.check_search(oracle, spec, queries, result, mask)
    assert out["max_rel_dist_err"] <= 1e-4
    # fp32 is held to the oracle's order (near ties aside), the scan copies to recall
    assert ("ids_equal_positions" in out) == (spec[4] == "fp32") != ("recall" in out)


def _with_ids(result, ids, dist):
    cols = {name: result.column(name) for name in result.column_names}
    cols["id"] = pa.array(ids.reshape(-1))
    cols["__DISTANCE__"] = pa.array(dist.reshape(-1), type=result.schema.field("__DISTANCE__").type)
    return pa.table(cols)


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_chip_smoke_probe_cells_are_held_to_float64(monkeypatch, metric):
    """server_cells takes the server's own ranking and holds it to a
    float64 ranking of the cells: a probe set with one far cell fails; one
    that takes a centroid's exact twin in place of the smaller id passes,
    counted as a near-tie difference."""
    monkeypatch.setattr(smoke, "DEVICE", "cpu")
    rng = np.random.default_rng(5)
    books = rng.standard_normal((1, 64, 16)).astype(np.float32)
    queries = rng.standard_normal((12, 16)).astype(np.float32)
    got = smoke.server_cells(queries, books, metric, 8, "test")
    np.testing.assert_array_equal(got, executor.rank_cells("cpu", queries, books, metric, 8)[0])
    assert smoke.cells_off_float64(got, queries, books, metric) == 0
    d = smoke.cell_distances64(queries, books, metric, "cpu").numpy()
    wrong = got.copy()
    wrong[0, -1] = np.argmax(d[0])
    with pytest.raises(AssertionError, match="off a near tie"):
        smoke.cells_off_float64(wrong, queries, books, metric)
    last, far = got[0, -1], np.argmax(d[0])
    books[0, far] = books[0, last]  # query 0's 8th and 9th cells tie exactly
    got = smoke.server_cells(queries, books, metric, 8, "test")
    assert min(last, far) in got[0] and max(last, far) not in got[0]
    swapped = np.where(got == min(last, far), max(last, far), got)
    swapped[1:] = got[1:]
    assert smoke.cells_off_float64(swapped, queries, books, metric) == 1


def test_chip_smoke_check_search_takes_a_short_result(smoke_root, tmp_path):
    """A filtered 1-probe IVF search whose probe cell holds fewer than k
    allowed rows returns them all and no more; check_search takes the
    short result and holds its count to the oracle's (min(k, allowed
    rows)): a row dropped from it fails."""
    from fenix_tpu_torch import coder
    from fenix_tpu_torch import index as index_mod
    from fenix_tpu_torch.io import arrow
    from fenix_tpu_torch.ops import cells

    _, vectors, tags = smoke_root
    root = str(tmp_path)
    table.make(root, "items", pa.table({
        "id": pa.array(np.arange(SMOKE_ROWS)), "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
        "tag": pa.array(tags)}).to_reader(max_chunksize=4096))
    config = {"metric": "l2", "codebook_size": 1024, "num_codebooks": 1, "batch_size": 4096, "num_epochs": 1}
    codebooks = coder.make(root, "c", "items", "vector", config, seed=0, device="cpu")["tensor"]
    index_mod.make(root, "c", "items", "vector", device="cpu")
    codes = arrow.load(index_mod.path_of(root, "c", "items", "vector")).column(index_mod.CODE_COL).to_numpy()
    queries = smoke.make_queries(vectors, 8, seed=30)
    result = executor.execute_search(DeviceCache(root, device="cpu"), executor.SearchRequest(
        "items", "vector", queries, metric="l2", maxval=10, coding="c", probes=1, filter=expr.field("tag") < 50))
    probe = cells.topk_cells_np(queries, codebooks, "l2", 1)
    mask = smoke.probe_mask(torch.from_numpy(np.array(codes)), probe, torch.from_numpy(tags), n_cells=1024)
    counts = np.bincount(result.column("__QUERY_ID__").to_numpy(), minlength=8)
    assert counts.min() < 10  # a short query is exercised
    spec = ("ivf_short", 8, "l2", 10, "fp32", True, False)
    oracle = smoke.Oracle(vectors, "cpu")
    assert smoke.check_search(oracle, spec, queries, result, mask)["ids_equal_positions"] == 1.0
    qid = result.column("__QUERY_ID__").to_numpy()
    last_short = np.flatnonzero(qid == int(np.argmin(counts)))[-1]
    dropped = result.filter(pa.array(np.arange(result.num_rows) != last_short))
    with pytest.raises(AssertionError, match=r"min\(k, allowed rows\)"):
        smoke.check_search(oracle, spec, queries, dropped, mask)


def test_chip_smoke_oracle_refuses_wrong_order(smoke_root):
    """Reordered results and a duplicate-row tie out of id order both
    fail the oracle check, with ids and distances kept consistent."""
    spec, queries, result, mask = _smoke_search(smoke_root, 1)  # Q=8 cosine k=10
    oracle = smoke.Oracle(smoke_root[1], "cpu")
    ids, dist = smoke.split_result(result, spec[1], spec[3])
    with pytest.raises(AssertionError, match="ids differ"):
        smoke.check_search(oracle, spec, queries, _with_ids(result, ids[:, ::-1], dist[:, ::-1]),
                           mask)
    row, col = next((r, c) for r in range(ids.shape[0]) for c in range(ids.shape[1] - 1)
                    if ids[r, c + 1] == ids[r, c] + smoke.DUP)
    swapped = ids.copy()
    swapped[row, [col, col + 1]] = swapped[row, [col + 1, col]]
    with pytest.raises(AssertionError, match="not in id order"):
        smoke.check_search(oracle, spec, queries, _with_ids(result, swapped, dist), mask)


@pytest.mark.parametrize("sizes,n_ids", [((4, 0, 7, 1, 0, 5), 50), ((9,), 20),
                                         ((700,) * 30 + (0, 13), 3 * executor._THREADED_GATHER_ROWS)],
                         ids=["few", "one_chunk", "threaded"])
def test_gather_chunked_matches_concatenation(rng, sizes, n_ids):
    chunks = [rng.standard_normal((n, 3)).astype(np.float32) for n in sizes]
    whole = np.concatenate(chunks)
    ids = rng.integers(0, whole.shape[0], n_ids)
    np.testing.assert_array_equal(executor._gather_chunked(chunks, ids), whole[ids])


def test_native_gather_rows_into_a_buffer(rng):
    from fenix_tpu_torch import native

    x = rng.standard_normal((100, 8)).astype(np.float32)
    idx = rng.integers(0, 100, 30)
    out = np.empty((30, 8), np.float32)
    assert native.gather_rows(x, idx, out=out) is out
    np.testing.assert_array_equal(out, x[idx])
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_rows(x, idx, out=np.empty((30, 8), np.float64))


def test_chip_smoke_check_rises():
    """Phase 6's per-call check: the route's launches and the residency
    counter must move by exactly the expected amounts."""
    spec = next(s for s in smoke.RES_SEARCHES if s[0] == "stream_q8")  # f32 x10, 10 chunks
    key = "kernel.bucket_scores.f32.launches"
    before = {key: 3.0, "search.stream_chunks": 5.0}
    smoke.check_rises("stream_q8", before, {key: 13.0, "search.stream_chunks": 15.0}, spec)
    with pytest.raises(AssertionError, match="kernel launches"):
        smoke.check_rises("stream_q8", before, {key: 12.0, "search.stream_chunks": 15.0}, spec)
    with pytest.raises(AssertionError, match="search.stream_chunks"):
        smoke.check_rises("stream_q8", before, {key: 13.0, "search.stream_chunks": 16.0}, spec)


@pytest.fixture(scope="module")
def smoke_wide_root(tmp_path_factory):
    """Phase 6's table (duplicate rows, tags) at a small size and width."""
    vectors, ids, tags = smoke.make_data(SMOKE_ROWS, seed=1, dim=64)
    root = str(tmp_path_factory.mktemp("smoke_wide"))
    t = pa.table({"id": pa.array(ids),
                  "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
                  "tag": pa.array(tags)})
    table.make(root, "wide", t.to_reader(max_chunksize=4096))
    return root, vectors, tags


@pytest.mark.parametrize("spec", smoke.RES_SEARCHES, ids=[s[0] for s in smoke.RES_SEARCHES])
def test_chip_smoke_residency_oracle_accepts_the_port(smoke_wide_root, monkeypatch, spec):
    """Each search of chip_smoke.py's phase 6, answered by the port on the
    CPU (at most 64 queries) past a budget that routes auto to int8,
    passes the script's float64 oracle as the script grades it."""
    root, vectors, tags = smoke_wide_root
    name, qn, mode, precision = spec[:4]
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(2 << 20))  # dual 4.5 MB, int8 1.3 MB
    pool = np.flatnonzero((tags[: smoke.DUP] < 50) & (tags[smoke.DUP : 2 * smoke.DUP] < 50))
    q = min(qn, 64)
    queries = smoke.make_queries(vectors, q, seed=100 + qn, src_pool=pool)
    cache = DeviceCache(root, device="cpu")
    req = executor.SearchRequest(
        "wide", "vector", queries, metric="l2", maxval=smoke.RES_K, precision=precision,
        residency=mode, filter=expr.field("tag") < 50,
    )
    if mode == "auto":
        assert residency.plan(cache, req) == residency.INT8
    result = executor.execute_search(cache, req)
    graded = "int8" if name in smoke.RES_INT8_GRADED else "fp32"
    out = smoke.check_search(
        smoke.Oracle(vectors, "cpu"), (name, q, "l2", smoke.RES_K, graded, True, False),
        queries, result, torch.from_numpy(tags < 50),
    )
    assert out["max_rel_dist_err"] <= 1e-4 and out["ties_in_results"] > 0


def test_chip_smoke_ivf_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 7 of chip_smoke.py rehearsed on the CPU at a small size: the
    port's server (CPU device) builds the coder and the index over Flight,
    the four probed searches take their routes, and every check after the
    server (assignment, device step, oracle, the timed ops) passes."""
    import threading

    import fenix_tpu_torch
    from fenix_tpu_torch.ops import kmeans

    vectors, ids, tags = smoke.make_data(SMOKE_ROWS, seed=0)
    root = str(tmp_path)
    t = pa.table({"id": pa.array(ids), "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
                  "tag": pa.array(tags)})
    table.make(root, "smoke/items", t.to_reader(max_chunksize=4096))
    for name, value in {
        "DEVICE": "cpu", "ROWS": SMOKE_ROWS, "IVF_CELLS": 64, "WARM_REPS": 1, "IVF_SAMPLE_ROWS": 4096,
        "IVF_STEP_ROWS": 2048, "IVF_CHECKED": 16,
        "IVF_CONFIG": {"metric": "l2", "codebook_size": 64, "num_codebooks": 1, "batch_size": 1024,
                       "num_epochs": 2},
        # 64 cells over 16,384 padded rows (k-means on these isotropic rows
        # leaves a few hub cells of ~1,000 rows): Q=1 and Q=8 at one probe
        # fit the gather rule, Q=100 and Q=70 do not
        "IVF_SEARCHES": (("ivf_q1_p16", 1, 4, False, "fp32", "clustered", None),
                         ("ivf_q8_p64_filtered", 8, 1, True, "fp32", "clustered", "l2"),
                         ("ivf_q1024_p64", 100, 8, False, "fp32", "scan", None),
                         ("ivf_q256_p64_int8", 70, 8, False, "int8", "scan", "l2")),
        "time_ms": lambda fn, reps: (fn(), 1.0)[1],
    }.items():
        monkeypatch.setattr(smoke, name, value)
    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    client = fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port)
    try:
        ivf = smoke.phase_ivf_serve(client, expr, vectors, root, "cpu", "cpu")
    finally:
        client.close()
        server.shutdown()
    assert ivf["codebooks"].shape == (1, 64, smoke.D) and not any(ivf["launches"].values())
    out = smoke.phase_ivf_checks(kernels, topk2, smoke.Oracle(vectors, "cpu"), vectors, tags, ivf,
                                 "cpu", "cpu")
    assert [c["queries_checked"] for c in out["oracle"]] == [1, 8, 16, 16]
    assert out["device_step"][1]["coder"] == "composite_2x64"
    assert out["timings"]["clustered"]["shape"]["probes"] == 1
    # the check refuses a search sent down the other route
    with pytest.raises(AssertionError, match="search.ivf_scan rose by 1.0, expected 0"):
        smoke.check_route("x", {"search.ivf_clustered": 3.0, "search.ivf_scan": 1.0},
                          {"search.ivf_clustered": 4.0, "search.ivf_scan": 2.0}, "clustered")
    assert kmeans.draw_indices(10, 0, 1, 2, 4, 1)[0].shape == (2,)


def test_chip_smoke_selection_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 8 of chip_smoke.py rehearsed on the CPU at a small size, on
    the port's server (CPU device) after phase 7: the filtered searches on
    both filter routes with their counter checks, the three device
    no-top-k reads, then (d) the host-corpus read under a low budget, and
    every oracle check after the server."""
    import threading

    import fenix_tpu_torch

    vectors, ids, tags = smoke.make_data(SMOKE_ROWS, seed=0)
    root = str(tmp_path)
    t = pa.table({"id": pa.array(ids), "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
                  "tag": pa.array(tags)})
    table.make(root, "smoke/items", t.to_reader(max_chunksize=4096))
    for name, value in {
        "DEVICE": "cpu", "ROWS": SMOKE_ROWS, "IVF_CELLS": 64, "WARM_REPS": 1, "SEL_READ_REPS": 1,
        "IVF_CONFIG": {"metric": "l2", "codebook_size": 64, "num_codebooks": 1, "batch_size": 1024,
                       "num_epochs": 2},
        "IVF_SEARCHES": (("ivf_q8_p64_filtered", 8, 1, True, "fp32", "clustered", "l2"),),
        "SEARCHES": tuple((s[0], min(s[1], 100), *s[2:]) for s in smoke.SEARCHES),
        "SEL_READS": tuple((s[0], s[1], s[2], s[3], s[4] and 4) for s in smoke.SEL_READS),
        "SEL_ORACLE_ROWS": 5000,
    }.items():
        monkeypatch.setattr(smoke, name, value)
    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    client = fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port)
    try:
        queries = [smoke.make_queries(vectors, s[1], seed=10 + i) for i, s in enumerate(smoke.SEARCHES)]
        results = []
        for spec, qnp in zip(smoke.SEARCHES, queries):
            name, qn, metric, k, precision, filtered, flat = spec
            results.append(client.search(qnp[0] if flat else qnp, "smoke/items", "vector", metric=metric,
                                         maxval=k, precision=precision,
                                         filter=(expr.field("tag") < 50) if filtered else None))
        ivf = smoke.phase_ivf_serve(client, expr, vectors, root, "cpu", "cpu")
        sel = smoke.phase_selection_serve(client, expr, kernels, vectors, tags,
                                          smoke.rerun_specs(queries, results, ivf), "cpu", "cpu")
        monkeypatch.setenv("FENIX_HBM_BUDGET", str(1 << 20))  # the host corpus serves the read
        spec = smoke.SEL_HOST_READ
        host_queries = smoke.make_queries(vectors, spec[1], seed=400)
        host_read, row = smoke.selection_read(client, expr, spec, "smoke/items", host_queries, "cpu", "cpu",
                                              "search.residency_host_nomax", pushdown=False)
        # the device read's counter does not move on the host route
        with pytest.raises(AssertionError, match="search.nomax_selected rose by 0"):
            smoke.selection_read(client, expr, spec, "smoke/items", host_queries, "cpu", "cpu",
                                 "search.nomax_selected", pushdown=True)
    finally:
        client.close()
        server.shutdown()
    monkeypatch.setattr(smoke, "time_ms", lambda fn, reps: (fn(), 1.0)[1])
    timed = smoke.selection_timings(vectors, tags, ivf, "cpu", "cpu")
    assert set(timed) == {"mask_build", "permutation_take", "count_pass_mask", "compact_chunk",
                          "count_pass_probed"}
    host = smoke.host_read_timings(vectors, tags, host_queries, "cpu", "cpu")
    assert host["host_l2_distances"]["shape"]["rows"] == int((tags == 7).sum())
    assert [r["search"] for r in sel["pushdown"]] == [s[0] for s in smoke.SEL_PUSHDOWN]
    assert not any(sel["launches"].values())  # CPU tensors launch nothing
    oracle = smoke.Oracle(vectors, "cpu")
    checks = smoke.phase_selection_checks(oracle, tags, ivf, sel)
    assert [c["rows"] for c in checks][2] == SMOKE_ROWS  # the full read
    assert 0 < checks[0]["rows_per_query"] < SMOKE_ROWS // 50
    rows = np.flatnonzero(tags == 7)
    checked = smoke.check_selection(oracle, spec[0], "l2", host_queries, host_read, lambda qi: rows)
    assert checked["rows"] == 8 * rows.size
    # the oracle refuses a read that drops a row or reorders a query's rows
    one = pa.table({"id": pa.array(rows[::-1]), "__DISTANCE__": pa.array(np.zeros(rows.size, np.float32))})
    with pytest.raises(AssertionError, match="selected rows in table order"):
        smoke.check_selection(oracle, "x", "l2", host_queries[:1], one, lambda qi: rows)


def test_chip_smoke_glove_phase_on_the_cpu(tmp_path, monkeypatch):
    """The glove100 path of chip_smoke.py rehearsed on the CPU at a small
    size on the port's server (CPU device): a 100-wide table whose row count
    is not a multiple of the engine's 16,384-row block, its four searches
    over Flight, then the float64 oracle by the fp32 rule with distances
    within 1e-5 and the phase-1 rows at the padded row count. A spy on the
    phase-1 wrapper shows the engine scanning the padded count with the
    bucket it sets (128 at Q <= 64, 32 above; the unpadded 17,618 rows
    would give a bucket of 2), and a result off the oracle is refused."""
    import threading

    import fenix_tpu_torch

    rows = smoke.GLOVE_BLOCK + 1_234
    for name, value in {
        "DEVICE": "cpu", "GLOVE_ROWS": rows, "WARM_REPS": 1,
        "GLOVE_SEARCHES": tuple((s[0], min(s[1], 100), *s[2:]) for s in smoke.GLOVE_SEARCHES),
    }.items():
        monkeypatch.setattr(smoke, name, value)
    padded = 2 * smoke.GLOVE_BLOCK
    assert smoke.glove_rows_scanned() == padded
    data = smoke.make_data(rows, 2, smoke.GLOVE_D)
    queries = [smoke.make_queries(data[0], s[1], seed=900 + i) for i, s in enumerate(smoke.GLOVE_SEARCHES)]
    seen = []
    real = kernels.bucket_scores

    def spy(q, v, aux_mul, aux_add, bucket, inv_sq=None, _kernel=None):
        seen.append((q.shape[0], v.shape, v.dtype, bucket))
        return real(q, v, aux_mul, aux_add, bucket, inv_sq=inv_sq, _kernel=_kernel)

    server = fenix_tpu_torch.Server(str(tmp_path), host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    client = fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port)
    try:
        monkeypatch.setattr(kernels, "bucket_scores", spy)
        glove = smoke.phase_glove_serve(client, expr, kernels, data, queries)
        monkeypatch.setattr(kernels, "bucket_scores", real)
    finally:
        client.close()
        server.shutdown()
    assert not any(glove["launches"].values())  # CPU tensors launch nothing
    assert {(qn, tuple(shape), dtype) for qn, shape, dtype, _ in seen} == {
        (s[1], (padded, smoke.GLOVE_D), {"int8": torch.int8, "bf16": torch.bfloat16}[s[4]])
        for s in smoke.GLOVE_SEARCHES}
    assert all(bucket == (128 if qn <= 64 else 32) for qn, _, _, bucket in seen)
    monkeypatch.setattr(smoke, "time_ms", lambda fn, reps: (fn(), 1.0)[1])
    got = smoke.phase_glove_checks(kernels, topk2, data, queries, glove)
    assert [r["search"] for r in got] == [s[0] for s in smoke.GLOVE_SEARCHES]
    assert all(r["n"] == padded and r["d"] == smoke.GLOVE_D for r in got)
    assert [r["kernel"] for r in got] == ["generic_int8", "generic_int8", "generic_bf16", "generic_bf16"]
    assert [r["bucket"] for r in got] == [128, 32, 128, 32]
    assert got[1]["library_ms"] is not None  # _int_mm on zero-padded copies of the 100-wide rows
    # a result with its first two winners swapped is off the oracle
    ids, dist = smoke.split_result(glove["results"][0], smoke.GLOVE_SEARCHES[0][1], 10)
    oracle = smoke.Oracle(data[0], "cpu")
    far = ids[:, 1] != ids[:, 2]
    ids[far, 1], ids[far, 2] = ids[far, 2], ids[far, 1].copy()
    with pytest.raises(AssertionError, match="ids differ|distance off"):
        smoke.check_ids(oracle, "swapped", "cosine", 10, "fp32", queries[0], ids, dist, None, True,
                        dist_tol=smoke.GLOVE_DIST_TOL)


def test_chip_smoke_mutation_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 10 (a) and (c) of chip_smoke.py rehearsed on the CPU at a small
    size, on the port's server (CPU device) after phase 7's index: append
    (the index extends, the matrix grows, the copies come back first),
    delete, upsert and compact, each search held to the float64 oracle
    over the script's live copy and its refresh counters; then the
    kernels against their plain versions over the grown and shrunk
    buffers."""
    import threading

    import fenix_tpu_torch

    vectors, ids, tags = smoke.make_data(SMOKE_ROWS, seed=0)
    root = str(tmp_path)
    t = pa.table({"id": pa.array(ids), "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
                  "tag": pa.array(tags)})
    table.make(root, "smoke/items", t.to_reader(max_chunksize=4096))
    for name, value in {
        "DEVICE": "cpu", "ROWS": SMOKE_ROWS, "IVF_CELLS": 64, "WARM_REPS": 1, "MUT_APPEND_ROWS": 1024,
        "MUT_UPSERT": 64,
        "IVF_CONFIG": {"metric": "l2", "codebook_size": 64, "num_codebooks": 1, "batch_size": 1024,
                       "num_epochs": 2},
        # 4 probes: every query's probe cells hold 10 rows with tag < 50 (the
        # Q=8 search may take either route here; the phase accepts either)
        "IVF_SEARCHES": (("ivf_q8_p64_filtered", 8, 4, True, "fp32", "scan", "l2"),),
        "SEARCHES": tuple((s[0], min(s[1], 100), *s[2:]) for s in smoke.SEARCHES),
        "time_ms": lambda fn, reps: (fn(), 1.0)[1],
    }.items():
        monkeypatch.setattr(smoke, name, value)
    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    client = fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port)
    try:
        queries = [smoke.make_queries(vectors, s[1], seed=10 + i) for i, s in enumerate(smoke.SEARCHES)]
        ivf = smoke.phase_ivf_serve(client, expr, vectors, root, "cpu", "cpu")
        # the matrix is resident before the mutations, as phase 8 leaves it
        client.search(queries[1], "smoke/items", "vector", metric="cosine", maxval=10)
        mut = smoke.phase_mutations_serve(client, expr, vectors, ids, tags, queries, ivf, 1.0, "cpu", "cpu")
        stats = client.stats()
    finally:
        client.close()
        server.shutdown()
    assert stats["cache.incremental_refreshes"] == 1 and stats["cache.lineage_refreshes"] == 3
    assert not any(mut["launches"].values())  # CPU tensors launch nothing
    final = table.load(root, "smoke/items")
    assert final.num_rows == SMOKE_ROWS + 1024 - int(mut["keep_after_append"].size - mut["keep_after_append"].sum()) + 64
    assert not (final.column("tag").to_numpy()[: SMOKE_ROWS] == 7).any()
    rows = smoke.mutation_kernel_checks(kernels, topk2, vectors, tags, queries, mut, "cpu", "cpu")
    assert [r["kernel"] for r in rows] == ["stream", "tiled"]
    assert rows[0]["n"] == rows[1]["n"] == 32768  # 17,408 rows grown, 17,2xx kept
    # the live copy maps ids to positions, a removed id to -1
    live = smoke.Live(vectors[:4], np.array([5, 9, 2, 7]), tags[:4])
    live.append(vectors[4:6], np.array([11, 12]), tags[4:6])
    live.keep(np.array([True, False, True, True, False, True]))
    assert live.pos(np.array([2, 9, 7, 11, 12])).tolist() == [1, -1, 2, -1, 3]
    np.testing.assert_array_equal(live.parts[0], vectors[[0, 2, 3, 5]])


def test_chip_smoke_ivf_host_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phases 9 and 10 (b) of chip_smoke.py rehearsed on the CPU at a small
    size, past a budget the fp32 form does not fit: make_index trains by
    streaming and assigns on the host, the probed searches and the probed
    read run on the host (the first call writes the IVF sidecar), every
    check after the server passes; then the append: the mirror quantizes
    the delta alone, the int8-resident copy grows, both copies come back
    first; and tensor_int8's plain version over the grown int8 copy."""
    import threading

    import fenix_tpu_torch

    vectors, ids, tags = smoke.make_data(SMOKE_ROWS, seed=1, dim=64)
    root = str(tmp_path)
    t = pa.table({"id": pa.array(ids), "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
                  "tag": pa.array(tags)})
    table.make(root, "smoke/wide", t.to_reader(max_chunksize=4096))
    # dual 4.5 MB; int8 1.3 MB, 2.6 MB after the append (a 32,768-row pad)
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(4 << 20))
    for name, value in {
        "DEVICE": "cpu", "WARM_REPS": 1, "IVFH_CELLS": 64, "IVF_SAMPLE_ROWS": 4096, "IVFH_STEP_ROWS": 2048,
        "MUT_APPEND_ROWS": 512,
        "IVFH_CONFIG": {"metric": "l2", "codebook_size": 64, "num_codebooks": 1, "batch_size": 1024,
                        "num_epochs": 2},
        "IVFH_SEARCHES": (("host_ivf_q1_p16", 1, 4, False), ("host_ivf_q8_p64_filtered", 8, 8, True)),
        "IVFH_READ": ("host_ivf_read_q8_l2_p16_tag_eq_7", 8, "l2", ("==", 7), 4),
        "time_ms": lambda fn, reps: (fn(), 1.0)[1],
    }.items():
        monkeypatch.setattr(smoke, name, value)
    pool = np.flatnonzero((tags[: smoke.DUP] < 50) & (tags[smoke.DUP : 2 * smoke.DUP] < 50))
    res_queries = {8: smoke.make_queries(vectors, 8, seed=108, src_pool=pool)}
    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    client = fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port)
    before = METRICS.snapshot().get("search.residency_probed_host", 0)
    try:
        ivfh = smoke.phase_ivf_host_serve(client, expr, vectors, tags, root, "cpu", "cpu")
        wide = smoke.phase_mutations_wide(client, expr, vectors, ids, tags, res_queries, ivfh, "cpu", "cpu")
        stats = client.stats()
    finally:
        client.close()
        server.shutdown()
    assert ivfh["codebooks"].shape == (1, 64, 64) and not any(wide["launches"].values())
    assert stats["search.residency_probed_host"] - before == 2 * (1 + smoke.RES_WARM_REPS) + 1
    out = smoke.phase_ivf_host_checks(smoke.Oracle(vectors, "cpu"), vectors, tags, ivfh, "cpu", "cpu")
    assert [c["recall"] for c in out["oracle"]] == [1.0, 1.0]
    assert out["read"]["rows"] > 0 and out["device_step"]["rows"] == 2048
    assert set(out["timings"]) == {"host_probed_score", "host_assign_block", "host_rescore_window"}
    rows = smoke.mutation_kernel_checks_wide(kernels, topk2, vectors, tags, res_queries, wide["append"],
                                             "cpu", "cpu")
    assert rows[0]["kernel"] == "tensor_int8" and rows[0]["n"] == 32768


def test_chip_smoke_analytics_and_batching_phases_on_the_cpu(tmp_path, monkeypatch):
    """Phases 11 and 12 of chip_smoke.py rehearsed on the CPU at a small
    size on the port's server (CPU device) after phase 7: the attribute
    tables over Flight, every join request on its route beside its plain
    search, every oracle check after the server; the micro-batching cases
    (a)-(d) equal to their solo answers and coalesced, and (e) through the
    host-corpus residency under a low budget; the result gather timing."""
    import threading

    import fenix_tpu_torch

    vectors, ids, tags = smoke.make_data(SMOKE_ROWS, seed=0)
    root = str(tmp_path)
    t = pa.table({"id": pa.array(ids), "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
                  "tag": pa.array(tags)})
    table.make(root, "smoke/items", t.to_reader(max_chunksize=4096))
    requests = tuple((r[0], min(r[1], 100), *r[2:6], r[6] and 2, *r[7:]) for r in smoke.AN_REQUESTS)
    for name, value in {
        "DEVICE": "cpu", "ROWS": SMOKE_ROWS, "IVF_CELLS": 64, "WARM_REPS": 1, "BATCH_ROWS": 4096,
        "IVF_CONFIG": {"metric": "l2", "codebook_size": 64, "num_codebooks": 1, "batch_size": 1024,
                       "num_epochs": 2},
        "IVF_SEARCHES": (("ivf_q8_p64_filtered", 8, 1, True, "fp32", "clustered", "l2"),),
        "AN_ATTRS_ROWS": 20_000, "AN_DUP_ROWS": 8192, "AN_BATCH_ROWS": 5000, "AN_REQUESTS": requests,
        "MB_THREADS": 8, "MB_Q1_REQUESTS": 48, "MB_BIG": (4, 3, 100, 16), "MB_PROBED": (4, 2, 2),
        "MB_RES": (4, 2, 8),
    }.items():
        monkeypatch.setattr(smoke, name, value)
    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    client = fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port)
    try:
        ivf = smoke.phase_ivf_serve(client, expr, vectors, root, "cpu", "cpu")
        an = smoke.phase_analytics_serve(client, expr, kernels, vectors, "cpu", "cpu")
        mb = smoke.phase_batching_serve(client, fenix_tpu_torch.Flight, server.port, expr, vectors, "cpu", "cpu")
        stats = client.stats()
        q1024 = client.search(smoke.make_queries(vectors, 100, seed=12), "smoke/items", "vector", metric="l2",
                              maxval=100, filter=expr.field("tag") < 50)
        monkeypatch.setenv("FENIX_HBM_BUDGET", str(4 << 20))  # (e): dual 8.4 MB does not fit, int8 does
        monkeypatch.setattr(smoke, "RES_D", smoke.D)
        monkeypatch.setattr(smoke, "RES_K", 10)
        wide = pa.table({"id": pa.array(ids), "vector": t.column("vector"), "tag": pa.array(tags)})
        client.make_table("smoke/wide", wide.to_reader(max_chunksize=4096))
        res = smoke.phase_batching_residency(client, fenix_tpu_torch.Flight, server.port, vectors, "cpu", "cpu")
    finally:
        client.close()
        server.shutdown()
    assert stats["join.fused"] >= 3 * 2 and stats["join.inner"] >= 2 * 2
    assert stats["cache.sorted_key_seconds"] > 0 and not any(an["launches"].values())
    assert {c: mb["cases"][c]["requests"] for c in "abcd"} == {"a": 48, "b": 48, "c": 12, "d": 8}
    assert mb["cases"]["c"]["queries_per_dispatch"] > 100
    assert res["case"]["search.residency_int8"] == res["case"]["batch.dispatches"] >= 1
    out = smoke.phase_analytics_checks(smoke.Oracle(vectors, "cpu"), tags, ivf, an)
    assert [r["search"] for r in out] == [r[0] for r in requests]
    assert out[2]["rows"] == 8 * 10 and out[5]["rows"] > 0
    assert smoke.gather_timing(vectors, q1024, "cpu", "cpu")["rows"] == 100 * 100
    # the group check refuses a wrong aggregate
    groups = np.array([3, 1, 3])
    good = pa.table({"__GROUP__": pa.array([1, 3]), "__AGG__": pa.array([1, 2])})
    assert smoke.check_groups("x", good, groups, np.ones(3, np.int64), "sum", True)["groups"] == 2
    with pytest.raises(AssertionError, match="group 3 sum"):
        bad = pa.table({"__GROUP__": pa.array([1, 3]), "__AGG__": pa.array([1, 3])})
        smoke.check_groups("x", bad, groups, np.ones(3, np.int64), "sum", True)
    solo = pa.table({"id": pa.array([1, 2]), "__DISTANCE__": pa.array([0.5, 0.7], pa.float32())})
    with pytest.raises(AssertionError, match="recall"):
        smoke.check_graded("x", pa.table({"id": pa.array([1, 9]), "__DISTANCE__": solo.column(1)}), solo)


def _rehearsal_server(root):
    import threading

    import fenix_tpu_torch

    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=server.serve, daemon=True).start()
    return server, fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port)


def _small_searches():
    """chip_smoke's SEARCHES with the Q=1024 search cut to Q=100."""
    return tuple((s[0], min(s[1], 100), *s[2:]) for s in smoke.SEARCHES)


@pytest.fixture
def port_only_types():
    """The extension names unregistered, as in a port-only process (the
    server, chip_smoke.py); the JAX package's classes come back after."""
    from fenix_tpu import types as jtypes

    for name in ("fenix_tpu.tensor", "fenix_tpu.nested", "fenix_tpu.quint8"):
        try:
            pa.unregister_extension_type(name)
        except KeyError:
            pass
    yield
    jtypes.register_all()


def test_chip_smoke_typed_phase_on_the_cpu(tmp_path, monkeypatch, port_only_types):
    """Phase 13 of chip_smoke.py rehearsed on the CPU at 16,384 rows on the
    port's server (CPU device), no extension type registered as in the
    card run: items_q8 and items_t over Flight, phase 3's searches on the
    quint8 column, the read, the IVF index and its probed search, the
    append found, items_t bit-equal to items; then every oracle check and
    the dequantization (CPU twin of the card's) against numpy, bit for
    bit."""
    for name, value in {
        "DEVICE": "cpu", "ROWS": SMOKE_ROWS, "BATCH_ROWS": 4096, "SEARCHES": _small_searches(), "TY_CELLS": 64,
        "TY_CONFIG": {"metric": "l2", "codebook_size": 64, "num_codebooks": 1, "batch_size": 1024, "num_epochs": 2},
        "TY_WARM_REPS": 1, "TY_APPEND_ROWS": 2048,
    }.items():
        monkeypatch.setattr(smoke, name, value)
    vectors, ids, tags = smoke.make_data(SMOKE_ROWS, seed=0)
    queries = [smoke.make_queries(vectors, s[1], seed=10 + i) for i, s in enumerate(smoke.SEARCHES)]
    root = str(tmp_path)
    table.make(root, "smoke/items", pa.table({
        "id": pa.array(ids), "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
        "tag": pa.array(tags)}).to_reader(max_chunksize=4096))
    server, client = _rehearsal_server(root)
    try:
        before = client.stats()  # the counters are the process's
        ty = smoke.phase_typed_serve(client, expr, kernels, vectors, ids, tags, queries, root, "cpu", "cpu")
        stats = smoke.stats_delta(before, client.stats(), ("cache.incremental_refreshes", "search.nomax_selected"))
    finally:
        client.close()
        server.shutdown()
    assert stats == {"cache.incremental_refreshes": 1, "search.nomax_selected": 1 + smoke.SEL_READ_REPS}
    assert not any(ty["launches"].values())  # CPU tensors take the plain versions
    out = smoke.phase_typed_checks(ty, queries, tags, "cpu", "cpu")
    assert [r["search"] for r in out][:5] == ["q8_" + s[0] for s in smoke.SEARCHES]
    assert out[5]["rows"] == 8 * int((tags == 7).sum())
    # the oracle refuses the answer of an engine that searched the raw codes
    spec = smoke.SEARCHES[1]
    table.make(root, "raw", pa.table({"id": pa.array(ids), "vector": ingest.numpy_to_fixed_size_list(
        ty["codes"].astype(np.float32), pa.float32())}).to_reader())
    wrong = executor.execute_search(DeviceCache(root, device="cpu"), executor.SearchRequest(
        "raw", "vector", queries[1], metric=spec[2], maxval=spec[3]))
    oracle = smoke.Oracle(ty["deq"], "cpu")
    with pytest.raises(AssertionError):
        smoke.check_search(oracle, spec, queries[1], wrong, None)


def test_chip_smoke_tracing_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 14 of chip_smoke.py rehearsed on the CPU at 16,384 rows: a
    server with FENIX_TRACE_DIR and FENIX_QUERY_LOG over a root holding
    items, phase 7's coder and the attrs table; the catalog calls; each
    request kind warmed up and traced, its trace parsed (no card: no
    kernel events required); the log replayed, every search matched."""
    for name, value in {
        "DEVICE": "cpu", "ROWS": SMOKE_ROWS, "SEARCHES": _small_searches(), "IVF_CELLS": 64, "BATCH_ROWS": 4096,
        "IVF_CONFIG": {"metric": "l2", "codebook_size": 64, "num_codebooks": 1, "batch_size": 1024,
                       "num_epochs": 2},
        "IVF_SEARCHES": tuple((s[0], min(s[1], 100), *s[2:]) for s in smoke.IVF_SEARCHES),
        "AN_ATTRS_ROWS": 20_000, "AN_BATCH_ROWS": 5000,
    }.items():
        monkeypatch.setattr(smoke, name, value)
    vectors, ids, tags = smoke.make_data(SMOKE_ROWS, seed=0)
    queries = [smoke.make_queries(vectors, s[1], seed=10 + i) for i, s in enumerate(smoke.SEARCHES)]
    root = str(tmp_path / "root")
    table.make(root, "smoke/items", pa.table({
        "id": pa.array(ids), "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
        "tag": pa.array(tags)}).to_reader(max_chunksize=4096))
    trace_dir, log = str(tmp_path / "traces"), str(tmp_path / "queries.jsonl")
    server, client = _rehearsal_server(root)
    try:
        client.make_index(smoke.IVF_CODER, "smoke/items", "vector", smoke.IVF_CONFIG)
        smoke.put_columns(client, "attrs", smoke.analytics_tables()[0])
        monkeypatch.setenv("FENIX_TRACE_DIR", trace_dir)
        monkeypatch.setenv("FENIX_QUERY_LOG", log)
        rows = smoke.phase_tracing_serve(client, expr, vectors, queries, trace_dir, "cpu", "cpu")
    finally:
        client.close()
        server.shutdown()
    assert list(rows) == [r[0] for r in smoke.tracing_requests(expr, vectors, queries)]
    for name, row in rows.items():
        assert row["wall_ms"] > 0 and row["idle_share"] == 1.0, (name, row)
        assert {"fenix.snapshot", "fenix.result_gather"} <= set(row["spans_ms"]) or name.startswith("config3"), row
    assert "fenix.rank_cells" in rows["ivf_q1024_p64"]["spans_ms"]
    out = smoke.phase_tracing_after(root, log, "cpu", "cpu")
    assert out["replay"] == {"total": 10, "matched": 10, "mismatched": 0}
    # a trace of a card run without kernel events is refused
    monkeypatch.setattr(smoke, "DEVICE", "cuda")
    with pytest.raises(AssertionError, match="no CUDA kernel events"):
        smoke.trace_summary(os.path.join(trace_dir, sorted(os.listdir(trace_dir))[-1]))


def test_chip_smoke_mesh_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 15 of chip_smoke.py rehearsed on the CPU at 16,384 rows over 4
    ``cpu`` shards: (a) a root of phase 3's rows, its coder trained by
    ``train_sharded`` on the mesh, phase 3's searches (the Q=1024 one on
    the ring and on the all-gather route), the read, two IVF searches and
    32 batched requests, each equal to the single device's answer and
    held to the float64 oracle, the shard-shape kernel rows, the merge,
    the CPU-held ``train_sharded`` and the append and delete refreshes;
    (d) phase 11's joins on both attribute routes, each equal to the
    single device's and held to phase 11's oracles; (b) the mesh-composed
    residency modes under a per-device budget."""
    vectors, ids, tags = smoke.make_data(SMOKE_ROWS, seed=0)
    for name, value in {
        "DEVICE": "cpu", "ROWS": SMOKE_ROWS, "IVF_CELLS": 64, "MESH_WARM_REPS": 1, "MUT_APPEND_ROWS": 1024,
        "IVF_CONFIG": {"metric": "l2", "codebook_size": 64, "num_codebooks": 1, "batch_size": 1024,
                       "num_epochs": 2},
        "MESH_IVF": (("ivf_q8_p64_filtered", 8, 4, True, "clustered"), ("ivf_q1024_p64", 520, 4, False, "scan")),
        "MESH_TRAIN_CHECK": {"rows": 4096, "config": {"metric": "l2", "codebook_size": 16, "num_codebooks": 1,
                                                      "batch_size": 512, "num_epochs": 1}},
        "time_ms": lambda fn, reps: (fn(), 1.0)[1],
        # Q=520 still pads to the ring's 1,024 (ring blocks of 130), at k=16
        "SEARCHES": tuple((s[0], 520, s[2], 16, *s[4:]) if s[1] == 1024 else s for s in smoke.SEARCHES),
        # (d): phase 11's requests at Q <= 100 and 2 probes over small attribute tables
        "AN_ATTRS_ROWS": 20_000, "AN_DUP_ROWS": 8192, "AN_BATCH_ROWS": 5000,
        "AN_REQUESTS": tuple((r[0], min(r[1], 100), *r[2:6], r[6] and 2, *r[7:]) for r in smoke.AN_REQUESTS),
    }.items():
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setenv("FENIX_PART_ATTRS_MIN", "8192")  # both attribute tables take the partitioned route
    queries = [smoke.make_queries(vectors, s[1], seed=10 + i) for i, s in enumerate(smoke.SEARCHES)]
    latencies = {s[0]: [1.0] for s in smoke.SEARCHES}
    kernels.LAUNCHES["bucket_scores.f32"] += 1  # phase 15 zeroes every count before its path
    mesh = smoke.phase_mesh(kernels, topk2, expr, vectors, ids, tags, queries, latencies, "cpu", "cpu")
    assert mesh["mesh"] == {"cards": 0, "shards": 4} and mesh["served"] is None
    assert not any(mesh["launches"].values())  # CPU tensors launch nothing
    assert not any(mesh["analytics_launches"].values())
    assert mesh["mutations"]["append"]["refreshes"] == (1, 0)
    assert mesh["mutations"]["delete_tag_eq_9"]["refreshes"] == (0, 1)
    appended_tags = smoke.appended_rows(1024, 128, SMOKE_ROWS, (queries[1][0],), seed=650)[2]
    assert mesh["mutations"]["rows"] == SMOKE_ROWS + 1024 - int((tags == 9).sum() + (appended_tags == 9).sum())
    shapes = {(r["route"], r["q"], r["n"]) for r in mesh["checks"]}
    assert ("f32", 130, 16384) in shapes and ("f32", 520, 16384) in shapes  # a ring block, the all-gather batch
    assert not os.path.exists(os.path.join(smoke.HERE, "build", "chip_smoke", f"mesh-{os.getpid()}"))

    wide, wide_ids, wide_tags = smoke.make_data(SMOKE_ROWS, seed=1, dim=64)
    root = str(tmp_path / "wide")
    table.make(root, "smoke/wide", pa.table({
        "id": pa.array(wide_ids), "vector": ingest.numpy_to_fixed_size_list(wide, pa.float32()),
        "tag": pa.array(wide_tags)}).to_reader(max_chunksize=4096))
    monkeypatch.setattr(smoke, "MESH_BUDGET", 2 << 20)  # a shard's fp32 slice past it, its int8 slice inside
    res_queries = {q: smoke.make_queries(wide, q, seed=100 + q) for q in (8, 1024)}
    out = smoke.phase_mesh_residency(root, smoke.Live(wide, wide_ids, wide_tags), res_queries, "cpu", "cpu")
    planned = {r["search"]: r["planned"] for r in out["rows"] if r["cache"] == "mesh"}
    assert planned["mesh_auto_q8"] == "int8" and planned["mesh_dual_q8"] == "dual"
    assert "FENIX_HBM_BUDGET" not in os.environ


def test_chip_smoke_multihost_phase_on_the_cpu(monkeypatch):
    """Phase 17 of chip_smoke.py rehearsed on the CPU: two worker processes
    of the script (``--multihost-worker``, gloo, two ``cpu`` shards each)
    run the seven legs over 16,384 rows, bitwise equal to one process's
    four shards, the id shuffle overflowing and retrying in step, every
    search leg held to the float64 oracle."""
    vectors, _, tags = smoke.make_data(SMOKE_ROWS, seed=0)
    for name, value in {
        "DEVICE": "cpu", "MH_REPS": 1, "AN_ATTRS_ROWS": 40_000, "AN_DUP_ROWS": 1024,
        "SH_PAYLOAD_ROWS": 2048, "SH_PAYLOAD_D": 24,
        "MESH_TRAIN_CHECK": {"rows": 8192, "config": {"metric": "l2", "codebook_size": 64, "num_codebooks": 1,
                                                      "batch_size": 1024, "num_epochs": 1}},
        "SEARCHES": tuple((s[0], 520, s[2], 16, *s[4:]) if s[1] == 1024 else s for s in smoke.SEARCHES),
        "AN_REQUESTS": tuple((r[0], 64, *r[2:]) if r[1] == 1024 else r for r in smoke.AN_REQUESTS),
    }.items():
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the workers' torch threads
    queries = [smoke.make_queries(vectors, s[1], seed=10 + i) for i, s in enumerate(smoke.SEARCHES)]
    emitted = []
    monkeypatch.setattr(smoke, "emit", emitted.append)
    out = smoke.phase_multihost("cpu", "cpu", vectors, tags, queries)
    assert out["backend"] == "gloo" and not any(out["launches"].values())  # CPU tensors launch nothing
    head = next(r for r in emitted if r["phase"] == "multihost")
    assert [w["local_shards"] for w in head["workers"]] == [[0, 1], [2, 3]]
    assert head["arrays_equal"] > 40
    legs = {r["leg"] for r in emitted if r["phase"] == "multihost_leg"}
    assert {"b_ring", "c_train_sharded", "d_payload_chunks4", "d_hot_ids", "f_stream", "g_dim_dot"} <= legs
    assert sum(r["phase"] == "multihost_oracle" for r in emitted) == 5 + 1 + 1 + 3


def test_chip_smoke_shuffle_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 16 of chip_smoke.py rehearsed on the CPU over 4 ``cpu`` shards:
    (d) the dim-sharded search on a (2, 2) mesh held to the float64 oracle
    and the row-sharded search, the sharded Lloyd step against one
    device; (a) the id shuffle, uniform through at the estimated capacity
    and skewed through on the retry at the bound; (b) the payload shuffle,
    chunks 1 and 4 bitwise equal; (c) repartition of a mutated 16,384-row
    root on the mesh (the device route), the shard tables the host
    placement, phase 15's searches and read equal to theirs before it."""
    from fenix_tpu_torch import index as index_mod
    from fenix_tpu_torch.parallel import distributed as pdistributed

    vectors, ids, tags = smoke.make_data(SMOKE_ROWS, seed=0)
    for name, value in {
        "DEVICE": "cpu", "ROWS": SMOKE_ROWS, "MESH_WARM_REPS": 1, "IVF_CELLS": 64, "IVF_STEP_ROWS": 2048,
        "SH_KEYS": 100_003, "SH_PAYLOAD_ROWS": 2048, "SH_PAYLOAD_D": 24, "SH_REPS": 1,
        "SEARCHES": tuple((s[0], 520, s[2], 16, *s[4:]) if s[1] == 1024 else s for s in smoke.SEARCHES),
    }.items():
        monkeypatch.setattr(smoke, name, value)
    root = str(tmp_path / "root")
    table.make(root, "smoke/items", pa.table({
        "id": pa.array(ids), "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
        "tag": pa.array(tags)}).to_reader(max_chunksize=4096))
    live = smoke.Live(vectors, ids, tags)
    new = smoke.appended_rows(512, 128, SMOKE_ROWS, (vectors[5],), seed=650)
    table.append(root, "smoke/items", smoke.to_reader(*new).read_all())
    live.append(*new)
    index_mod.delete_rows(root, "smoke/items", expr.field("tag") == 9)
    live.keep(live.tags != 9)

    queries = [smoke.make_queries(vectors, s[1], seed=10 + i) for i, s in enumerate(smoke.SEARCHES)]
    reqs = smoke.mesh_requests(expr, vectors, queries)
    mesh, shape = smoke.mesh_for_run()
    device_calls = []
    inner = pdistributed._device_shuffle_ids
    monkeypatch.setattr(pdistributed, "_device_shuffle_ids",
                        lambda *a: device_calls.append(a[2]) or inner(*a))
    out = smoke.phase_shuffle(mesh, shape, root, live, reqs, vectors, smoke.Oracle(vectors, "cpu"), "cpu", "cpu")
    assert device_calls == [4, 4, 4]  # (a) uniform, (a) skewed, (c)
    assert not any(out["launches"].values())  # CPU tensors launch nothing
    assert [t["overflow"] for t in out["ids"]["uniform"]["tries"]] == [False]
    assert [t["overflow"] for t in out["ids"]["skewed"]["tries"]] == [True, False]
    assert out["ids"]["uniform"]["tries"][0]["chunks"] == 4  # 25,001 rows a shard: double-buffered
    assert out["payload"]["capacity"] == 1024 and out["payload"]["payload_bytes"] == 4 * 2048 * (24 * 4 + 4)
    assert sum(out["repartition"]["shard_rows"]) == live.ids.shape[0]
    assert [r["search"] for r in out["dim"]["searches"]] == [f"dim_sharded_{m}" for m in smoke.DIM_METRICS]
    assert [r["books"] for r in out["dim"]["lloyd"]] == [1, 2]
    assert pdistributed.resolve_source(root, "smoke/items") == [f"smoke/items@{s}" for s in range(4)]
