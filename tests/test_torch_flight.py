"""fenix_tpu_torch's Flight server against the JAX package's, on the CPU.

Both servers run in threads on port 0 (as tests/test_flight.py runs the
JAX one) over one storage root. The port's server is driven by the
unchanged ``fenix_tpu.Flight`` client and by its own client; a table
written through either server reads and searches identically through
the other. Result tables compare column by column: ids and gathered
columns exactly, ``__DISTANCE__`` within rtol/atol 1e-5.
"""

import os
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

import fenix_tpu
import fenix_tpu_torch
from fenix_tpu import expr as jexpr
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu_torch import expr
from fenix_tpu_torch.io import ingest

torch.set_num_threads(2)

DIM = 32
NUM_ROWS = 6_000
BATCH = 1_000


def batches(seed: int, rows: int = NUM_ROWS):
    rng = np.random.default_rng(seed)
    for start in range(0, rows, BATCH):
        x = rng.standard_normal((BATCH, DIM)).astype(np.float32)
        if start == BATCH:
            x[:50] = first[:50]  # exact duplicates of rows 0..49
        if start == 0:
            first = x.copy()
        yield pa.record_batch(
            [
                pa.array(np.arange(start, start + BATCH, dtype=np.int64)),
                ingest.numpy_to_fixed_size_list(x, pa.float32()),
                pa.array(rng.integers(0, 5, BATCH).astype(np.int32)),
            ],
            names=["id", "vector", "tag"],
        )


def reader(seed: int, rows: int = NUM_ROWS) -> pa.RecordBatchReader:
    first = next(batches(seed, rows))
    return pa.RecordBatchReader.from_batches(first.schema, batches(seed, rows))


def _serve(server):
    thread = threading.Thread(target=server.serve, daemon=True)
    thread.start()
    return server


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("shared"))


@pytest.fixture(scope="module")
def servers(root):
    # single-device JAX cache (the tests' 8 virtual CPU devices would
    # otherwise shard it over a mesh)
    jexecutor._CACHES[os.path.abspath(root)] = JaxCache(os.path.abspath(root), mesh=None)
    port = _serve(fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device="cpu"))
    jax = _serve(fenix_tpu.Server(root, host="127.0.0.1", port=0))
    yield port, jax
    port.shutdown()
    jax.shutdown()
    jexecutor._CACHES.pop(os.path.abspath(root), None)


@pytest.fixture(scope="module")
def clients(servers):
    port, jax = servers
    return {
        "jax_client_on_port": fenix_tpu.Flight(host="127.0.0.1", port=port.port),
        "port_client_on_port": fenix_tpu_torch.Flight(host="127.0.0.1", port=port.port),
        "jax_client_on_jax": fenix_tpu.Flight(host="127.0.0.1", port=jax.port),
    }


@pytest.fixture(scope="module")
def loaded(clients):
    clients["port_client_on_port"].make_table("items", reader(0))
    return clients


def assert_tables_match(got: pa.Table, want: pa.Table) -> None:
    assert got.schema == want.schema
    for name in want.column_names:
        if name == "__DISTANCE__":
            np.testing.assert_allclose(
                got.column(name).to_numpy(), want.column(name).to_numpy(), rtol=1e-5, atol=1e-5
            )
        else:
            assert got.column(name).equals(want.column(name)), name


def test_health_and_catalog(loaded):
    for name in ("jax_client_on_port", "port_client_on_port"):
        c = loaded[name]
        assert c.health() == {"status": "ok"}
        assert c.list_tables() == ["items"]
    # written through the port's server, read through the JAX server
    want = pa.Table.from_batches([*batches(0)])
    assert loaded["jax_client_on_jax"].read_table("items").read_all().equals(want)
    assert loaded["jax_client_on_port"].read_table("items").read_all().equals(want)
    got = loaded["port_client_on_port"].read_table(
        "items", select=["id"], filter=expr.field("tag") == 2, order_by=[("id", "descending")]
    ).read_all()
    ids = got.column("id").to_numpy()
    assert (np.diff(ids) < 0).all() and len(ids) == (want.column("tag").to_numpy() == 2).sum()


SEARCHES = [
    dict(metric="cosine", maxval=10, q=1),
    dict(metric="l2", maxval=7, q=9),
    dict(metric="dot", maxval=5, q=4, precision="bf16"),
    dict(metric="euclidean", maxval=6, q=3, precision="int8"),
    dict(metric="inner_product", maxval=8, q=5, filter=True, select=["id", "tag"]),
]


@pytest.mark.parametrize("case", SEARCHES, ids=lambda c: f"{c['metric']}-q{c['q']}")
def test_search_matches_jax_server(loaded, case):
    case = dict(case)
    q = case.pop("q")
    filtered = case.pop("filter", False)
    rng = np.random.default_rng(q)
    target = rng.standard_normal((q, DIM)).astype(np.float32)
    target = target[0] if q == 1 else target  # one flat query
    jkw, pkw = dict(case), dict(case)
    if filtered:
        jkw["filter"] = jexpr.field("tag") >= 3
        pkw["filter"] = expr.field("tag") >= 3
    want = loaded["jax_client_on_jax"].search(target, "items", "vector", **jkw)
    via_jax_client = loaded["jax_client_on_port"].search(target, "items", "vector", **jkw)
    via_port_client = loaded["port_client_on_port"].search(target, "items", "vector", **pkw)
    assert want.num_rows == q * case["maxval"]
    assert_tables_match(via_jax_client, want)
    assert_tables_match(via_port_client, want)


def test_duplicate_rows_tie_to_smallest_id(loaded):
    row = pa.Table.from_batches([*batches(0)]).column("vector")[7].values.to_numpy()
    got = loaded["port_client_on_port"].search(row, "items", "vector", metric="l2", maxval=2)
    assert got.column("id").to_pylist() == [7, 1007]


def test_stats_report_searches_and_kernel_counts(loaded):
    stats = loaded["port_client_on_port"].stats()
    assert stats["search.count"] >= 1
    assert stats["cache.device_bytes"] > 0
    # CPU tensors take the kernel's plain version: no launch is counted
    assert stats["kernel.bucket_scores.f32.launches"] == 0


def test_unported_verbs_raise(loaded):
    """Appends and row deletes are served now (on a table of their own,
    ``items`` stays as the other tests read it); maxval=None is answered;
    an unknown action is refused."""
    c = loaded["jax_client_on_port"]
    c.make_table("verbs", reader(4, rows=BATCH))
    c.append_table("verbs", reader(1, rows=BATCH))
    assert c.read_table("verbs").read_all().num_rows == 2 * BATCH
    assert c.delete_rows("verbs", jexpr.field("id") < 3) == 6  # both batches start at id 0
    c.compact_table("verbs")
    assert c.read_table("verbs").read_all().num_rows == 2 * BATCH - 6
    c.drop_table("verbs")
    # maxval=None, the client's default, is answered: every row that
    # passes the filter, in table order, as the JAX server answers it
    target = np.random.default_rng(3).standard_normal(DIM).astype(np.float32)
    kw = dict(metric="l2", filter=jexpr.field("tag") == 2, select=["id", "tag"])
    got = c.search(target, "items", "vector", **kw)
    want = loaded["jax_client_on_jax"].search(target, "items", "vector", **kw)
    assert got.num_rows == (pa.Table.from_batches([*batches(0)]).column("tag").to_numpy() == 2).sum()
    assert got.column("id").equals(want.column("id")) and got.schema == want.schema
    with pytest.raises(pa.ArrowInvalid, match="unknown action"):
        c._action("no-such-verb", {})


def test_overwrite_drops_indexes_built_by_jax_server(loaded):
    """An index the JAX server built goes away when the port's server
    overwrites its table, and the JAX server then reads the new rows."""
    jc = loaded["jax_client_on_jax"]
    jc.make_table("indexed", reader(2, rows=2 * BATCH))
    jc.make_index("ivf", "indexed", "vector", {"metric": "l2", "codebook_size": 4,
                                               "num_codebooks": 1, "batch_size": 256,
                                               "num_epochs": 1})
    assert loaded["port_client_on_port"].list_indexes() == ["indexed/vector/ivf"]
    loaded["port_client_on_port"].make_table("indexed", reader(3, rows=BATCH))
    assert jc.list_indexes() == [] and loaded["port_client_on_port"].list_indexes() == []
    assert jc.read_table("indexed").read_all().num_rows == BATCH


def test_table_written_by_jax_server_serves_through_port(loaded):
    jc, pc = loaded["jax_client_on_jax"], loaded["port_client_on_port"]
    jc.make_table("from_jax", reader(4, rows=3 * BATCH))
    target = np.random.default_rng(5).standard_normal((6, DIM)).astype(np.float32)
    want = jc.search(target, "from_jax", "vector", metric="cosine", maxval=9)
    assert_tables_match(pc.search(target, "from_jax", "vector", metric="cosine", maxval=9), want)
    # an overwrite through the JAX server is a new revision for the port
    jc.make_table("from_jax", reader(6, rows=2 * BATCH))
    want = jc.search(target, "from_jax", "vector", metric="cosine", maxval=9)
    assert_tables_match(pc.search(target, "from_jax", "vector", metric="cosine", maxval=9), want)
    pc.drop_table("from_jax")
    assert "from_jax" not in jc.list_tables()


IVF_CONFIG = {"metric": "cosine", "codebook_size": 8, "num_codebooks": 1, "batch_size": 256,
              "num_epochs": 2}


@pytest.mark.parametrize("q,probes", [(1, 2), (40, 3)], ids=["clustered", "scan"])
def test_ivf_lifecycle_through_both_clients(loaded, q, probes):
    """The unchanged JAX client drives the port's IVF verbs end to end:
    make_index trains and assigns on the port's server, list_coders and a
    coded read see it, probed searches (on the route the port counts)
    answer as the JAX server does over the same files, and drop_index
    removes coder and index. Each case names its coder anew: the JAX
    server memoizes cell ids on the table's revision alone, so an index
    rebuilt by another server under the same name stays stale there
    (ROADMAP queue 3)."""
    jc, pc, jj = loaded["jax_client_on_port"], loaded["port_client_on_port"], loaded["jax_client_on_jax"]
    name = f"ivf{q}"
    jc.make_index(name, "items", "vector", IVF_CONFIG)
    try:
        assert name in jc.list_coders() and pc.list_coders() == jc.list_coders()
        assert f"items/vector/{name}" in pc.list_indexes()
        coded = jc.read_table("items", coding=name, column="vector",
                              select=["id", "__CODED_ID__"]).read_all()
        assert coded.equals(jj.read_table("items", coding=name, column="vector",
                                          select=["id", "__CODED_ID__"]).read_all())
        assert coded.equals(pc.read_table("items", coding=name, column="vector",
                                          select=["id", "__CODED_ID__"]).read_all())
        codes = coded.column("__CODED_ID__").to_numpy()
        assert codes.min() >= 0 and codes.max() < 8
        target = np.random.default_rng(q).standard_normal((q, DIM)).astype(np.float32)
        target = target[0] if q == 1 else target
        kw = dict(coding=name, probes=probes, maxval=5)
        before = pc.stats()
        want = jj.search(target, "items", "vector", metric="cosine", **kw)
        assert_tables_match(jc.search(target, "items", "vector", metric="cosine", **kw), want)
        # the port's client may leave the metric to the coder
        assert_tables_match(pc.search(target, "items", "vector", **kw), want)
        after = pc.stats()
        route = "search.ivf_clustered" if q == 1 else "search.ivf_scan"
        assert after[route] - before[route] == 2
        assert set(want.column("__CODED_ID__").to_numpy()) <= set(codes)
    finally:
        jc.drop_index(name)
    assert name not in pc.list_coders() and f"items/vector/{name}" not in pc.list_indexes()
    with pytest.raises(pa.ArrowException):
        jc.search(np.zeros(DIM, np.float32), "items", "vector", metric="cosine", maxval=5,
                  coding=name, probes=2)


def test_repartitioned_names_resolve_on_every_verb(loaded, root):
    """A table the JAX package repartitioned: the port's server resolves
    its name to the shard tables for searches, reads and make-index as
    the JAX server does, refuses an append on it, and drop-table removes
    the shards and the manifest."""
    from fenix_tpu.parallel import distributed as jdistributed

    jc, pc, jj = loaded["jax_client_on_port"], loaded["port_client_on_port"], loaded["jax_client_on_jax"]
    pc.make_table("sharded", reader(7, rows=3 * BATCH))
    jdistributed.repartition(root, "sharded", 3)
    tables = pc.list_tables()
    assert "sharded" not in tables and {f"sharded@{s}" for s in range(3)} <= set(tables)
    target = np.random.default_rng(8).standard_normal((4, DIM)).astype(np.float32)
    for kw in (dict(metric="l2", maxval=7), dict(metric="cosine", filter=True, select=["id", "tag"])):
        jkw, pkw = dict(kw), dict(kw)
        if kw.pop("filter", None):
            jkw["filter"], pkw["filter"] = jexpr.field("tag") == 1, expr.field("tag") == 1
        want = jj.search(target, "sharded", "vector", **jkw)
        assert_tables_match(jc.search(target, "sharded", "vector", **jkw), want)
        assert_tables_match(pc.search(target, "sharded", "vector", **pkw), want)
    assert pc.read_table("sharded").read_all().equals(jj.read_table("sharded").read_all())
    jc.make_index("shardivf", "sharded", "vector", IVF_CONFIG)
    assert {f"sharded@{s}/vector/shardivf" for s in range(3)} <= set(pc.list_indexes())
    kw = dict(metric="cosine", maxval=5, coding="shardivf", probes=3)
    assert_tables_match(jc.search(target, "sharded", "vector", **kw),
                        jj.search(target, "sharded", "vector", **kw))
    with pytest.raises(pa.ArrowInvalid, match="repartitioned"):
        jc.append_table("sharded", reader(1, rows=BATCH))
    jc.drop_table("sharded")
    assert not any(t.startswith("sharded") for t in jj.list_tables())
    assert jdistributed.load_manifest(root, "sharded") is None
    jc.drop_index("shardivf")


def test_port_repartition_places_rows_as_the_jax_package(loaded, root):
    """The port's repartition action shards a table as the JAX package's
    host path does, and an overwrite of the name replaces its shards."""
    from fenix_tpu.parallel import distributed as jdistributed

    pc, jj = loaded["port_client_on_port"], loaded["jax_client_on_jax"]
    for name in ("by_port", "by_jax"):
        pc.make_table(name, reader(9, rows=2 * BATCH))
    assert pc.repartition("by_port", num_shards=2, key="id") == {"table": "by_port", "num_shards": 2}
    jdistributed.repartition(root, "by_jax", 2)
    for s in range(2):
        assert jj.read_table(f"by_port@{s}").read_all().equals(jj.read_table(f"by_jax@{s}").read_all())
    pc.make_table("by_port", reader(9, rows=BATCH))
    assert not any(t.startswith("by_port@") for t in pc.list_tables())
    assert pc.read_table("by_port").read_all().num_rows == BATCH
    for name in ("by_port", "by_jax"):
        pc.drop_table(name)
    assert not any(t.startswith("by_") for t in jj.list_tables())


def test_fault_inject_needs_its_environment_gate(loaded, monkeypatch):
    c = loaded["port_client_on_port"]
    monkeypatch.delenv("FENIX_ENABLE_FAULT_INJECTION", raising=False)
    with pytest.raises(pa.ArrowException, match="fault injection disabled"):
        c._action("fault-inject", {"spec": "search:1"})
    monkeypatch.setenv("FENIX_ENABLE_FAULT_INJECTION", "1")
    target = np.zeros(DIM, np.float32)
    try:
        c._action("fault-inject", {"spec": "search:1"})
        with pytest.raises(pa.ArrowException, match="injected fault"):
            c.search(target, "items", "vector", metric="l2", maxval=3)
        assert c.search(target, "items", "vector", metric="l2", maxval=3).num_rows == 3
        c._action("fault-inject", {"spec": "search:1"})  # a retrying client rides over it
        retrying = fenix_tpu_torch.Flight(host="127.0.0.1", port=c.port, retries=2)
        assert retrying.search(target, "items", "vector", metric="l2", maxval=3).num_rows == 3
        retrying.close()
    finally:
        c._action("fault-inject", {"spec": ""})


def test_catalog_discovery_matches_the_jax_server(loaded):
    """list_flights and get_flight_info: both servers on one root list the
    same tables, each with the same schema, descriptor, endpoint ticket
    and row count (the twin of tests/test_flight.py::test_list_flights_and_info)."""
    import pyarrow.flight as fl

    got, want = loaded["port_client_on_port"].conn, loaded["jax_client_on_jax"].conn
    names = sorted(i.descriptor.path[0].decode() for i in got.list_flights())
    assert names == sorted(i.descriptor.path[0].decode() for i in want.list_flights())
    assert "items" in names
    for name in names:
        g, w = (c.get_flight_info(fl.FlightDescriptor.for_path(name)) for c in (got, want))
        assert g.schema == w.schema and g.total_records == w.total_records
        assert g.descriptor.path == w.descriptor.path == [name.encode()]
        assert [e.ticket for e in g.endpoints] == [e.ticket for e in w.endpoints]
    info = got.get_flight_info(fl.FlightDescriptor.for_path("items"))
    source = loaded["port_client_on_port"].read_table("items").read_all()
    assert info.total_records == source.num_rows and info.schema == source.schema


JOINS = [
    ("lookup", dict(metric="l2", maxval=6, join={"source": "attrs", "right_on": "key"})),
    ("sum-weight", dict(metric="cosine", maxval=40, join={"source": "attrs", "right_on": "key"},
                        aggregate={"group_by": "grp", "value": "weight", "agg": "sum", "max_groups": 16})),
    ("inner-count", dict(metric="l2", maxval=30, join={"source": "attrs", "right_on": "key", "how": "inner"},
                         aggregate={"group_by": "grp", "agg": "count", "max_groups": 16})),
    ("int8-mean-distance", dict(metric="l2", maxval=20, precision="int8",
                                join={"source": "attrs", "right_on": "key", "columns": ["grp"]},
                                aggregate={"group_by": "grp", "value": "__DISTANCE__", "agg": "mean"})),
]


@pytest.fixture(scope="module")
def with_attrs(loaded):
    """An attribute table with duplicate keys over a third of the ids."""
    keys = np.repeat(np.arange(0, NUM_ROWS, 3, dtype=np.int64), 2)[: NUM_ROWS // 2]
    attrs = pa.table({"key": pa.array(keys), "grp": pa.array(keys % 7),
                      "weight": pa.array(keys.astype(np.float64) * 0.25)})
    loaded["port_client_on_port"].make_table("attrs", attrs.to_reader())
    return loaded


@pytest.mark.parametrize("case", JOINS, ids=[c[0] for c in JOINS])
def test_join_and_aggregate_through_both_clients(with_attrs, case):
    kw = case[1]
    target = np.random.default_rng(len(case[0])).standard_normal((3, DIM)).astype(np.float32)
    want = with_attrs["jax_client_on_jax"].search(target, "items", "vector", **kw)
    assert want.num_rows > 0
    for name in ("jax_client_on_port", "port_client_on_port"):
        got = with_attrs[name].search(target, "items", "vector", **kw)
        assert got.schema == want.schema
        for col in want.column_names:
            if col in ("__DISTANCE__", "__AGG__") and pa.types.is_floating(want.schema.field(col).type):
                w = want.column(col).to_numpy()
                np.testing.assert_allclose(got.column(col).to_numpy(), w, rtol=1e-5,
                                           atol=1e-5 * max(1.0, float(np.abs(w).max())))
            else:
                assert got.column(col).equals(want.column(col)), col
    stats = with_attrs["port_client_on_port"].stats()
    assert stats["join.fused"] + stats["join.two_step"] + stats["join.inner"] >= 1


def test_concurrent_searches_coalesce_through_the_server(loaded):
    """Concurrent clients: every answer equals its sequential one and the
    server's batch counters account for each request."""
    port = loaded["port_client_on_port"]
    rng = np.random.default_rng(21)
    targets = [rng.standard_normal(DIM).astype(np.float32) for _ in range(24)]
    kw = dict(metric="cosine", maxval=4)
    want = [port.search(t, "items", "vector", **kw) for t in targets]
    before = port.stats()
    got = [None] * len(targets)

    def worker(i):
        client = fenix_tpu_torch.Flight(host=port.host, port=port.port)
        for j in range(i, len(targets), 8):
            got[j] = client.search(targets[j], "items", "vector", **kw)
        client.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    after = port.stats()
    assert after["batch.requests"] - before["batch.requests"] == len(targets)
    assert after["batch.queries"] - before["batch.queries"] == len(targets)
    assert 1 <= after["batch.dispatches"] - before["batch.dispatches"] <= len(targets)
    for g, w in zip(got, want):
        assert g.equals(w)
