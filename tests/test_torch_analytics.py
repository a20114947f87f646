"""fenix_tpu_torch.engine.analytics against fenix_tpu.engine.analytics on
one catalog root, on the CPU: every case of tests/test_analytics.py
through both packages' ``execute_search_join`` (and the wire config
through both ``service.run_search_config``).

Tables must be equal column by column: ids, attribute columns, group
keys and integer aggregates exactly (integer aggregates typed int64),
``__DISTANCE__`` and float aggregates within 1e-5 relative (both
packages accumulate float32, in different orders). The JAX side runs
with ``mesh=None``, one device, as the port does.
"""

import collections

import numpy as np
import pyarrow as pa
import pytest
import torch

from fenix_tpu import expr as jexpr
from fenix_tpu.engine import analytics as janalytics
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine import service as jservice
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu.utils.metrics import GLOBAL as JMETRICS
from fenix_tpu_torch import expr
from fenix_tpu_torch.engine import analytics, executor, residency, service
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS
from tests import oracles

torch.set_num_threads(2)

ROWS, DIM, ATTRS = 1500, 16, 900


def _vec_table(rng, rows=ROWS):
    vecs = rng.standard_normal((rows, DIM)).astype(np.float32)
    return pa.table({"id": pa.array(np.arange(rows)),
                     "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32())})


@pytest.fixture
def root(tmp_path, rng):
    root = str(tmp_path)
    table.make(root, "vec", _vec_table(rng).to_reader())
    attr_ids = rng.permutation(ROWS)[:ATTRS]  # a subset of ids, scrambled
    table.make(root, "attrs", pa.table({
        "key": pa.array(attr_ids.astype(np.int64)),
        "grp": pa.array((attr_ids % 7).astype(np.int64)),
        "weight": pa.array(attr_ids.astype(np.float64) * 0.5),
    }).to_reader())
    return root


@pytest.fixture
def bigint_root(tmp_path, rng):
    """An int64 value column far past 2^24: float32 would round its sums."""
    root = str(tmp_path)
    table.make(root, "vec", _vec_table(rng).to_reader())
    big = rng.integers(2**27, 2**31 - 1, ROWS, dtype=np.int64)
    big[::3] *= -1
    table.make(root, "attrs", pa.table({
        "key": pa.array(np.arange(ROWS, dtype=np.int64)),
        "grp": pa.array((np.arange(ROWS) % 5).astype(np.int64)),
        "big": pa.array(big),
    }).to_reader())
    return root, big


@pytest.fixture
def dup_root(tmp_path, rng):
    """Attrs with duplicate keys: each id 0..99 matches 0-3 rows."""
    root = str(tmp_path)
    table.make(root, "vec", _vec_table(rng, rows=200).to_reader())
    keys, grps, ws = [], [], []
    for i in range(100):
        for jj in range(i % 4):
            keys.append(i)
            grps.append(jj)
            ws.append(float(i * 10 + jj))
    table.make(root, "attrs", pa.table({
        "key": pa.array(np.asarray(keys, np.int64)),
        "grp": pa.array(np.asarray(grps, np.int64)),
        "weight": pa.array(np.asarray(ws, np.float64)),
    }).to_reader())
    return root


@pytest.fixture
def intmax_root(tmp_path, rng):
    """A group column holding the literal 2^31 − 1 beside unmatched rows."""
    root = str(tmp_path)
    table.make(root, "vec", _vec_table(rng).to_reader())
    attr_ids = rng.permutation(ROWS)[:ATTRS]
    grp = np.where(attr_ids % 3 == 0, 2**31 - 1, attr_ids % 5).astype(np.int64)
    table.make(root, "attrs", pa.table({
        "key": pa.array(attr_ids.astype(np.int64)),
        "grp": pa.array(grp),
        "weight": pa.array((attr_ids % 11).astype(np.int64)),
    }).to_reader())
    return root


def _join_both(root, req_kw: dict, join: dict, aggregate: "dict | None" = None):
    """Both packages' execute_search_join on one root, from one spec."""
    kw = {"source": "vec", "column": "vector", "metric": "l2", **req_kw}
    jkw = dict(kw)
    if kw.get("filter") is not None:  # the same predicate, through the wire form
        jkw["filter"] = jexpr.Expr.from_dict(kw["filter"].to_dict())
    got = analytics.execute_search_join(
        DeviceCache(root, device="cpu"), executor.SearchRequest(**kw),
        analytics.JoinSpec(**join), analytics.AggregateSpec(**aggregate) if aggregate else None,
    )
    want = janalytics.execute_search_join(
        JaxCache(root, mesh=None), jexecutor.SearchRequest(**jkw),
        janalytics.JoinSpec(**join), janalytics.AggregateSpec(**aggregate) if aggregate else None,
    )
    return got, want


def assert_same(got: pa.Table, want: pa.Table) -> None:
    """Equal tables: exact but for float distances and float aggregates
    (1e-5 relative to the largest magnitude of the column)."""
    assert got.schema == want.schema, (got.schema, want.schema)
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        if name in ("__DISTANCE__", analytics.AGG_COL) and pa.types.is_floating(w.type):
            gn, wn = g.to_numpy(), w.to_numpy()
            scale = max(1.0, float(np.abs(wn).max(initial=0.0)))
            np.testing.assert_allclose(gn, wn, rtol=1e-5, atol=1e-5 * scale)
        else:
            assert g.equals(w), name


def _groups(out: pa.Table) -> dict:
    return dict(zip(out.column(analytics.GROUP_COL).to_pylist(), out.column(analytics.AGG_COL).to_pylist()))


def _oracle_top(root, target, k):
    vecs = ingest.fixed_size_list_to_numpy(table.load(root, "vec").column("vector"))
    return oracles.topk(oracles.distance(np.atleast_2d(target), vecs, "l2"), k)[1]


def test_join_enrichment(root, rng):
    target = rng.standard_normal(DIM).astype(np.float32)
    got, want = _join_both(root, {"target": target, "maxval": 50}, {"source": "attrs", "right_on": "key"})
    assert got.num_rows == 50 and {"grp", "weight"} <= set(got.column_names)
    assert_same(got, want)
    attrs = table.load(root, "attrs")
    lookup = dict(zip(attrs.column("key").to_pylist(), attrs.column("weight").to_pylist()))
    assert got.column("weight").to_pylist() == [lookup.get(i) for i in got.column("id").to_pylist()]


def test_join_aggregate_count(root, rng):
    target = rng.standard_normal(DIM).astype(np.float32)
    got, want = _join_both(root, {"target": target, "maxval": 100}, {"source": "attrs", "right_on": "key"},
                           {"group_by": "grp", "agg": "count"})
    assert_same(got, want)
    assert pa.types.is_int64(got.column(analytics.AGG_COL).type)
    attrs = table.load(root, "attrs")
    lookup = dict(zip(attrs.column("key").to_pylist(), attrs.column("grp").to_pylist()))
    top = _oracle_top(root, target, 100)
    assert _groups(got) == collections.Counter(lookup[i] for i in top[0].tolist() if i in lookup)


def test_join_aggregate_sum_weight(root, rng):
    target = rng.standard_normal(DIM).astype(np.float32)
    got, want = _join_both(root, {"target": target, "maxval": 80}, {"source": "attrs", "right_on": "key"},
                           {"group_by": "grp", "value": "weight", "agg": "sum"})
    assert_same(got, want)
    attrs = table.load(root, "attrs")
    g = dict(zip(attrs.column("key").to_pylist(), attrs.column("grp").to_pylist()))
    w = dict(zip(attrs.column("key").to_pylist(), attrs.column("weight").to_pylist()))
    expect: dict = {}
    for i in _oracle_top(root, target, 80)[0].tolist():
        if i in g:
            expect[g[i]] = expect.get(g[i], 0.0) + w[i]
    got_g = _groups(got)
    assert set(got_g) == set(expect)
    for key in expect:
        np.testing.assert_allclose(got_g[key], expect[key], rtol=1e-6)


def test_join_aggregate_two_step_path_matches_fused(root, rng):
    target = rng.standard_normal(DIM).astype(np.float32)
    join = {"source": "attrs", "right_on": "key"}
    agg = {"group_by": "grp", "agg": "count", "max_groups": 64}
    before = METRICS.snapshot()
    fused, jfused = _join_both(root, {"target": target, "maxval": 40}, join, agg)
    two, jtwo = _join_both(root, {"target": target, "maxval": 40, "precision": "bf16"}, join, agg)
    after = METRICS.snapshot()
    assert after["join.fused"] == before.get("join.fused", 0) + 1
    assert after["join.two_step"] == before.get("join.two_step", 0) + 1
    assert_same(fused, jfused)
    assert_same(two, jtwo)
    assert _groups(fused) == _groups(two)


@pytest.mark.parametrize("agg", ["sum", "mean", "min", "max"])
@pytest.mark.parametrize("route", ["fused", "twostep"])
def test_join_aggregate_int64_exact(bigint_root, rng, agg, route):
    root, big = bigint_root
    target = rng.standard_normal(DIM).astype(np.float32)
    got, want = _join_both(
        root, {"target": target, "maxval": 200, "precision": "bf16" if route == "twostep" else "fp32"},
        {"source": "attrs", "right_on": "key"}, {"group_by": "grp", "value": "big", "agg": agg, "max_groups": 16},
    )
    assert got.equals(want)  # bit-equal, mean included
    ids = _oracle_top(root, target, 200)[0]
    got_g = _groups(got)
    for g in range(5):
        sel = big[ids[ids % 5 == g]].astype(np.int64)
        expect = {"sum": sel.sum(), "mean": sel.sum() / len(sel), "min": sel.min(), "max": sel.max()}[agg]
        assert got_g[g] == expect
    want_type = pa.float64() if agg == "mean" else pa.int64()
    assert got.column(analytics.AGG_COL).type == want_type


def test_join_enrichment_multi_query_fused(root, rng):
    target = rng.standard_normal((3, DIM)).astype(np.float32)
    got, want = _join_both(root, {"target": target, "maxval": 6}, {"source": "attrs", "right_on": "key"})
    assert got.num_rows == 18 and "__QUERY_ID__" in got.column_names
    assert_same(got, want)


@pytest.mark.parametrize("select", [None, ["id"]])
def test_join_enrichment_of_chosen_columns_with_a_filter(root, rng, select):
    target = rng.standard_normal((2, DIM)).astype(np.float32)
    got, want = _join_both(
        root, {"target": target, "maxval": 9, "select": select, "filter": expr.field("id") % 3 == 0},
        {"source": "attrs", "right_on": "key", "columns": ["weight"]},
    )
    assert_same(got, want)
    assert (got.column("id").to_numpy() % 3 == 0).all()


def test_inner_join_duplicates_and_drops(dup_root, rng):
    target = rng.standard_normal(DIM).astype(np.float32)
    got, want = _join_both(dup_root, {"target": target, "maxval": 30},
                           {"source": "attrs", "right_on": "key", "how": "inner"})
    assert_same(got, want)
    base = executor.execute_search(
        DeviceCache(dup_root, device="cpu"),
        executor.SearchRequest("vec", "vector", target, metric="l2", maxval=30),
    )
    keys = table.load(dup_root, "attrs").column("key").to_pylist()
    pairs = [(li, ri) for li, rid in enumerate(base.column("id").to_pylist())
             for ri, k in enumerate(keys) if k == rid]
    assert got.column("id").to_pylist() == [base.column("id")[li].as_py() for li, _ in pairs]
    assert all(i < 100 and i % 4 != 0 for i in got.column("id").to_pylist())


def test_inner_join_aggregate_counts_pairs(dup_root, rng):
    target = rng.standard_normal(DIM).astype(np.float32)
    got, want = _join_both(dup_root, {"target": target, "maxval": 40},
                           {"source": "attrs", "right_on": "key", "how": "inner"},
                           {"group_by": "grp", "agg": "count", "max_groups": 16})
    assert_same(got, want)
    assert pa.types.is_int64(got.column(analytics.AGG_COL).type)


@pytest.mark.parametrize("aggregate", [None, {"group_by": "grp", "agg": "count", "max_groups": 16}])
def test_inner_join_max_matches_guard(dup_root, rng, aggregate):
    cache = DeviceCache(dup_root, device="cpu")
    req = executor.SearchRequest("vec", "vector", rng.standard_normal(DIM).astype(np.float32),
                                 metric="l2", maxval=100)
    spec = analytics.JoinSpec(source="attrs", right_on="key", how="inner", max_matches=8)
    with pytest.raises(ValueError, match="max_matches"):
        analytics.execute_search_join(cache, req, spec, analytics.AggregateSpec(**aggregate) if aggregate else None)


@pytest.mark.parametrize("aggregate", [None, {"group_by": "grp", "value": "weight", "agg": "sum"},
                                       {"group_by": "grp", "agg": "count"}])
@pytest.mark.parametrize("how", ["inner", "lookup"])
def test_join_empty_result(dup_root, rng, aggregate, how):
    """An empty probe side: the same empty table, schema included."""
    target = rng.standard_normal(DIM).astype(np.float32)
    got, want = _join_both(dup_root, {"target": target, "maxval": 10, "precision": "bf16",
                                      "filter": expr.field("id") < 0},
                           {"source": "attrs", "right_on": "key", "how": how}, aggregate)
    assert got.num_rows == 0
    assert_same(got, want)


@pytest.mark.parametrize("route", ["fused", "twostep", "parted", "inner"])
@pytest.mark.parametrize("agg,value", [("count", None), ("sum", "weight")])
def test_group_value_intmax_is_a_real_group(intmax_root, rng, route, agg, value):
    target = rng.standard_normal(DIM).astype(np.float32)
    got, want = _join_both(
        intmax_root, {"target": target, "maxval": 120, "precision": "bf16" if route == "twostep" else "fp32"},
        {"source": "attrs", "right_on": "key", "how": "inner" if route == "inner" else "lookup",
         "partitioned": True if route == "parted" else None},
        {"group_by": "grp", "value": value, "agg": agg, "max_groups": 16},
    )
    assert got.equals(want)
    assert 2**31 - 1 in _groups(got)


def test_partitioned_join_is_downgraded_on_one_device(intmax_root, rng, caplog):
    """partitioned=True without a mesh: a warning and
    join.partitioned_downgraded, in both packages, and the replicated
    answer."""
    target = rng.standard_normal(DIM).astype(np.float32)
    before, jbefore = METRICS.snapshot(), JMETRICS.snapshot()
    with caplog.at_level("WARNING", logger="fenix_tpu_torch"):
        got, want = _join_both(intmax_root, {"target": target, "maxval": 50},
                               {"source": "attrs", "right_on": "key", "partitioned": True},
                               {"group_by": "grp", "agg": "count", "max_groups": 16})
    assert METRICS.snapshot()["join.partitioned_downgraded"] == before.get("join.partitioned_downgraded", 0) + 1
    assert JMETRICS.snapshot()["join.partitioned_downgraded"] == jbefore.get("join.partitioned_downgraded", 0) + 1
    assert any("replicating" in r.getMessage() for r in caplog.records)
    assert got.equals(want)
    plain, _ = _join_both(intmax_root, {"target": target, "maxval": 50},
                          {"source": "attrs", "right_on": "key"},
                          {"group_by": "grp", "agg": "count", "max_groups": 16})
    assert got.equals(plain)


@pytest.mark.parametrize("aggregate", [None, {"group_by": "grp", "value": "weight", "agg": "sum"}])
def test_join_past_the_budget_takes_the_two_step_route(root, rng, monkeypatch, aggregate):
    """With the device budget too small for DUAL residency the port asks
    residency.plan and searches the host corpus before joining on the card;
    the JAX package takes its fused route anyway. The answers agree."""
    monkeypatch.setenv("FENIX_HBM_BUDGET", "60000")
    target = rng.standard_normal((2, DIM)).astype(np.float32)
    req = executor.SearchRequest("vec", "vector", target, metric="l2", maxval=25)
    assert residency.plan(DeviceCache(root, device="cpu"), req) != residency.DUAL
    before = METRICS.snapshot()
    got, want = _join_both(root, {"target": target, "maxval": 25}, {"source": "attrs", "right_on": "key"}, aggregate)
    after = METRICS.snapshot()
    assert after["join.two_step"] == before.get("join.two_step", 0) + 1
    assert after.get("join.fused", 0) == before.get("join.fused", 0)
    assert_same(got, want)


@pytest.mark.parametrize("config", [
    {"join": {"source": "attrs", "right_on": "key"}},
    {"join": {"source": "attrs", "right_on": "key"},
     "aggregate": {"group_by": "grp", "value": "weight", "agg": "mean", "max_groups": 16}},
    {"join": {"source": "attrs", "right_on": "key", "how": "inner", "columns": ["grp"]},
     "aggregate": {"group_by": "grp", "value": "__DISTANCE__", "agg": "max"}},
])
def test_run_search_config_routes_joins(root, rng, config):
    target = rng.standard_normal((3, DIM)).astype(np.float32)
    full = {"source": "vec", "column": "vector", "metric": "cosine", "maxval": 12, **config}
    got = service.run_search_config(DeviceCache(root, device="cpu"), full, target)
    want = jservice.run_search_config(JaxCache(root, mesh=None), full, target)
    assert_same(got, want)
