"""fenix_tpu_torch's joins and aggregates over a mesh against the JAX
package's, on the CPU.

Three caches sit on one root and take the same numpy inputs: the port's
mesh (S shards on ``cpu``, ``make_mesh(devices=["cpu"] * S)``), the JAX
package's mesh of as many of the virtual CPU devices the suite forces
(``tests/conftest.py``), and the port on one device. The cases are every
test of ``test_parted_join.py`` (its root, BLOCK 128, meshes of 8 so that
the port's key ranges are the JAX package's), ``test_serving_mesh.py``'s
fused analytics (meshes of 4), the two-step (int8 and probed) and inner
routes on both attribute placements, and the rule that the fused route
merges by the all-gather step at any query count.

Tolerances:
- group keys equal to the JAX mesh's and to the port's single device's;
- integer aggregates equal and typed int64, sums past 2^24 included;
- float sums and means within 1e-5 · Σ|v| of their group (Σ over the
  group's joined values, from a numpy join of the single device's
  search), min and max equal (against one device's float32 values within
  float32 rounding where the partitioned inner join finishes in float64
  on the host, as the JAX package's does);
- enrichment and inner rows: against one device, the same rows in order
  with rows of tied fp32 distance in id order; against the JAX mesh, the
  same rows per query with the same attribute columns (in its order at
  k ≤ 10);
- distances within 1e-5 · max(1, d), against the JAX package's l2 plus
  4e-4 · ‖q‖ (its expanded form, see ``test_torch_mesh.py``);
- group overflow and ``max_matches`` raise the JAX package's
  ``ValueError``.
"""

import concurrent.futures

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from fenix_tpu import coder as jcoder
from fenix_tpu import expr as jexpr
from fenix_tpu import index as jindex
from fenix_tpu.engine import analytics as janalytics
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu.parallel import mesh as jmesh
from fenix_tpu.utils.metrics import GLOBAL as JMETRICS
from fenix_tpu_torch import expr
from fenix_tpu_torch.engine import analytics, executor
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.parallel import mesh as mesh_mod
from fenix_tpu_torch.parallel import search as psearch
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

torch.set_num_threads(2)

ROWS, DIM, ATTRS = 2_000, 16, 5_000  # test_parted_join.py's root
BLOCK = 128
PARTED_S = 8  # its mesh: the suite's 8 virtual devices
MESH_ROWS, MESH_DIM, MESH_S = 3_000, 32, 4  # test_serving_mesh.py's root
CONFIG = {"metric": "l2", "codebook_size": 4, "num_codebooks": 2, "batch_size": 512, "num_epochs": 2}


@pytest.fixture(autouse=True)
def _one_device_jax(monkeypatch):
    """The JAX package's process-wide serving mesh stays unset: every JAX
    cache here is given its mesh."""
    monkeypatch.setattr(jmesh, "_SERVING_MESH", None)


def _caches(root: str, n: int, block: int = BLOCK):
    """(JAX mesh, port mesh, port single device) caches on ``root``."""
    return (
        JaxCache(root, block=block, mesh=jmesh.make_mesh(devices=jax.devices()[:n])),
        DeviceCache(root, block=block, device="cpu", mesh=mesh_mod.make_mesh(devices=["cpu"] * n)),
        DeviceCache(root, block=block, device="cpu", mesh=None),
    )


def _vec_table(vecs: np.ndarray, **cols) -> pa.Table:
    return pa.table({"id": pa.array(np.arange(vecs.shape[0])), **{k: pa.array(v) for k, v in cols.items()},
                     "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32())})


def _pred(pred, module):
    """The same predicate in either package's ``expr``: ``(column, op,
    value)`` or None."""
    if pred is None:
        return None
    name, op, value = pred
    field = (expr if module is executor else jexpr).field(name)
    return {"<": field < value, "==": field == value}[op]


def run_all(caches, req_kw: dict, join_kw: dict, aggregate: "dict | None" = None) -> tuple:
    """One request through the three caches: (port mesh, port single, JAX
    mesh) answers."""
    jax_c, mesh_c, single_c = caches
    out = []
    for cache, module, amod in ((mesh_c, executor, analytics), (single_c, executor, analytics),
                                (jax_c, jexecutor, janalytics)):
        kw = {**req_kw, "filter": _pred(req_kw.get("filter"), module)}
        req = module.SearchRequest(**kw)
        agg = amod.AggregateSpec.from_dict(aggregate) if aggregate else None
        out.append(amod.execute_search_join(cache, req, amod.JoinSpec.from_dict(join_kw), agg))
    return tuple(out)


def _qids(t: pa.Table) -> np.ndarray:
    if "__QUERY_ID__" in t.column_names:
        return t.column("__QUERY_ID__").to_numpy()
    return np.zeros(t.num_rows, np.int64)


def _rows_in(t: pa.Table, order: np.ndarray) -> dict:
    return {name: t.column(name).take(pa.array(order)).to_pylist() for name in t.column_names}


def assert_rows(got: pa.Table, single: pa.Table, want_jax: pa.Table, target: np.ndarray, metric: str,
                ordered: bool) -> None:
    """Enrichment or inner rows (see the module docstring). The stable
    sorts keep an inner join's right-row order within a left row."""
    assert got.column_names == single.column_names == want_jax.column_names
    ids, d = got.column("id").to_numpy(), got.column("__DISTANCE__").to_numpy()
    g = np.lexsort((ids, d, _qids(got)))
    s = np.lexsort((single.column("id").to_numpy(), single.column("__DISTANCE__").to_numpy(), _qids(single)))
    a, b = _rows_in(got, g), _rows_in(single, s)
    for name in got.column_names:
        if name == "__DISTANCE__":
            np.testing.assert_allclose(a[name], b[name], rtol=1e-5, atol=1e-5)
        else:
            assert a[name] == b[name], name
    want_ids = want_jax.column("id").to_numpy()
    if ordered:
        np.testing.assert_array_equal(ids, want_ids)
    g = np.lexsort((ids, _qids(got)))
    w = np.lexsort((want_ids, _qids(want_jax)))
    a, b = _rows_in(got, g), _rows_in(want_jax, w)
    for name in got.column_names:
        if name != "__DISTANCE__":
            assert a[name] == b[name], name
    dg, dw = np.asarray(a["__DISTANCE__"]), np.asarray(b["__DISTANCE__"])
    slack = 1e-5 * np.maximum(1.0, np.abs(dg))
    if metric == "l2":
        slack = slack + 4e-4 * np.linalg.norm(np.atleast_2d(target), axis=1)[_qids(got)[g]]
    np.testing.assert_array_less(np.abs(dg - dw), slack)


def joined_values(attrs: pa.Table, plain: pa.Table, join_kw: dict, aggregate: dict):
    """numpy join of a plain search's rows to ``attrs``: (groups, values) of
    the joined rows (lookup: the first match; inner: every match)."""
    keys = attrs.column(join_kw["right_on"]).to_numpy()
    left = plain.column(join_kw.get("left_on", "id")).to_numpy()
    dist = plain.column("__DISTANCE__").to_numpy().astype(np.float64)
    li, ri = [], []
    for i, key in enumerate(left.tolist()):
        match = np.flatnonzero(keys == key)
        match = match if join_kw.get("how") == "inner" else match[:1]
        li += [i] * match.size
        ri += match.tolist()
    li, ri = np.asarray(li, np.int64), np.asarray(ri, np.int64)
    groups = attrs.column(aggregate["group_by"]).to_numpy()[ri]
    value = aggregate.get("value")
    if value is None:
        values = np.ones(ri.size)
    elif value == "__DISTANCE__":
        values = dist[li]
    else:
        values = attrs.column(value).to_numpy()[ri].astype(np.float64)
    return groups, values


def assert_groups(got: pa.Table, single: pa.Table, want_jax: pa.Table, groups: np.ndarray, values: np.ndarray,
                  agg: str, host_float64: bool = False, dist_slack: float = 0.0) -> None:
    """Aggregate tables (see the module docstring). ``host_float64``: the
    partitioned inner join's host finish, whose float min and max are of
    the float64 values where one device holds float32. ``dist_slack``:
    what each aggregated JAX distance may add (its l2 form)."""
    keys = got.column("__GROUP__").to_pylist()
    assert keys == single.column("__GROUP__").to_pylist() == want_jax.column("__GROUP__").to_pylist()
    assert keys == np.unique(groups).tolist()
    vals, s_vals, j_vals = (t.column("__AGG__").to_numpy() for t in (got, single, want_jax))
    int_lane = pa.types.is_integer(got.schema.field("__AGG__").type)
    if int_lane:
        assert got.schema.field("__AGG__").type == pa.int64() == single.schema.field("__AGG__").type
        assert vals.tolist() == s_vals.tolist() == j_vals.tolist()
        return
    for slot, key in enumerate(keys):
        v = values[groups == key]
        if agg in ("min", "max"):
            assert abs(vals[slot] - j_vals[slot]) <= (dist_slack and dist_slack + 1e-5 * max(1.0, abs(vals[slot])))
            if host_float64:
                assert vals[slot] == pytest.approx(s_vals[slot], rel=1e-6)
            else:
                assert vals[slot] == s_vals[slot]
            continue
        tol = 1e-5 * np.abs(v).sum()
        jax_tol = tol + dist_slack * (v.size if agg == "sum" else 1)
        assert abs(vals[slot] - s_vals[slot]) <= tol and abs(vals[slot] - j_vals[slot]) <= jax_tol, (key, agg)


def dist_slack(req: dict, spec: "dict | None") -> float:
    """The JAX package's l2 allowance per aggregated distance: 4e-4 · ‖q‖
    (largest query)."""
    if spec is None or spec.get("value") != "__DISTANCE__" or req["metric"] != "l2":
        return 0.0
    return 4e-4 * float(np.linalg.norm(np.atleast_2d(req["target"]), axis=1).max())


def _as_dict(t: pa.Table) -> dict:
    return dict(zip(t.column("__GROUP__").to_pylist(), t.column("__AGG__").to_pylist()))


# -- test_parted_join.py ------------------------------------------------------------


@pytest.fixture(scope="module")
def parted_root(tmp_path_factory):
    """test_parted_join.py's root: duplicate keys everywhere (5,000 rows
    over 1,500 values), so that runs straddle the shard ranges."""
    rng = np.random.default_rng(3)
    root = str(tmp_path_factory.mktemp("parted_root"))
    vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    table.make(root, "vec", _vec_table(vecs).to_reader())
    keys = rng.integers(0, 1500, ATTRS)
    table.make(root, "attrs", pa.table({
        "key": pa.array(keys.astype(np.int64)),
        "grp": pa.array((keys % 11).astype(np.int64)),
        "weight": pa.array(rng.standard_normal(ATTRS).astype(np.float64) * 10.0),
        "wint": pa.array((5_000_000 + keys).astype(np.int64)),  # sums past 2^24
    }).to_reader())
    return root


@pytest.fixture(scope="module")
def parted(parted_root):
    return _caches(parted_root, PARTED_S)


def parted_req(k: int = 200, seed: int = 7, **kw) -> dict:
    return dict(source="vec", column="vector", metric="l2", maxval=k,
                target=np.random.default_rng(seed).standard_normal(DIM).astype(np.float32), **kw)


@pytest.fixture(scope="module")
def parted_answers(parted):
    """Every (partitioned, aggregate) answer of the module's fused request
    through the three caches, once: the JAX package compiles each."""
    specs = [None, {"group_by": "grp", "agg": "count"},
             {"group_by": "grp", "value": "__DISTANCE__", "agg": "sum"}]
    specs += [{"group_by": "grp", "value": v, "agg": a} for v in ("weight", "wint")
              for a in ("count", "sum", "mean", "min", "max")]
    out = {}
    for spec in specs:
        for partitioned in (False, True):
            join = {"source": "attrs", "right_on": "key", "partitioned": partitioned}
            out[partitioned, str(spec)] = run_all(parted, parted_req(), join, spec)
    return out


def _plain(cache, req_kw: dict) -> pa.Table:
    return executor.execute_search(cache, executor.SearchRequest(**req_kw))


@pytest.mark.parametrize("value", ["weight", "wint"])
@pytest.mark.parametrize("agg", ["count", "sum", "mean", "min", "max"])
def test_aggregate_matches_replicated(parted, parted_answers, parted_root, agg, value):
    """test_aggregate_matches_replicated_{float,int}: both placements, three
    caches."""
    spec = {"group_by": "grp", "value": value, "agg": agg}
    groups, values = joined_values(table.load(parted_root, "attrs"), _plain(parted[2], parted_req()),
                                   {"right_on": "key"}, spec)
    for partitioned in (False, True):
        assert_groups(*parted_answers[partitioned, str(spec)], groups, values, agg)
    rep, part = (parted_answers[p, str(spec)][0] for p in (False, True))
    assert rep.column("__GROUP__").equals(part.column("__GROUP__"))
    if value == "wint" and agg != "mean":
        assert rep.column("__AGG__").equals(part.column("__AGG__"))


def test_int_sum_is_exact_past_f32(parted_answers):
    """The partitioned int sum merges exactly past 2^24, as the JAX
    package's limb lanes do."""
    spec = {"group_by": "grp", "value": "wint", "agg": "sum"}
    got, _, want = parted_answers[True, str(spec)]
    assert any(v > (1 << 24) for v in _as_dict(got).values())
    assert got.schema.field("__AGG__").type == pa.int64()
    assert _as_dict(got) == _as_dict(want)


def test_count_and_dist_value(parted, parted_answers, parted_root):
    attrs, plain = table.load(parted_root, "attrs"), _plain(parted[2], parted_req())
    for spec in ({"group_by": "grp", "agg": "count"}, {"group_by": "grp", "value": "__DISTANCE__", "agg": "sum"}):
        groups, values = joined_values(attrs, plain, {"right_on": "key"}, spec)
        for partitioned in (False, True):
            assert_groups(*parted_answers[partitioned, str(spec)], groups, values, spec["agg"],
                          dist_slack=dist_slack(parted_req(), spec))


def test_enrichment_matches_replicated(parted_answers):
    target = parted_req()["target"]
    for partitioned in (False, True):
        assert_rows(*parted_answers[partitioned, "None"], target, "l2", ordered=False)
    rep, part = parted_answers[False, "None"][0], parted_answers[True, "None"][0]
    assert rep.equals(part)


def test_first_match_semantics(parted_answers, parted_root):
    """Duplicate keys: the joined weight is the globally first attrs row's
    of each key, where a shard boundary splits the key's run too."""
    part = parted_answers[True, "None"][0]
    attrs = table.load(parted_root, "attrs")
    first = {}
    for i, key in enumerate(attrs.column("key").to_pylist()):
        first.setdefault(key, attrs.column("weight")[i].as_py())
    for i, w in zip(part.column("id").to_pylist(), part.column("weight").to_pylist()):
        assert w == first.get(i)


def test_int32_min_key_claimed(tmp_path_factory):
    """INT32_MIN is a legal key; the first shard claims it on the bare
    local match."""
    rng = np.random.default_rng(5)
    root = str(tmp_path_factory.mktemp("minkey_root"))
    lo = np.iinfo(np.int32).min
    n = 256
    jkeys = np.arange(n).astype(np.int64)
    jkeys[7] = lo
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    table.make(root, "vec", _vec_table(vecs, jkey=jkeys).to_reader())
    akeys = np.concatenate([[lo], np.arange(0, 200)]).astype(np.int64)
    table.make(root, "attrs", pa.table({"key": pa.array(akeys), "grp": pa.array((np.abs(akeys) % 5).astype(np.int64)),
                                        "weight": pa.array(np.arange(len(akeys)).astype(np.float64))}).to_reader())
    caches = _caches(root, PARTED_S)
    req = dict(source="vec", column="vector", metric="l2", maxval=4, target=vecs[7])
    for partitioned in (False, True):
        join = {"source": "attrs", "right_on": "key", "left_on": "jkey", "partitioned": partitioned}
        answers = run_all(caches, req, join)
        assert_rows(*answers, vecs[7], "l2", ordered=True)
        for out in answers:
            assert dict(zip(out.column("id").to_pylist(), out.column("weight").to_pylist()))[7] == 0.0


def test_group_overflow_raises_actionably(parted):
    spec = {"group_by": "grp", "agg": "count", "max_groups": 4}
    for partitioned in (False, True):
        join = {"source": "attrs", "right_on": "key", "partitioned": partitioned}
        for cache, amod in ((parted[1], analytics), (parted[2], analytics), (parted[0], janalytics)):
            module = executor if amod is analytics else jexecutor
            with pytest.raises(ValueError, match="max_groups"):
                amod.execute_search_join(cache, module.SearchRequest(**parted_req()), amod.JoinSpec.from_dict(join),
                                         amod.AggregateSpec.from_dict(spec))


def test_two_step_route_partitioned(parted, parted_root):
    """The int8 scan takes the two-step route; both placements answer alike
    on the three caches."""
    req = parted_req(k=150, seed=11, precision="int8")
    attrs, plain = table.load(parted_root, "attrs"), _plain(parted[2], req)
    for spec in (None, {"group_by": "grp", "agg": "count"}, {"group_by": "grp", "value": "weight", "agg": "sum"},
                 {"group_by": "grp", "value": "wint", "agg": "sum"},
                 {"group_by": "grp", "value": "__DISTANCE__", "agg": "mean"}):
        for partitioned in (False, True):
            answers = run_all(parted, req, {"source": "attrs", "right_on": "key", "partitioned": partitioned}, spec)
            if spec is None:
                assert_rows(*answers, req["target"], "l2", ordered=False)
            else:
                assert_groups(*answers, *joined_values(attrs, plain, {"right_on": "key"}, spec), spec["agg"],
                              dist_slack=dist_slack(req, spec))


def test_inner_join_partitioned(parted, parted_root):
    """Inner joins expand alike on both placements, duplicate runs across
    shard boundaries included; aggregates over the pairs and the
    max_matches bound too."""
    req = parted_req(k=40, seed=13)
    attrs, plain = table.load(parted_root, "attrs"), _plain(parted[2], req)

    def run(partitioned, aggregate=None, max_matches=4096):
        join = {"source": "attrs", "right_on": "key", "how": "inner", "partitioned": partitioned,
                "max_matches": max_matches}
        return run_all(parted, req, join, aggregate)

    rep, part = run(False), run(True)
    assert rep[0].num_rows > 40  # expansion
    for answers in (rep, part):
        assert_rows(*answers, req["target"], "l2", ordered=False)
    assert rep[0].equals(part[0])
    for spec in ({"group_by": "grp", "agg": "count"}, {"group_by": "grp", "value": "wint", "agg": "sum"},
                 {"group_by": "grp", "value": "weight", "agg": "mean"},
                 {"group_by": "grp", "value": "__DISTANCE__", "agg": "min"}):
        groups, values = joined_values(attrs, plain, {"right_on": "key", "how": "inner"}, spec)
        for partitioned in (False, True):
            assert_groups(*run(partitioned, spec), groups, values, spec["agg"], host_float64=partitioned,
                          dist_slack=dist_slack(req, spec))
    for partitioned in (False, True):
        for cache, amod in ((parted[1], analytics), (parted[0], janalytics)):
            module = executor if amod is analytics else jexecutor
            join = amod.JoinSpec(source="attrs", right_on="key", how="inner", partitioned=partitioned, max_matches=8)
            with pytest.raises(ValueError, match="max_matches"):
                amod.execute_search_join(cache, module.SearchRequest(**req), join)


def test_empty_search_result_joins(parted):
    """A filter that passes nothing joins and aggregates to an empty table
    on every route and placement."""
    req = parted_req(k=10, seed=21, precision="int8", filter=("id", "<", 0))
    for partitioned in (False, True):
        join = {"source": "attrs", "right_on": "key", "partitioned": partitioned}
        for spec in (None, {"group_by": "grp", "agg": "count"}, {"group_by": "grp", "value": "weight", "agg": "sum"},
                     {"group_by": "grp", "value": "__DISTANCE__", "agg": "mean"}):
            got, single, want = run_all(parted, req, join, spec)
            assert got.num_rows == single.num_rows == want.num_rows == 0
            assert got.schema == single.schema


def test_inner_join_int32_max_key(tmp_path_factory):
    """INT32_MAX is a legal key and the padding sentinel: the partitioned
    inner join counts no padding slot as a match."""
    rng = np.random.default_rng(17)
    root = str(tmp_path_factory.mktemp("maxkey_root"))
    hi = np.iinfo(np.int32).max
    n = 128
    jkeys = np.arange(n).astype(np.int64)
    jkeys[5] = hi
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    table.make(root, "vec", _vec_table(vecs, jkey=jkeys).to_reader())
    akeys = np.concatenate([[hi, hi], np.arange(0, 99)]).astype(np.int64)
    table.make(root, "attrs", pa.table({"key": pa.array(akeys),
                                        "weight": pa.array(np.arange(len(akeys)).astype(np.float64))}).to_reader())
    caches = _caches(root, PARTED_S)
    req = dict(source="vec", column="vector", metric="l2", maxval=4, target=vecs[5])
    outs = {}
    for partitioned in (False, True):
        join = {"source": "attrs", "right_on": "key", "left_on": "jkey", "how": "inner",
                "partitioned": partitioned, "max_matches": 16}
        answers = run_all(caches, req, join)
        assert_rows(*answers, vecs[5], "l2", ordered=True)
        outs[partitioned] = answers[0]
    assert outs[False].equals(outs[True])
    assert outs[True].column("id").to_pylist().count(5) == 2


def test_concurrent_attr_mutations_and_parted_joins(tmp_path, rng):
    """Writers rewrite the attribute table while partitioned joins serve on
    the port's mesh: every answer reads one revision (grp == key % 7 in
    every revision, so a torn read shows)."""
    root = str(tmp_path)
    n = 1024
    table.make(root, "vec", _vec_table(rng.standard_normal((n, DIM)).astype(np.float32)).to_reader())

    def attrs(size: int) -> pa.Table:
        keys = rng.integers(0, n, size)
        return pa.table({"key": pa.array(keys.astype(np.int64)), "grp": pa.array((keys % 7).astype(np.int64))})

    table.make(root, "attrs", attrs(2000).to_reader())
    cache = DeviceCache(root, block=64, device="cpu", mesh=mesh_mod.make_mesh(devices=["cpu"] * PARTED_S))
    errors: list = []

    def writer(i: int) -> None:
        try:
            table.rewrite(root, "attrs", attrs(2000 + i * 16).to_reader())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def reader(q: np.ndarray) -> None:
        try:
            out = analytics.execute_search_join(
                cache, executor.SearchRequest(source="vec", column="vector", target=q, metric="l2", maxval=64),
                analytics.JoinSpec(source="attrs", right_on="key", partitioned=True))
            for i, g in zip(out.column("id").to_pylist(), out.column("grp").to_pylist()):
                if g is not None:
                    assert g == i % 7, (i, g)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    queries = rng.standard_normal((16, DIM)).astype(np.float32)
    with concurrent.futures.ThreadPoolExecutor(10) as pool:
        futs = [pool.submit(writer, i) for i in range(6)] + [pool.submit(reader, q) for q in queries]
        [f.result() for f in futs]
    assert not errors, errors[:3]


def test_route_counter_and_auto_threshold(parted, monkeypatch):
    """join.partitioned rises once per partitioned call in both packages;
    FENIX_PART_ATTRS_MIN routes an unset ``partitioned`` by table size."""
    spec = {"group_by": "grp", "agg": "count"}

    def counts():
        return METRICS.snapshot().get("join.partitioned", 0), JMETRICS.snapshot().get("join.partitioned", 0)

    def run(partitioned):
        run_all(parted, parted_req(), {"source": "attrs", "right_on": "key", "partitioned": partitioned}, spec)

    before = counts()
    run(True)
    assert counts() == (before[0] + 1, before[1] + 1)
    monkeypatch.setenv("FENIX_PART_ATTRS_MIN", "1")
    run(None)
    assert counts() == (before[0] + 2, before[1] + 2)
    monkeypatch.setenv("FENIX_PART_ATTRS_MIN", str(1 << 30))
    run(None)
    assert counts() == (before[0] + 2, before[1] + 2)
    monkeypatch.delenv("FENIX_PART_ATTRS_MIN")
    run(None)  # 5,000 rows: under the default 2^20
    assert counts() == (before[0] + 2, before[1] + 2)


def test_parted_key_layout_is_the_jax_packages(parted):
    """The partitioned build side: the port's sorted keys, original rows,
    bounds and the permuted group column equal the JAX package's shard for
    shard."""
    jax_c, mesh_c, _ = parted
    pk, pi, bounds, rows, perm = mesh_c.parted_key("attrs", "key")
    jpk, jpi, jbounds, jrows, jperm = jax_c.parted_key("attrs", "key")
    assert rows == jrows == ATTRS
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(bounds, np.asarray(jbounds))
    assert pk.rows_local * PARTED_S == np.asarray(jpk).shape[0]
    np.testing.assert_array_equal(pk.gather().numpy(), np.asarray(jpk))
    np.testing.assert_array_equal(pi.gather().numpy(), np.asarray(jpi))
    grp = mesh_c.parted_scalar("attrs", "grp", "key")
    np.testing.assert_array_equal(grp.gather().numpy(), np.asarray(jax_c.parted_scalar("attrs", "grp", "key")))
    assert grp.dtype == torch.int32
    assert mesh_c.parted_scalar("attrs", "weight", "key").dtype == torch.float32


def test_gather_rowsharded(rng):
    """``column[gid]`` from a row-sharded column (0 where not valid); a
    float column is refused."""
    mesh = mesh_mod.make_mesh(devices=["cpu"] * 4)
    host = rng.integers(-1000, 1000, 4 * 64).astype(np.int32)
    col = psearch.put_rows(mesh, host, host.shape[0])
    gids = torch.from_numpy(rng.integers(0, host.shape[0], (3, 7)))
    valid = torch.from_numpy(rng.random((3, 7)) < 0.8)
    got = psearch.gather_rowsharded(col, gids, valid)
    np.testing.assert_array_equal(got.numpy(), np.where(valid.numpy(), host[gids.numpy()], 0))
    flags = psearch.put_rows(mesh, host > 0, host.shape[0])
    np.testing.assert_array_equal(psearch.gather_rowsharded(flags, gids, valid).numpy(),
                                  valid.numpy() & (host[gids.numpy()] > 0))
    with pytest.raises(TypeError, match="integer"):
        psearch.gather_rowsharded(psearch.put_rows(mesh, host.astype(np.float32), host.shape[0]), gids, valid)


# -- test_serving_mesh.py, and the routes on both placements ---------------------------


@pytest.fixture(scope="module")
def mesh_root(tmp_path_factory):
    """test_serving_mesh.py's root (3,000 x 32 rows in two clusters, an IVF
    coder 2 x 4 and its index, attrs keyed by t.id) with attrs_dup for the
    inner joins (ids 0..999 match three rows each)."""
    rng = np.random.default_rng(11)
    root = str(tmp_path_factory.mktemp("mesh_root"))
    vecs = rng.standard_normal((MESH_ROWS, MESH_DIM)).astype(np.float32)
    vecs[1000:] += 4.0
    table.make(root, "t", _vec_table(vecs, tag=rng.integers(0, 5, MESH_ROWS)).to_reader())
    jmesh._SERVING_MESH = None
    jcoder.make(root, "c", "t", "vector", CONFIG, seed=0)
    jindex.make(root, "c", "t", "vector")
    jmesh._SERVING_MESH = "unset"
    table.make(root, "attrs", pa.table({
        "key": pa.array(np.arange(MESH_ROWS)),
        "grp": pa.array(rng.integers(0, 7, MESH_ROWS)),
        "val": pa.array(rng.standard_normal(MESH_ROWS).astype(np.float64)),
    }).to_reader())
    i = np.arange(3000)
    table.make(root, "attrs_dup", pa.table({"key": pa.array(i // 3), "grp": pa.array(i % 5),
                                            "cnt": pa.array((i * 7919) % 1000 - 500)}).to_reader())
    return root


@pytest.fixture(scope="module")
def meshes(mesh_root):
    return _caches(mesh_root, MESH_S)


def mesh_req(q: int, seed: int, **kw) -> dict:
    return dict(source="t", column="vector", metric=kw.pop("metric", "l2"),
                target=np.random.default_rng(seed).standard_normal((q, MESH_DIM)).astype(np.float32), **kw)


def check_answers(answers, mesh_root, req: dict, join: dict, spec: "dict | None", host_float64=False) -> None:
    if spec is None:
        assert_rows(*answers, req["target"], req["metric"], ordered=req["maxval"] <= 10)
        return
    attrs = table.load(mesh_root, join["source"])
    plain = executor.execute_search(DeviceCache(mesh_root, block=BLOCK, device="cpu", mesh=None),
                                    executor.SearchRequest(**{**req, "filter": _pred(req.get("filter"), executor)}))
    assert_groups(*answers, *joined_values(attrs, plain, join, spec), spec["agg"], host_float64,
                  dist_slack(req, spec))


@pytest.mark.parametrize(
    "aggspec",
    [None, {"group_by": "grp", "agg": "count", "max_groups": 16},
     {"group_by": "grp", "agg": "sum", "value": "val", "max_groups": 16},
     {"group_by": "grp", "agg": "min", "value": "__DISTANCE__", "max_groups": 16}],
    ids=["enrich", "count", "sum-val", "min-dist"],
)
def test_sharded_fused_analytics(meshes, mesh_root, aggspec):
    """test_serving_mesh.py::test_sharded_fused_analytics: the fused route
    with the fact side sharded and the attribute side replicated (3,000
    rows: under the partitioning threshold)."""
    req = mesh_req(3, 1, maxval=8)
    join = {"source": "attrs", "right_on": "key", "left_on": "id"}
    before = METRICS.snapshot()
    answers = run_all(meshes, req, join, aggspec)
    after = METRICS.snapshot()
    assert after.get("join.fused", 0) - before.get("join.fused", 0) == 2  # the port's mesh and single device
    assert after.get("join.partitioned", 0) == before.get("join.partitioned", 0)
    check_answers(answers, mesh_root, req, join, aggspec)


def test_sharded_fused_analytics_filtered(meshes, mesh_root):
    req = mesh_req(2, 2, maxval=6, filter=("tag", "<", 3))
    join = {"source": "attrs", "right_on": "key", "left_on": "id"}
    answers = run_all(meshes, req, join)
    check_answers(answers, mesh_root, req, join, None)
    tags = table.load(mesh_root, "t").column("tag").to_numpy()
    assert (tags[answers[0].column("id").to_numpy()] < 3).all()


ROUTE_CASES = [
    ("int8", dict(precision="int8"), {"source": "attrs", "right_on": "key"},
     [None, {"group_by": "grp", "agg": "count", "max_groups": 16},
      {"group_by": "grp", "value": "val", "agg": "sum", "max_groups": 16},
      {"group_by": "grp", "value": "__DISTANCE__", "agg": "mean", "max_groups": 16}], "join.two_step"),
    ("probed", dict(coding="c", probes=3), {"source": "attrs", "right_on": "key"},
     [None, {"group_by": "grp", "value": "val", "agg": "max", "max_groups": 16}], "join.two_step"),
    ("inner", dict(metric="cosine"), {"source": "attrs_dup", "right_on": "key", "how": "inner"},
     [None, {"group_by": "grp", "agg": "count", "max_groups": 16},
      {"group_by": "grp", "value": "cnt", "agg": "sum", "max_groups": 16},
      {"group_by": "grp", "value": "cnt", "agg": "mean", "max_groups": 16}], "join.inner"),
]


@pytest.mark.parametrize("partitioned", [False, True], ids=["replicated", "partitioned"])
@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_routes_on_both_placements(meshes, mesh_root, case, partitioned):
    """The two-step (int8 scan, probed) and inner routes over the mesh with
    the attribute side replicated or partitioned: each call moves its route
    counter, and join.partitioned with the partitioned placement."""
    name, kw, join, specs, counter = case
    req = mesh_req(4, 3, maxval=10, **kw)
    join = {**join, "partitioned": partitioned}
    for spec in specs:
        before = METRICS.snapshot()
        answers = run_all(meshes, req, join, spec)
        after = METRICS.snapshot()
        assert after.get(counter, 0) - before.get(counter, 0) == 2
        assert after.get("join.partitioned", 0) - before.get("join.partitioned", 0) == int(partitioned)
        check_answers(answers, mesh_root, req, join, spec, host_float64=partitioned and name == "inner")


@pytest.mark.parametrize("partitioned", [False, True], ids=["replicated", "partitioned"])
def test_fused_route_merges_by_all_gather(meshes, mesh_root, partitioned, monkeypatch):
    """A fused request of 600 queries (the ring's padded count and more)
    merges by the all-gather step, as the JAX package's fused mesh route
    does: it moves join.fused and no search.mesh_* counter, and answers as
    one device does."""
    monkeypatch.setenv("FENIX_RING", "auto")
    _, mesh_c, single_c = meshes
    req = mesh_req(600, 4, maxval=5)
    join = analytics.JoinSpec(source="attrs", right_on="key", partitioned=partitioned)
    spec = analytics.AggregateSpec(group_by="grp", max_groups=16)
    before = METRICS.snapshot()
    got = analytics.execute_search_join(mesh_c, executor.SearchRequest(**req), join, spec)
    after = METRICS.snapshot()
    for key in ("search.mesh_ring", "search.mesh_gather"):
        assert after.get(key, 0) == before.get(key, 0), key
    assert after.get("join.fused", 0) == before.get("join.fused", 0) + 1
    want = analytics.execute_search_join(single_c, executor.SearchRequest(**req), join, spec)
    assert got.equals(want)
    assert sum(got.column("__AGG__").to_pylist()) == 600 * 5
