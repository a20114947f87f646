"""fenix_tpu_torch.engine.batching and executor.execute_search_batched on
the CPU: every case of tests/test_batching.py, and the port's batched
tables against the JAX package's execute_search_batched on one root.

Within the port an fp32 batch must give each member exactly the table it
gets alone (``==``). Against the JAX package ids and every gathered
column are equal and ``__DISTANCE__`` within 1e-5 (the two packages sum
the rescore in different orders).

bf16 / int8 members are held to their solo answer by the parity
contract's graded-selection rule: phase 1 ranks buckets at the scan's
precision, so a batch (whose bucket size follows its query count) may
pick other candidates within the ``BUCKET_PAD`` margin. Each member must
recall at least 0.99 of its solo ids, and every id the two share carries
the same fp32-true distance (the rescore is exact).
"""

import sys
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from fenix_tpu import expr as jexpr
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu_torch import coder, expr, index
from fenix_tpu_torch.engine import batching, executor, service
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

torch.set_num_threads(2)

ROWS, DIM = 1500, 32
IVF = {"metric": "l2", "codebook_size": 4, "num_codebooks": 2, "batch_size": 256, "num_epochs": 2}


@pytest.fixture
def root(tmp_path, rng):
    root = str(tmp_path)
    x = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    x[900:920] = x[:20]  # exact duplicate rows: ties in id order
    data = pa.table({
        "id": pa.array(np.arange(ROWS)),
        "tag": pa.array(rng.integers(0, 4, ROWS)),
        "vector": ingest.numpy_to_fixed_size_list(x, pa.float32()),
    })
    table.make(root, "b/table", data.to_reader(max_chunksize=400))
    return root


@pytest.fixture
def cache(root):
    return DeviceCache(root, device="cpu")


def _req(target, **kw):
    defaults = dict(source="b/table", column="vector", metric="l2", maxval=5)
    defaults.update(kw)
    return executor.SearchRequest(target=target, **defaults)


def _jreq(req: executor.SearchRequest) -> "jexecutor.SearchRequest":
    kw = {k: getattr(req, k) for k in ("source", "column", "target", "metric", "coding", "select",
                                       "maxval", "probes", "precision", "residency", "extra")}
    if req.filter is not None:
        kw["filter"] = jexpr.Expr.from_dict(req.filter.to_dict())
    return jexecutor.SearchRequest(**kw)


def assert_like_jax(got: pa.Table, want: pa.Table) -> None:
    assert got.schema == want.schema
    for name in want.column_names:
        if name == executor.DIST_COL:
            np.testing.assert_allclose(got.column(name).to_numpy(), want.column(name).to_numpy(),
                                       rtol=1e-5, atol=1e-5)
        else:
            assert got.column(name).equals(want.column(name)), name


def _batched_both(root, cache, reqs):
    got = executor.execute_search_batched(cache, reqs)
    want = jexecutor.execute_search_batched(JaxCache(root, mesh=None), [_jreq(r) for r in reqs])
    for g, w in zip(got, want):
        assert_like_jax(g, w)
    return got


def assert_graded(got: pa.Table, solo: pa.Table) -> None:
    """The graded-selection rule of the module docstring."""
    assert got.schema == solo.schema and got.num_rows == solo.num_rows
    qcol = executor.QUERY_COL if executor.QUERY_COL in got.column_names else None
    gq = got.column(qcol).to_numpy() if qcol else np.zeros(got.num_rows, np.int64)
    sq = solo.column(qcol).to_numpy() if qcol else np.zeros(solo.num_rows, np.int64)
    gi, si = got.column("id").to_numpy(), solo.column("id").to_numpy()
    gd, sd = got.column(executor.DIST_COL).to_numpy(), solo.column(executor.DIST_COL).to_numpy()
    hits = 0
    for q in np.unique(sq):
        g = dict(zip(gi[gq == q].tolist(), gd[gq == q].tolist()))
        s = dict(zip(si[sq == q].tolist(), sd[sq == q].tolist()))
        shared = g.keys() & s.keys()
        hits += len(shared)
        assert all(g[i] == s[i] for i in shared)
    assert hits >= 0.99 * len(si)


def test_batched_matches_solo(root, cache, rng):
    targets = [rng.standard_normal((q, DIM)).astype(np.float32) for q in (1, 3, 2)]
    reqs = [_req(t, maxval=m) for t, m in zip(targets, (5, 7, 3))]
    got = _batched_both(root, cache, reqs)
    for g, r in zip(got, reqs):
        assert g == executor.execute_search(cache, r)


def test_batched_respects_select_and_metric(root, cache, rng):
    reqs = [_req(rng.standard_normal(DIM).astype(np.float32), metric="cosine", select=["id"]),
            _req(rng.standard_normal((2, DIM)).astype(np.float32), metric="cosine")]
    got = _batched_both(root, cache, reqs)
    assert got[0].column_names == ["id", executor.DIST_COL]
    assert got[0] == executor.execute_search(cache, reqs[0])
    assert got[1] == executor.execute_search(cache, reqs[1])


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_batched_scan_copies_hold_the_graded_rule(root, cache, rng, precision):
    targets = [rng.standard_normal((q, DIM)).astype(np.float32) for q in (1, 40, 30)]
    reqs = [_req(t, maxval=10, precision=precision) for t in targets]
    got = _batched_both(root, cache, reqs)
    for g, r in zip(got, reqs):
        assert_graded(g, executor.execute_search(cache, r))


def test_batched_filter_shares_one_overlay(root, cache, rng):
    filt = expr.field("tag") == 2
    reqs = [_req(rng.standard_normal((q, DIM)).astype(np.float32), filter=filt) for q in (1, 4)]
    before = METRICS.snapshot().get("filter.device_pushdown", 0)
    got = _batched_both(root, cache, reqs)
    assert METRICS.snapshot()["filter.device_pushdown"] == before + 1  # once for the batch
    for g, r in zip(got, reqs):
        assert (g.column("tag").to_numpy() == 2).all()
        assert g == executor.execute_search(cache, r)


def _concurrent(batcher, reqs, n_threads=None):
    """Submit every request from its own thread (or from ``n_threads``
    threads in turn); return the results in request order."""
    results: list = [None] * len(reqs)
    errors: list = []
    n_threads = n_threads or len(reqs)

    def worker(w):
        for i in range(w, len(reqs), n_threads):
            try:
                results[i] = batcher.submit(reqs[i])
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert not errors, errors
    return results


def test_batcher_concurrent_consistency(cache, rng):
    batcher = batching.SearchBatcher(cache)
    reqs = [_req(rng.standard_normal(DIM).astype(np.float32), maxval=4) for _ in range(12)]
    want = [executor.execute_search(cache, r) for r in reqs]
    before = METRICS.snapshot()
    results = _concurrent(batcher, reqs)
    after = METRICS.snapshot()
    assert after["batch.requests"] - before.get("batch.requests", 0) == 12
    assert after["batch.queries"] - before.get("batch.queries", 0) == 12
    dispatches = after["batch.dispatches"] - before.get("batch.dispatches", 0)
    assert 1 <= dispatches <= 12
    assert after["batch.drains"] - before.get("batch.drains", 0) >= dispatches  # one key
    for got, expect in zip(results, want):
        assert got == expect


def test_batcher_stress_keeps_every_answer_and_count(cache, rng, monkeypatch):
    """48 threads (more than the cores) with a short switch interval and
    three predicates: no lost update in the batch counters, every table
    equal to its solo one, fewer phase-1 calls than requests."""
    preds = [expr.field("tag") < 2, expr.field("tag") >= 1, None]
    reqs = [_req(rng.standard_normal(DIM).astype(np.float32), maxval=3, filter=preds[i % 3]) for i in range(96)]
    want = [executor.execute_search(cache, r) for r in reqs]
    batcher = batching.SearchBatcher(cache)
    calls = []
    real = executor.topk2.topk_two_phase

    def counted(*a, **kw):
        calls.append(a[1].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(executor.topk2, "topk_two_phase", counted)
    before = METRICS.snapshot()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results = _concurrent(batcher, reqs, n_threads=48)
    finally:
        sys.setswitchinterval(old)
    after = METRICS.snapshot()
    assert after["batch.requests"] - before.get("batch.requests", 0) == 96
    assert after["batch.dispatches"] - before.get("batch.dispatches", 0) == len(calls)
    assert sum(calls) == 96 and len(calls) < 96
    for got, expect in zip(results, want):
        assert got == expect


def test_batcher_routes_ineligible_solo(cache, rng):
    batcher = batching.SearchBatcher(cache)
    t = rng.standard_normal(DIM).astype(np.float32)
    before = METRICS.snapshot().get("batch.requests", 0)
    res = batcher.submit(_req(t, filter=expr.field("tag") == 2))  # batched, alone
    assert (np.asarray(res.column("tag")) == 2).all()
    assert METRICS.snapshot()["batch.requests"] == before + 1
    assert batcher.submit(_req(t, maxval=None)).num_rows == ROWS  # no maxval: solo
    windowed = batcher.submit(_req(t, extra={"window": 64}))  # a per-request knob: solo
    big = batcher.submit(_req(rng.standard_normal((3000, DIM)).astype(np.float32)))  # > max // 2: solo
    assert METRICS.snapshot()["batch.requests"] == before + 1
    assert windowed == executor.execute_search(cache, _req(t))
    assert big.num_rows == 3000 * 5
    for extra_req in (_req(t, maxval=None), _req(t, extra={"window": 64}), _req(t, metric=None)):
        assert not executor.batchable(extra_req)


def test_batcher_poisoned_batch_isolates_error(cache, rng):
    batcher = batching.SearchBatcher(cache)
    good = rng.standard_normal(DIM).astype(np.float32)
    bad = rng.standard_normal(DIM + 1).astype(np.float32)  # wrong dim
    reqs = [_req(good), _req(bad), _req(good)]
    items = [batching._Item(r, 1, executor.batch_key(r)) for r in reqs]
    batcher._dispatch(items)
    assert all(item.done.is_set() for item in items)
    assert items[0].result is not None and items[2].result is not None
    assert items[1].error is not None
    assert items[0].result == executor.execute_search(cache, reqs[0])


def test_batcher_invalid_metric_fails_on_caller_thread(cache, rng):
    batcher = batching.SearchBatcher(cache)
    t = rng.standard_normal(DIM).astype(np.float32)
    with pytest.raises(ValueError):
        batcher.submit(_req(t, metric="bogus"))
    assert batcher._thread is None  # the dispatcher never saw it
    assert batcher.submit(_req(t)).num_rows == 5


def test_batcher_pipeline_depth_finishes_each_batch(cache, rng, monkeypatch):
    """FENIX_PIPELINE_DEPTH > 0: a completion thread finishes batches while
    the dispatcher launches the next; every answer is still its own."""
    monkeypatch.setenv("FENIX_PIPELINE_DEPTH", "2")
    batcher = batching.SearchBatcher(cache)
    assert batcher.pipeline_depth == 2
    reqs = [_req(rng.standard_normal((1 + i % 3, DIM)).astype(np.float32), maxval=2 + i % 5,
                 metric=("l2", "cosine")[i % 2]) for i in range(24)]
    want = [executor.execute_search(cache, r) for r in reqs]
    results = _concurrent(batcher, reqs, n_threads=8)
    assert batcher._completer is not None and batcher._completer.is_alive()
    for got, expect in zip(results, want):
        assert got == expect


def test_service_routes_plain_searches_through_the_batcher(cache, rng):
    t = rng.standard_normal((2, DIM)).astype(np.float32)
    before = METRICS.snapshot().get("batch.requests", 0)
    config = {"source": "b/table", "column": "vector", "metric": "l2", "maxval": 4}
    got = service.run_search_config(cache, config, t)
    assert METRICS.snapshot()["batch.requests"] == before + 1
    assert batching.get_batcher(cache) is batching.get_batcher(cache)
    assert got == executor.execute_search(cache, _req(t, maxval=4))


def _ivf(root, name):
    coder.make(root, name, "b/table", "vector", IVF, seed=0, device="cpu")
    index.make(root, name, "b/table", "vector", device="cpu")


def test_batched_probed_matches_solo(root, cache, rng):
    _ivf(root, "b/ivf")
    targets = [rng.standard_normal((q, DIM)).astype(np.float32) for q in (1, 2, 1)]
    reqs = [_req(t, coding="b/ivf", probes=4, maxval=5) for t in targets]
    got = _batched_both(root, cache, reqs)
    for g, r in zip(got, reqs):
        assert g == executor.execute_search(cache, r)
    assert "__CODED_ID__" in got[0].column_names


@pytest.mark.parametrize("route", ["search.ivf_clustered", "search.ivf_scan"])
def test_batched_probed_route_is_chosen_over_the_stacked_batch(root, cache, rng, route):
    """The route rule reads the batch's padded query count: 2 queries stay
    on the clustered gather, 300 go to the masked scan, as a solo request
    of that size would."""
    _ivf(root, "b/ivf")
    q = 2 if route == "search.ivf_clustered" else 300
    reqs = [_req(rng.standard_normal((n, DIM)).astype(np.float32), coding="b/ivf", probes=2, maxval=5)
            for n in (q // 2, q - q // 2)]
    before = METRICS.snapshot().get(route, 0)
    got = _batched_both(root, cache, reqs)
    assert METRICS.snapshot()[route] == before + 1
    for g, r in zip(got, reqs):
        assert g.column("id").equals(executor.execute_search(cache, r).column("id"))


def test_batcher_concurrent_probed(root, cache, rng):
    _ivf(root, "c/ivf")
    batcher = batching.SearchBatcher(cache)
    reqs = [_req(rng.standard_normal(DIM).astype(np.float32), coding="c/ivf", probes=4, maxval=4)
            for _ in range(8)]
    want = [executor.execute_search(cache, r) for r in reqs]
    for got, expect in zip(_concurrent(batcher, reqs), want):
        assert got == expect


@pytest.mark.parametrize("mode", ["int8", "stream"])
def test_batched_host_corpus_modes(root, cache, rng, mode):
    """Host-corpus residency: one host-corpus route call over the batch's
    stacked queries, each member's table equal to its solo one and to the
    JAX package's batched answer."""
    reqs = [_req(rng.standard_normal((q, DIM)).astype(np.float32), maxval=6, residency=mode)
            for q in (1, 3)]
    got = _batched_both(root, cache, reqs)
    for g, r in zip(got, reqs):
        assert g == executor.execute_search(cache, r)
