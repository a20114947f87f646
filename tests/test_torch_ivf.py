"""fenix_tpu_torch's IVF slice (distance, cells, kmeans, the probed ops of
topk2, the executor's routes, coders and indexes on disk) against the JAX
package's on the same numpy inputs, on the CPU.

Tolerances: pairwise distances and Lloyd steps rtol 1e-5 (the two
packages sum fp32 products in different orders; no assignment flips at
these sizes, which the tests check); cell assignments and rankings equal,
constructed ties included; phase-1 probed maxima rtol 1e-5 for fp32,
1e-6 for int8 (exact integer sums, only the epilogue's rounding may
differ) and 2⁻⁷ of the largest |score| for bf16 (bf16 scores); search ids
exact and distances within 1e-5. Through the executor an l2 distance is
held to float64 instead (within 1e-5): the port returns ``‖q − v‖`` of
each winner, where the JAX package's ``sqrt(‖q‖² − s)`` cancels for near
rows (1.2e-4 off at a distance of 0.04 here).
"""

import os

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from fenix_tpu import coder as jcoder
from fenix_tpu import expr as jexpr
from fenix_tpu import index as jindex
from fenix_tpu.engine import executor as jexecutor
from fenix_tpu.engine.session import DeviceCache as JaxCache
from fenix_tpu.ops import cells as jcells
from fenix_tpu.ops import distance as jdistance
from fenix_tpu.ops import kmeans as jkmeans
from fenix_tpu.ops import topk2 as jtopk2
from fenix_tpu_torch import coder, expr, index
from fenix_tpu_torch.engine import executor
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import batch, ingest, table
from fenix_tpu_torch.ops import cells, distance, kmeans, topk2
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

torch.set_num_threads(2)

METRICS_ALL = ["l2", "cosine", "dot"]


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(np.array(x))


# -- ops/distance.py -----------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "euclidean", "cosine", "dot", "inner_product"])
def test_pairwise_and_all_distances_match_jax(rng, metric):
    u = rng.standard_normal((9, 24)).astype(np.float32)
    v = rng.standard_normal((70, 24)).astype(np.float32)
    want = np.asarray(jdistance.pairwise_distance(j(u), j(v), metric))
    np.testing.assert_allclose(distance.pairwise_distance(t(u), t(v), metric).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(distance.all_distances(t(v), t(u), metric).numpy(),
                               np.asarray(jdistance.all_distances(j(v), j(u), metric)),
                               rtol=1e-5, atol=1e-5)


def test_pairwise_distance_batches_leading_axes(rng):
    u = rng.standard_normal((3, 5, 8)).astype(np.float32)
    v = rng.standard_normal((3, 7, 8)).astype(np.float32)
    got = distance.pairwise_distance(t(u), t(v), "l2").numpy()
    for b in range(3):  # a batched product may sum in another order: ulps
        np.testing.assert_allclose(got[b], distance.pairwise_distance(t(u[b]), t(v[b]), "l2").numpy(),
                                   rtol=1e-6)


# -- ops/cells.py --------------------------------------------------------------


def codebooks_for(rng, n, k=6, d=16):
    return rng.standard_normal((n, k, d)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("metric", METRICS_ALL)
def test_cells_match_jax(rng, metric, n):
    cb = codebooks_for(rng, n)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    np.testing.assert_allclose(
        cells.codebook_distances(t(x), t(cb), metric).numpy(),
        np.asarray(jcells.codebook_distances(j(x), j(cb), metric)), rtol=1e-5, atol=1e-5,
    )
    want_assign = np.asarray(jcells.assign_cells(j(x), j(cb), metric=metric))
    got_assign = cells.assign_cells(t(x), t(cb), metric)
    assert got_assign.dtype == torch.int32
    np.testing.assert_array_equal(got_assign.numpy(), want_assign)
    np.testing.assert_array_equal(cells.assign_cells_np(x, cb, metric),
                                  jcells.assign_cells_np(x, cb, metric))
    m = min(5, 6**n)
    want_top = np.asarray(jcells.topk_cells(j(x[:20]), j(cb), metric=metric, maxval=m))
    np.testing.assert_array_equal(cells.topk_cells(t(x[:20]), t(cb), metric, m).numpy(), want_top)
    np.testing.assert_array_equal(cells.topk_cells_np(x[:20], cb, metric, m),
                                  jcells.topk_cells_np(x[:20], cb, metric, m))
    np.testing.assert_array_equal(cells.all_cell_ranks(t(x[:20]), t(cb), metric).numpy(),
                                  np.asarray(jcells.all_cell_ranks(j(x[:20]), j(cb), metric=metric)))
    # the bounded beam: equal to the JAX package's and to dense enumeration
    got_b = cells.topk_cells_bounded(t(x[:20]), t(cb), metric, m).numpy()
    np.testing.assert_array_equal(
        got_b, np.asarray(jcells.topk_cells_bounded(j(x[:20]), j(cb), metric, m)))
    np.testing.assert_array_equal(got_b, want_top)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_cells_tie_rule_with_duplicate_centroids(rng, n):
    """Exactly equal centroids tie every distance: assignment takes the
    first, ranking the earliest composite id, as the JAX package's."""
    cb = codebooks_for(rng, n, k=4, d=8)
    cb[:, 2] = cb[:, 1]  # centroid 2 duplicates centroid 1 in every codebook
    x = np.concatenate([cb[0, 1:2].repeat(5, 0), rng.standard_normal((40, 8)).astype(np.float32)])
    got = cells.assign_cells(t(x), t(cb), "l2").numpy()
    np.testing.assert_array_equal(got, np.asarray(jcells.assign_cells(j(x), j(cb), metric="l2")))
    assert not np.isin((got[:, None] // 4 ** np.arange(n)) % 4, 2).any()  # digit 2 never wins
    ranks = cells.topk_cells(t(x), t(cb), "l2", 4**n).numpy()
    np.testing.assert_array_equal(
        ranks, np.asarray(jcells.topk_cells(j(x), j(cb), metric="l2", maxval=4**n)))
    np.testing.assert_array_equal(cells.topk_cells_np(x, cb, "l2", 4**n), ranks)


def test_topk_cells_bounded_matches_dense_enumeration(rng):
    cb = codebooks_for(rng, 3, k=8, d=12)
    x = rng.standard_normal((30, 12)).astype(np.float32)
    scores = cells._enumerate_cell_scores(cells.codebook_distances(t(x), t(cb), "cosine")).numpy()
    dense = np.argsort(scores, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(cells.topk_cells_bounded(t(x), t(cb), "cosine", 10).numpy(), dense)


GRIDS = [(1, 4096), (2, 64)]  # (codebooks, cells a codebook): glove's grid and a composite one


def _chunks_of_3(monkeypatch, n, k):
    """``topk_cells`` ranks 3 queries a chunk."""
    monkeypatch.setattr(cells, "RANK_CHUNK_CELLS", 3 * k**n)


def _f64_cell_distances(x, cb, metric):
    """[Q, k^n] float64 distances of the composite cells (sums over codebooks)."""
    x64, cb64 = x.astype(np.float64), cb.astype(np.float64)
    if metric == "cosine":
        x64 = x64 / np.linalg.norm(x64, axis=-1, keepdims=True)
        cb64 = cb64 / np.linalg.norm(cb64, axis=-1, keepdims=True)
    if metric == "l2":
        per = np.sqrt(((x64[:, None, None, :] - cb64[None]) ** 2).sum(-1))
    elif metric == "cosine":
        per = 0.5 - 0.5 * np.einsum("qd,nkd->qnk", x64, cb64)
    else:
        per = -np.einsum("qd,nkd->qnk", x64, cb64)
    out = per[:, 0, :]
    for j in range(1, cb.shape[0]):
        out = (out[:, :, None] + per[:, j, None, :]).reshape(x.shape[0], -1)
    return out


@pytest.mark.parametrize("n,k", GRIDS, ids=["1x4096", "2x64"])
@pytest.mark.parametrize("metric", METRICS_ALL)
def test_device_ranking_matches_host_ranking(rng, monkeypatch, metric, n, k):
    """The card's ranking (``topk_cells``), run here on CPU tensors over
    queries in chunks of 3, gives the JAX package's ids (its numpy
    ranking) wherever no two cells near the first ``probes`` lie within
    1e-5 in float64."""
    cb = codebooks_for(rng, n, k=k, d=16)
    probes = 8
    x = rng.standard_normal((200, 16)).astype(np.float32)
    d64 = np.sort(_f64_cell_distances(x, cb, metric), axis=1)[:, : probes + 1]
    x = x[(np.diff(d64, axis=1) > 1e-5).all(axis=1)][:10]  # no near ties, 10 queries: 4 chunks
    assert x.shape[0] == 10
    _chunks_of_3(monkeypatch, n, k)
    got = cells.topk_cells(t(x), t(cb), metric, probes)
    assert got.dtype == torch.int32 and got.shape == (10, probes)
    np.testing.assert_array_equal(got.numpy(), jcells.topk_cells_np(x, cb, metric, probes))


@pytest.mark.parametrize("n,k", GRIDS, ids=["1x4096", "2x64"])
@pytest.mark.parametrize("metric", METRICS_ALL)
def test_device_ranking_keeps_the_smallest_id_on_ties(rng, monkeypatch, metric, n, k):
    """Duplicated codebook rows tie every composite cell with its twin: the
    card's ranking puts the smaller id first, and never takes a twin
    without the smaller one."""
    cb = codebooks_for(rng, n, k=k, d=16)
    cb[-1, k // 2 :] = cb[-1, : k // 2]  # the last codebook's second half repeats its first
    x = rng.standard_normal((10, 16)).astype(np.float32)
    probes = 12
    _chunks_of_3(monkeypatch, n, k)
    got = cells.topk_cells(t(x), t(cb), metric, probes).numpy()
    digit = got % k
    twin = np.where(digit >= k // 2, got - k // 2, -1)  # the smaller twin of an upper-half cell
    for qi in range(x.shape[0]):
        pos = {c: r for r, c in enumerate(got[qi])}
        for r, tw in enumerate(twin[qi]):
            if tw >= 0:
                assert pos.get(tw, probes) < r, (qi, got[qi])
    assert (twin >= 0).any()


@pytest.mark.parametrize("n,k", GRIDS, ids=["1x4096", "2x64"])
@pytest.mark.parametrize("metric", METRICS_ALL)
def test_rank_cells_on_a_cpu_device_is_the_host_ranking(tmp_path, rng, metric, n, k):
    """On a CPU device the executor ranks on the host, bit for bit the JAX
    package's numpy ranking; its tensor is that array, and the card's
    counter stays."""
    cb = codebooks_for(rng, n, k=k, d=16)
    config = {"metric": metric, "codebook_size": k, "num_codebooks": n, "batch_size": 256, "num_epochs": 1}
    coder._persist(str(tmp_path), "c", config, pa.list_(pa.float32(), 16), cb)
    cache = DeviceCache(str(tmp_path), device="cpu")
    x = rng.standard_normal((10, 16)).astype(np.float32)
    before = METRICS.snapshot().get("ivf.rank_device", 0)
    host, dev = executor._rank_cells(cache, "c", x, metric, 8)
    np.testing.assert_array_equal(host, jcells.topk_cells_np(x, cb, metric, 8))
    assert host.dtype == np.int32 and dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(), host)
    assert METRICS.snapshot().get("ivf.rank_device", 0) == before


def test_check_cell_space_refuses_past_int32():
    cells.check_cell_space(2**15, 2)
    with pytest.raises(ValueError, match="int32"):
        cells.check_cell_space(2**16, 2)


# -- ops/kmeans.py --------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS_ALL)
def test_lloyd_step_single_matches_jax(rng, metric):
    c = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal((200, 16)).astype(np.float32)
    want = np.asarray(jkmeans.lloyd_step_single(j(c), j(b), metric))
    np.testing.assert_allclose(kmeans.lloyd_step_single(t(c), t(b), metric).numpy(), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("metric", METRICS_ALL)
def test_lloyd_step_matches_jax(rng, metric, n):
    c = rng.standard_normal((n, 8, 16)).astype(np.float32)
    b = rng.standard_normal((n, 150, 16)).astype(np.float32)
    got, assign = kmeans.lloyd_step_assign(t(c), t(b), metric)
    want = np.asarray(jkmeans.lloyd_step(j(c), j(b), metric))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(kmeans.lloyd_step(t(c), t(b), metric).numpy(), got.numpy())
    assert assign.shape == (n, 150)


def _numpy_lloyd(cbs, sample, metric):
    """A per-step float64 oracle of one Lloyd step per codebook."""
    out = []
    for c, x in zip(cbs.astype(np.float64), sample.astype(np.float64)):
        if metric == "cosine":
            c = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-12)
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        if metric == "l2":
            dist = ((x[:, None, :] - c[None]) ** 2).sum(-1)
        elif metric == "cosine":
            dist = -(x @ c.T)
        else:
            dist = -(x @ c.T)
        a = dist.argmin(1)
        sums = np.zeros_like(c)
        np.add.at(sums, a, x)
        new = (c + sums) / (1 + np.bincount(a, minlength=c.shape[0]))[:, None]
        if metric == "cosine":
            new = new / np.maximum(np.linalg.norm(new, axis=1, keepdims=True), 1e-12)
        out.append(new)
    return np.stack(out)


@pytest.mark.parametrize("metric", METRICS_ALL)
def test_train_matches_per_step_oracle(rng, metric):
    corpus = rng.standard_normal((1000, 8)).astype(np.float32)
    corpus[:500] += 3.0
    cfg = dict(num_codebooks=2, codebook_size=4, batch_size=96, num_epochs=2)
    got = kmeans.train(t(corpus), 7, metric=metric, **cfg).numpy()
    init, epochs = kmeans.draw_indices(1000, 7, 2, 4, 96, 2)
    assert [e.shape for e in epochs] == [(5, 2, 96)] * 2  # 1000 // 192 steps, the rest dropped
    want = corpus[init.numpy()].reshape(2, 4, 8).astype(np.float64)
    for idx in epochs:
        for step in idx.numpy():
            want = _numpy_lloyd(want, corpus[step], metric)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the same seed draws the same rows: training is reproducible
    np.testing.assert_array_equal(kmeans.train(t(corpus), 7, metric=metric, **cfg).numpy(), got)


def test_train_with_fewer_rows_than_a_step(rng):
    corpus = rng.standard_normal((100, 4)).astype(np.float32)
    got = kmeans.train(t(corpus), 3, num_codebooks=2, codebook_size=5, batch_size=64,
                       num_epochs=3, metric="l2")
    init, epochs = kmeans.draw_indices(100, 3, 2, 5, 64, 3)
    assert all(e.shape[0] == 0 for e in epochs)  # 100 // 128 = 0 steps
    np.testing.assert_array_equal(got.numpy(), corpus[init.numpy()].reshape(2, 5, 4))
    with pytest.raises(ValueError, match="initial centroids"):
        kmeans.draw_indices(100, 3, 2, 51, 64, 1)


def test_random_batch_iterator_is_the_reference(tmp_path, rng):
    from fenix_tpu.io import batch as jbatch

    root = str(tmp_path)
    x = rng.standard_normal((103, 4)).astype(np.float32)
    table.make(root, "t", pa.table({"v": ingest.numpy_to_fixed_size_list(x, pa.float32())}).to_reader())
    got = [*batch.RandomBatchIterator(root, "t", 10, "v", seed=4)]
    want = [*jbatch.RandomBatchIterator(root, "t", 10, "v", seed=4)]
    assert len(got) == 10
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- ops/topk2.py: the probed ops ---------------------------------------------


def probed_inputs(rng, n=4096, d=32, q=6, n_cells=24, p=5):
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    coded = rng.integers(0, n_cells, n).astype(np.int32)
    coded[-100:] = -1  # padding rows
    cells_q = np.stack([rng.choice(n_cells, p, replace=False) for _ in range(q)]).astype(np.int32)
    cells_q[0, -1] = -1  # a padded probe slot
    return corpus, queries, coded, cells_q


@pytest.mark.parametrize("table_route", [True, False], ids=["table", "sorted"])
@pytest.mark.parametrize("scan", ["fp32", "bf16", "int8"])
def test_bucket_scores_scan_probed_matches_jax(rng, monkeypatch, scan, table_route):
    if not table_route:
        monkeypatch.setattr(topk2, "_PROBE_TABLE_CAP", 0)
    corpus, queries, coded, cells_q = probed_inputs(rng)
    mul, add = (np.array(a) for a in jtopk2.prepare_aux(j(corpus), None, "l2"))
    add[rng.random(add.shape[0]) < 0.1] = -np.inf
    add[coded < 0] = -np.inf  # padding rows, as the cache's aux has them
    qp = 2.0 * queries
    bucket = 32
    if scan == "int8":
        v8, sv = (np.asarray(a) for a in jtopk2.quantize_corpus_int8(j(corpus)))
        q8, inv_sq = (np.asarray(a) for a in jtopk2.quantize_queries_int8(j(qp)))
        want = jtopk2.bucket_scores_scan_probed(j(q8), j(v8), j(mul * sv), j(add), j(coded),
                                                j(cells_q), bucket=bucket, inv_sq=j(inv_sq))
        got = topk2.bucket_scores_scan_probed(t(q8), t(v8), t(mul * sv), t(add), t(coded),
                                              t(cells_q), bucket, inv_sq=t(inv_sq))
        # the sums are exact; the epilogue's two terms may each round
        # (or fuse) apart, so 1e-6 of their magnitude
        fin_add = np.abs(add[np.isfinite(add)]).max()
        terms = 127.0 * np.abs(q8.astype(np.float32)).sum(1) * (mul * sv).max() + fin_add * inv_sq
        tol = dict(rtol=0, atol=1e-6 * terms.max())
    elif scan == "bf16":
        want = jtopk2.bucket_scores_scan_probed(j(qp).astype(jnp.bfloat16), j(corpus).astype(jnp.bfloat16),
                                                j(mul), j(add), j(coded), j(cells_q), bucket=bucket)
        got = topk2.bucket_scores_scan_probed(t(qp).bfloat16(), t(corpus).bfloat16(), t(mul), t(add),
                                              t(coded), t(cells_q), bucket)
        want_np = np.asarray(want)
        tol = dict(rtol=0, atol=2.0**-7 * float(np.abs(want_np[np.isfinite(want_np)]).max()))
    else:
        want = jtopk2.bucket_scores_scan_probed(j(qp), j(corpus), j(mul), j(add), j(coded),
                                                j(cells_q), bucket=bucket)
        got = topk2.bucket_scores_scan_probed(t(qp), t(corpus), t(mul), t(add), t(coded), t(cells_q), bucket)
        tol = dict(rtol=1e-5, atol=1e-4)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isfinite(got).any() and np.isneginf(got).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


def test_int8_products_are_exact_integer_sums(rng):
    for d in (16, 1100):  # one f32 product; 1024-wide slices summed in int32
        q8 = rng.integers(-127, 128, (3, d)).astype(np.int8)
        v8 = rng.integers(-127, 128, (50, d)).astype(np.int8)
        want = q8.astype(np.int64) @ v8.astype(np.int64).T
        got = topk2._int8_products(t(q8), t(v8)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.float32))


def _probed_state(rng, n=8192, d=32, q=5, filtered=False):
    corpus, queries, coded, cells_q = probed_inputs(rng, n=n, d=d, q=q)
    corpus[4000:4050] = corpus[100:150]  # exact duplicates: ties across cells
    coded[4000:4050] = coded[100:150]
    # padding rows score −inf, as in the cache's aux (the JAX package's
    # membership test lets a −1 probe slot match a −1 code)
    mask = (coded >= 0) & ((rng.random(n) < 0.6) if filtered else True)
    queries[1] = corpus[120] + 0.01  # near a duplicated row
    return corpus, queries, coded, cells_q, mask


@pytest.mark.parametrize("scan", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_two_phase_probed_matches_jax(rng, metric, scan):
    corpus, queries, coded, cells_q, mask = _probed_state(rng, filtered=metric == "l2")
    mul, add = jtopk2.prepare_aux(j(corpus), j(mask), metric)
    kw, tkw = {}, {}
    if scan == "bf16":
        kw["corpus_scan"] = j(corpus).astype(jnp.bfloat16)
        tkw["corpus_scan"] = t(corpus).bfloat16()
    elif scan == "int8":
        v8, sv = jtopk2.quantize_corpus_int8(j(corpus))
        kw["corpus_scan_int8"] = (v8, sv)
        tkw["corpus_scan_int8"] = (t(v8), t(sv))
    wd, wi = jtopk2.topk_two_phase_probed(j(corpus), j(queries), mul, add, j(coded), j(cells_q),
                                          k=16, metric=metric, **kw)
    gd, gi = topk2.topk_two_phase_probed(t(corpus), t(queries), t(mul), t(add), t(coded),
                                         t(cells_q), k=16, metric=metric, **tkw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)
    for qi, row in enumerate(gi.numpy()):  # only probed rows come back
        assert np.isin(coded[row[row >= 0]], cells_q[qi]).all() and (row >= 0).any()


def _clustered_inputs(corpus, coded, cells_q, bucket, mask=None):
    """The clustered layout (rows sorted by cell, padding last) and the
    bucket lists, as session.clustered and the executor build them."""
    n_cells = int(coded.max()) + 1
    keys = np.where(coded >= 0, coded, np.iinfo(np.int32).max)
    perm = np.argsort(keys, kind="stable")
    offsets = np.searchsorted(keys[perm], np.arange(n_cells + 1))
    rows = int((coded >= 0).sum())
    orig = np.where(perm < rows, perm, -1).astype(np.int32)
    lists = executor._ivf_bucket_lists(cells_q, offsets, bucket, corpus.shape[0] // bucket)
    valid = np.arange(corpus.shape[0]) < rows
    if mask is not None:
        valid &= mask
    return corpus[perm], coded[perm], orig, valid[perm], lists


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("filtered", [False, True])
def test_ivf_clustered_matches_jax_and_the_masked_scan(rng, metric, filtered):
    corpus, queries, coded, cells_q, mask = _probed_state(rng, filtered=filtered)
    coded[-100:] = -1  # the padding rows sit at the tail, as the layout has them
    bucket = topk2.bucket_for(queries.shape[0], corpus.shape[0])
    corpus_s, coded_s, orig, valid_s, lists = _clustered_inputs(corpus, coded, cells_q, bucket, mask)
    mul_s, add_s = jtopk2.prepare_aux(j(corpus_s), j(valid_s), metric)
    wd, wi = jtopk2.topk_ivf_clustered(j(corpus_s), j(queries), mul_s, add_s, j(coded_s), j(orig),
                                       j(cells_q), j(lists), k=16, metric=metric)
    gd, gi = topk2.topk_ivf_clustered(t(corpus_s), t(queries), t(mul_s), t(add_s), t(coded_s),
                                      t(orig), t(cells_q), t(lists), k=16, metric=metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)
    # the masked scan over the unsorted rows answers the same
    valid = np.arange(corpus.shape[0]) < int((coded >= 0).sum())
    if mask is not None:
        valid &= mask
    mul, add = topk2.prepare_aux(t(corpus), t(valid), metric)
    sd, si = topk2.topk_two_phase_probed(t(corpus), t(queries), mul, add, t(coded), t(cells_q),
                                         k=16, metric=metric)
    np.testing.assert_array_equal(gi.numpy(), si.numpy())
    np.testing.assert_allclose(gd.numpy(), sd.numpy(), rtol=1e-6, atol=1e-6)


def test_topk_values_min_id_breaks_cross_cell_ties_by_id(rng):
    s = rng.standard_normal((4, 64)).astype(np.float32)
    ids = np.stack([rng.permutation(1000)[:64] for _ in range(4)]).astype(np.int32)
    s[:, 10] = s[:, 40] = s[:, 50] = 9.0  # three-way tie at the top, ids in any order
    s[1, 5] = -np.inf
    ids[2, 7] = -1
    s[2, 7] = 9.0  # a tied padding slot is never picked by id
    ids[3] = 5  # every id equal
    got_v, got_i = topk2.topk_values_min_id(t(s), t(ids), 6)
    want_v, want_i = jtopk2.topk_values_min_id(j(s), j(ids), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    top3 = np.sort(ids[0, [10, 40, 50]])
    np.testing.assert_array_equal(got_i.numpy()[0, :3], top3)


# -- the executor's IVF routes ------------------------------------------------


def test_ivf_bucket_lists_match_jax(rng):
    counts = rng.integers(0, 300, 40)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    n_pad = -(-int(offsets[-1]) // 1024) * 1024
    cells_q = np.stack([rng.choice(40, 7, replace=False) for _ in range(9)]).astype(np.int32)
    cells_q[3, 2:] = -1
    for bucket in (32, 128):
        want = jexecutor._ivf_bucket_lists(cells_q, offsets, bucket, n_pad // bucket)
        got = executor._ivf_bucket_lists(cells_q, offsets, bucket, n_pad // bucket)
        np.testing.assert_array_equal(got, want)
    assert [executor._canonical_q(q) for q in (1, 2, 9, 64, 65, 300, 1025)] == [
        jexecutor._canonical_q(q) for q in (1, 2, 9, 64, 65, 300, 1025)]


ROWS, DIM = 6000, 16
CONFIG = {"metric": "l2", "codebook_size": 16, "num_codebooks": 1, "batch_size": 256, "num_epochs": 2}


def make_items(rng, n=ROWS, offset=0):
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    x[: n // 2] += 2.0
    x[n // 2 + 7 : n // 2 + 27] = x[7:27]  # exact duplicate rows
    return pa.table({
        "id": pa.array(np.arange(offset, offset + n, dtype=np.int64)),
        "vector": ingest.numpy_to_fixed_size_list(x, pa.float32()),
        "tag": pa.array(rng.integers(0, 4, n).astype(np.int32)),
    })


@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    """A root whose coders and indexes the JAX package trained and built:
    one single-source coder and one multi-source coder (2 codebooks)."""
    rng = np.random.default_rng(11)
    root = str(tmp_path_factory.mktemp("jax_built"))
    table.make(root, "items", make_items(rng).to_reader(max_chunksize=1000))
    table.make(root, "more", make_items(rng, n=2500, offset=ROWS).to_reader())
    jcoder.make(root, "ivf", "items", "vector", CONFIG, seed=0)
    jindex.make(root, "ivf", "items", "vector")
    cfg2 = {**CONFIG, "metric": "cosine", "codebook_size": 4, "num_codebooks": 2}
    jcoder.make(root, "multi", ["items", "more"], "vector", cfg2, seed=1)
    for s in ("items", "more"):
        jindex.make(root, "multi", s, "vector")
    return root


def _both(root, req_kw, jax_cache=None):
    got = executor.execute_search(DeviceCache(root, device="cpu"), executor.SearchRequest(**req_kw))
    jkw = dict(req_kw)
    if jkw.get("filter") is not None:
        jkw["filter"] = jexpr.Expr.from_dict(jkw["filter"].to_dict())
    want = jexecutor.execute_search(jax_cache or JaxCache(root, mesh=None), jexecutor.SearchRequest(**jkw))
    return got, want


def assert_tables_match(got: pa.Table, want: pa.Table, l2_rows=None, target=None) -> None:
    """Equal column by column, ``__DISTANCE__`` within 1e-5; for l2
    (``l2_rows``: the searched vectors) against float64 ‖q − v‖."""
    assert got.schema == want.schema
    for name in want.column_names:
        if name != "__DISTANCE__":
            assert got.column(name).equals(want.column(name)), name
        elif l2_rows is None:
            np.testing.assert_allclose(got.column(name).to_numpy(), want.column(name).to_numpy(),
                                       rtol=1e-5, atol=1e-5)
    if l2_rows is not None:
        q = np.atleast_2d(target).astype(np.float64)
        qid = got.column("__QUERY_ID__").to_numpy() if "__QUERY_ID__" in got.column_names else 0
        rows = got.column("id").to_numpy()  # ids are row numbers in these tables
        exact = np.linalg.norm(l2_rows[rows].astype(np.float64) - q[qid], axis=1)
        np.testing.assert_allclose(got.column("__DISTANCE__").to_numpy(), exact, rtol=1e-5, atol=1e-5)


def _route_counts():
    snap = METRICS.snapshot()
    return snap.get("search.ivf_clustered", 0), snap.get("search.ivf_scan", 0)


PROBED = [
    # q, probes, precision, filtered, route
    (1, 3, "fp32", False, "clustered"),
    (1, 4, "fp32", True, "clustered"),  # the filter mask goes through perm
    (1, 2, "int8", True, "clustered"),  # the gather rescores fp32: nothing to quantize
    (8, 4, "fp32", True, "scan"),  # 8 x 32 buckets x 128 rows > 16,384 rows
    (3, 5, "int8", False, "scan"),
    (70, 6, "fp32", True, "scan"),
    (70, 6, "bf16", False, "scan"),
    (70, 6, "int8", True, "scan"),
]


@pytest.mark.parametrize("q,probes,precision,filtered,route", PROBED)
def test_port_serves_a_jax_built_index(jax_built, q, probes, precision, filtered, route):
    """The JAX package trained and indexed; the port serves probed
    searches on both routes (the same route the JAX package takes at the
    same n_pad), metric from the coder, and answers with its ids."""
    rng = np.random.default_rng(q + probes)
    target = rng.standard_normal((q, DIM)).astype(np.float32)
    target[0] = table.load(jax_built, "items").column("vector")[9].values.to_numpy() + 0.01
    kw = dict(source="items", column="vector", target=target[0] if q == 1 else target, maxval=9,
              coding="ivf", probes=probes, precision=precision,
              filter=(expr.field("tag") < 2) if filtered else None)
    before = _route_counts()
    jroutes = []
    real_ivf, real_scan = jexecutor._search_ivf_packed, jexecutor._search_probed_packed
    try:
        jexecutor._search_ivf_packed = lambda *a, **k: jroutes.append("clustered") or real_ivf(*a, **k)
        jexecutor._search_probed_packed = lambda *a, **k: jroutes.append("scan") or real_scan(*a, **k)
        got, want = _both(jax_built, kw)
    finally:
        jexecutor._search_ivf_packed, jexecutor._search_probed_packed = real_ivf, real_scan
    after = _route_counts()
    assert jroutes == [route]
    assert (after[0] - before[0], after[1] - before[1]) == ((1, 0) if route == "clustered" else (0, 1))
    assert "__CODED_ID__" in got.column_names and got.num_rows == q * 9
    vectors = ingest.fixed_size_list_to_numpy(table.load(jax_built, "items").column("vector"))
    assert_tables_match(got, want, l2_rows=vectors, target=target)


@pytest.mark.parametrize("q,probes", [(2, 3), (100, 5)], ids=["clustered", "scan"])
def test_multi_source_probed_matches_jax(jax_built, q, probes):
    rng = np.random.default_rng(q)
    target = rng.standard_normal((q, DIM)).astype(np.float32)
    got, want = _both(jax_built, dict(source=["items", "more"], column="vector", target=target,
                                      maxval=6, coding="multi", probes=probes, select=["id", "tag"]))
    assert got.num_rows == q * 6
    assert_tables_match(got, want)


def test_port_built_index_serves_through_jax(tmp_path):
    """The port trained and indexed; the JAX package reads its coder and
    index files and its searches return the port's ids."""
    rng = np.random.default_rng(5)
    root = str(tmp_path)
    table.make(root, "items", make_items(rng).to_reader())
    coding = coder.make(root, "ivf", "items", "vector", CONFIG, seed=3, device="cpu")
    built = index.make(root, "ivf", "items", "vector", device="cpu")
    jc = jcoder.load(root, "ivf")
    np.testing.assert_array_equal(jc["tensor"], coding["tensor"])
    assert jc["config"] == CONFIG and jc["column"] == coding["column"]
    jloaded = jindex.load(root, "ivf", "items", "vector")
    assert jloaded.equals(built) and jloaded.equals(index.load(root, "ivf", "items", "vector"))
    # the JAX package assigns the same cells to the port's codebooks
    vecs = ingest.fixed_size_list_to_numpy(built.column("vector"))
    np.testing.assert_array_equal(built.column("__CODED_ID__").to_numpy(),
                                  np.asarray(jcells.assign_cells(j(vecs), j(jc["tensor"]), metric="l2")))
    target = rng.standard_normal((5, DIM)).astype(np.float32)
    for probes in (2, 6):
        got, want = _both(root, dict(source="items", column="vector", target=target, maxval=7,
                                     coding="ivf", probes=probes, filter=expr.field("tag") != 1))
        assert_tables_match(got, want, l2_rows=vecs, target=target)
    assert [*coder.list(root)] == [*jcoder.list(root)] == ["ivf"]
    cells_port = coder.call(target, coding, maxval=4, device="cpu")
    np.testing.assert_array_equal(cells_port, jcoder.call(target, jc, maxval=4))
    assert coder.call(target[0], coding, device="cpu").shape == (16,)


def test_coder_make_trains_the_same_coder_on_cpu_every_time(tmp_path, rng):
    root = str(tmp_path)
    table.make(root, "items", make_items(rng, n=2000).to_reader())
    a = coder.make(root, "a", "items", "vector", CONFIG, seed=9, device="cpu")["tensor"]
    b = coder.make(root, "b", "items", "vector", CONFIG, seed=9, device="cpu")["tensor"]
    np.testing.assert_array_equal(a, b)
    corpus = torch.from_numpy(ingest.fixed_size_list_to_numpy(table.load(root, "items").column("vector")))
    np.testing.assert_array_equal(
        a, kmeans.train(corpus, 9, num_codebooks=1, codebook_size=16, batch_size=256, num_epochs=2,
                        metric="l2").numpy())
    np.testing.assert_allclose(
        coder.distance(a[0, :3], a[0, 3:], "l2", device="cpu"),
        np.asarray(jcoder.distance(a[0, :3], a[0, 3:], "l2")),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["host", "device"])
def test_assignment_routes_agree(tmp_path, rng, monkeypatch, route):
    root = str(tmp_path)
    table.make(root, "items", make_items(rng, n=70_000 // 10).to_reader(max_chunksize=999))
    coder.make(root, "ivf", "items", "vector", {**CONFIG, "metric": "cosine"}, seed=1, device="cpu")
    monkeypatch.setattr(index, "ASSIGN_BLOCK", 1024)  # several blocks and a ragged tail
    monkeypatch.setenv("FENIX_ASSIGN", route)
    before = METRICS.snapshot().get("index.host_assigns", 0)
    codes = index.make(root, "ivf", "items", "vector", device="cpu").column("__CODED_ID__").to_numpy()
    assert METRICS.snapshot().get("index.host_assigns", 0) - before == (route == "host")
    jcodes = jindex._assign_codes(root, "ivf", table.load(root, "items").column("vector"))
    np.testing.assert_array_equal(codes, jcodes)
    monkeypatch.setenv("FENIX_ASSIGN", "gpu")
    with pytest.raises(ValueError, match="FENIX_ASSIGN"):
        index.make(root, "ivf", "items", "vector", device="cpu")


def test_clustered_layout_and_revisions(tmp_path, rng):
    """clustered_meta sorts rows by cell (ascending id inside a cell,
    padding last); the permuted copy counts in device_bytes; a rebuilt
    index is a new revision of every entry derived from it."""
    root = str(tmp_path)
    table.make(root, "items", make_items(rng, n=3000).to_reader())
    coder.make(root, "ivf", "items", "vector", CONFIG, seed=2, device="cpu")
    index.make(root, "ivf", "items", "vector", device="cpu")
    cache = DeviceCache(root, device="cpu")
    perm, offsets = cache.clustered_meta("ivf", "items", "vector")
    coded = cache.coded_ids("ivf", "items", "vector")
    assert coded.rows == 3000 and coded.rows_padded == 16384 and (coded.data[3000:] == -1).all()
    assert (perm[3000:] >= 3000).all() and offsets[-1] == 3000 and len(offsets) == 17
    keys = coded.data.numpy()[perm[:3000]]
    assert (np.diff(keys) >= 0).all()
    same_cell = np.diff(keys) == 0
    assert (np.diff(perm[:3000])[same_cell] > 0).all()
    cache.matrix("items", "vector")
    base = cache.device_bytes()
    corpus_s, coded_s, orig = cache.clustered("ivf", "items", "vector")
    # the permuted copy, its cell ids and the original row ids
    assert cache.device_bytes() == base + 16384 * DIM * 4 + 2 * 16384 * 4
    np.testing.assert_array_equal(orig.data.numpy()[:3000], perm[:3000])
    stamp = cache.snapshot_stamp("items", "vector", "ivf")
    os.utime(index.path_of(root, "ivf", "items", "vector"), ns=(1, 1))
    assert cache.snapshot_stamp("items", "vector", "ivf") != stamp
    assert cache.clustered("ivf", "items", "vector")[0] is not corpus_s  # rebuilt


def test_device_codebooks_memo(tmp_path, rng, monkeypatch):
    """The coder's device codebooks upload once: two probed searches share
    the copy, and a rewritten artifact uploads the new one. Run on the CPU
    through the bounded beam, which takes the same memo as the card's
    dense ranking (the dense limit lowered under the 16-cell coder)."""
    root = str(tmp_path)
    table.make(root, "items", make_items(rng, n=3000).to_reader())
    coder.make(root, "ivf", "items", "vector", CONFIG, seed=2, device="cpu")
    index.make(root, "ivf", "items", "vector", device="cpu")
    monkeypatch.setattr(cells, "DENSE_CELL_LIMIT", 8)
    cache = DeviceCache(root, device="cpu")
    req = executor.SearchRequest(source="items", column="vector", target=rng.standard_normal((4, DIM)).astype(np.float32),
                                 maxval=5, coding="ivf", probes=3)
    first = executor.execute_search(cache, req)
    books = cache.codebooks("ivf")
    assert cache.device_entry_kinds()["codebooks"] == 1
    second = executor.execute_search(cache, req)
    assert cache.codebooks("ivf") is books and second.equals(first)
    new = codebooks_for(rng, 1, k=16, d=DIM)
    coder._persist(root, "ivf", CONFIG, pa.list_(pa.float32(), DIM), new)
    os.utime(coder.path_of(root, "ivf"), ns=(1, 1))  # a new mtime, however coarse the clock
    rebuilt = cache.codebooks("ivf")
    assert rebuilt is not books
    np.testing.assert_array_equal(rebuilt.numpy(), new)


def test_desynced_index_is_rebuilt(tmp_path, rng):
    """An index whose row count differs from its table (a crash between
    the two publishes) is assigned again on first use."""
    root = str(tmp_path)
    table.make(root, "items", make_items(rng, n=2000).to_reader())
    coder.make(root, "ivf", "items", "vector", CONFIG, seed=2, device="cpu")
    index.make(root, "ivf", "items", "vector", device="cpu")
    path = index.path_of(root, "ivf", "items", "vector")
    index._write_codes(path, np.zeros(10, np.int64))
    cache = DeviceCache(root, device="cpu")
    data = cache.coded_table("ivf", "items", "vector")
    assert data.num_rows == 2000 and (data.column("__CODED_ID__").to_numpy() >= 0).all()
    assert jindex.load(root, "ivf", "items", "vector").num_rows == 2000
