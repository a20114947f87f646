"""The float64 reference against a brute-force numpy ranking (ties
included), the filter evaluator, the comparison's numbers and the index
checks, on hand-made data."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import reference


def brute(v: np.ndarray, q: np.ndarray, metric: str, k: int, keep=None):
    """(distance, id) ascending, in float64 with numpy."""
    v, q = v.astype(np.float64), q.astype(np.float64)
    if metric == "cosine":
        vn = v / np.linalg.norm(v, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = 0.5 - 0.5 * qn @ vn.T
    elif metric == "l2":
        d = np.sqrt(((q[:, None, :] - v[None, :, :]) ** 2).sum(-1))
    else:
        d = -(q @ v.T)
    if keep is not None:
        d = np.where(keep[None, :], d, np.inf)
    ids = np.stack([np.lexsort((np.arange(len(row)), row))[:k] for row in d])
    return ids, np.take_along_axis(d, ids, 1)


@pytest.fixture
def corpus():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(500, 24)).astype(np.float32)
    v[100:140] = v[0:40]  # exact duplicates: ties broken by row id
    v[200:220] = 2.0 * v[0:20]  # cosine ties with a scaled copy
    q = np.concatenate([v[:8] + 0.01, rng.normal(size=(8, 24)).astype(np.float32)])
    return v, q


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_oracle_matches_numpy_with_ties(corpus, metric):
    v, q = corpus
    oracle = reference.Oracle(v, "cpu")
    keep = np.arange(len(v)) % 3 != 0
    for mask in (None, keep):
        ids, d = oracle.topk(q, metric, 10, mask=None if mask is None else torch.from_numpy(mask))
        want_ids, want_d = brute(v, q, metric, 10, mask)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_allclose(d, want_d, rtol=1e-12, atol=1e-12)


def test_judge_numbers(corpus):
    v, q = corpus
    oracle = reference.Oracle(v, "cpu")
    ids, d = brute(v, q, "l2", 5)
    exact = reference.judge(oracle, q, ids, d, "l2")
    assert exact["bad_rows"] == 0 and exact["dist_gap"] < 1e-12 and exact["rank_gap"] < 1e-12
    # a swapped tie (rows 0 and 100 are one vector) is no fault
    assert ids[0, :2].tolist() == [0, 100]
    tie = ids.copy()
    tie[0, :2] = [100, 0]
    assert reference.judge(oracle, q, tie, d, "l2")["rank_gap"] < 1e-12
    wrong = ids.copy()
    wrong[3, 0] = next(i for i in range(499, 0, -1) if i not in ids[3])
    got = reference.judge(oracle, q, wrong, d, "l2")
    assert got["rank_gap"] > 0 and got["dist_gap"] > 0
    dup = ids.copy()
    dup[2, 1] = dup[2, 0]
    assert reference.judge(oracle, q, dup, d, "l2")["bad_rows"] == 1
    short = ids.copy()
    short[5, -1] = -1
    assert reference.judge(oracle, q, short, d, "l2")["bad_rows"] == 1
    keep = torch.from_numpy(np.arange(len(v)) % 2 == 0)
    assert reference.judge(oracle, q, ids, d, "l2", keep)["bad_rows"] > 0


def test_filter_mask():
    cols = {"tag": torch.tensor([0, 1, 5, 99], dtype=torch.int32)}
    expr = {"op": "and", "args": [{"op": ">=", "args": [{"op": "field", "args": ["tag"]}, {"op": "lit", "args": [1]}]},
                                  {"op": "not", "args": [{"op": "==", "args": [{"op": "field", "args": ["tag"]},
                                                                                {"op": "lit", "args": [5]}]}]}]}
    assert reference.filter_mask(expr, cols).tolist() == [False, True, False, True]
    assert reference.filter_mask(None, cols) is None
    with pytest.raises(ValueError):
        reference.filter_mask({"op": "%", "args": [1, 2]}, cols)


def clusters(seed: int = 5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 8)) * 10
    v = np.concatenate([c + rng.normal(size=(50, 8)) for c in centers]).astype(np.float32)
    cells = torch.arange(4).repeat_interleave(50)
    unit = torch.from_numpy(v).view(4, 50, 8).double()
    unit = unit / unit.norm(dim=2, keepdim=True)
    return v, cells, unit.mean(1)


def test_index_checks_and_probe_sets():
    v, cells, good = clusters()
    oracle = reference.Oracle(v, "cpu")
    got = reference.index_stats(oracle, good, cells, "cosine")
    d = reference._pairwise(oracle.v, good, "cosine")
    assert got["assign_gap"] == 0.0
    assert got["objective"] == pytest.approx(float(d.min(1).values.mean()), rel=1e-12)
    rows = torch.from_numpy(v[[0, 50, 100, 150]]).double()  # untrained: one row a cell
    assert reference.index_stats(oracle, rows, cells, "cosine")["objective"] > got["objective"]
    swapped = cells.clone()
    swapped[0] = 1
    assert reference.index_stats(oracle, good, swapped, "cosine")["assign_gap"] > 0.01
    assert reference.index_stats(oracle, good, cells[:-1], "cosine")["objective"] == float("inf")
    sure, maybe = reference.probe_sets(v[:3], good, "cosine", 2)
    assert sure.sum(1).tolist() == [2, 2, 2] and torch.equal(sure, maybe)
    tied = torch.cat([good, good[:1]])  # cell 4 ties cell 0
    sure, maybe = reference.probe_sets(v[:1], tied, "cosine", 1)
    assert sure.sum().item() == 0 and maybe[0, [0, 4]].all()


def test_reference_coder_finds_the_clusters():
    """The reference's own coder, trained from the seed, reaches the
    objective of the clusters' true means; a coder judged against it reads
    its gap, and an untrained one a positive gap."""
    v, cells, good = clusters()
    oracle = reference.Oracle(v, "cpu")
    trained = reference.train_coder(oracle.v, 4, "cosine", 7, reference.CODER_STEPS)
    own, best = reference.nearest(oracle.v, trained, "cosine")
    want = reference.index_stats(oracle, good, cells, "cosine")["objective"]
    assert float(best.mean()) == pytest.approx(want, rel=1e-9)
    assert sorted(torch.bincount(own).tolist()) == [50, 50, 50, 50]
    # steps 0: the rows drawn by the seed, as drawn
    start = reference.train_coder(oracle.v, 4, "cosine", 7, 0)
    assert any(torch.equal(start[0], row) for row in oracle.v)
    q = v[[1, 51, 101, 151]] + 0.01
    ivf = reference.ReferenceIVF(oracle, 4, "cosine", 7, q, "cosine", 5, 1)
    exact, _ = oracle.topk(q, "cosine", 5)
    assert ivf.miss_rate == 0.0 and np.array_equal(ivf.exact, exact)
    same = ivf.judge(good, cells, exact)
    assert same["coder_gap"] == pytest.approx(0.0, abs=1e-9) and same["recall_gap"] == 0.0
    rows = torch.from_numpy(v[[0, 1, 2, 3]]).double()  # an untrained coder, all in one cluster
    near, _ = reference.nearest(oracle.v, rows, "cosine")
    wrong = exact.copy()
    wrong[:, 0] = (wrong[:, 0] + 50) % 200  # each query's nearest row swapped for another cluster's
    got = ivf.judge(rows, near, wrong)
    assert got["coder_gap"] > 0.5 and got["recall_gap"] == pytest.approx(0.2)
