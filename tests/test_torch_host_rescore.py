"""The host rescore's scoring pass (``ops/host_rescore.py``,
``csrc/host_rescore.cpp``, built here with g++) and the rescore around it
(``engine/residency._host_rescore_topk``), on the CPU.

Tolerances: the pass's scores within 1e-5 of float64 (unit-norm queries,
rows scaled to unit norm by ``aux_mul``); the rescore's ids equal to the
JAX package's and its distances within 1e-5 (the two sum the fp32
products in different orders). Across thread counts and query blocks the
answers are bit for bit alike: every row sums in one fixed order.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from fenix_tpu.engine import residency as jresidency
from fenix_tpu_torch.engine import residency
from fenix_tpu_torch.ops import host_rescore, kernels
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _aux(host: np.ndarray, metric: str) -> tuple[np.ndarray, np.ndarray]:
    """``session.host_aux``'s rule."""
    sq = np.einsum("nd,nd->n", host, host, dtype=np.float32)
    if metric == "l2":
        return np.ones_like(sq), -sq
    if metric == "cosine":
        return (1.0 / np.maximum(np.sqrt(sq), 1e-12)).astype(np.float32), np.zeros_like(sq)
    return np.ones_like(sq), np.zeros_like(sq)


def _windows(rng, q: int, w: int, rows: int, n: int) -> np.ndarray:
    """[q, w] distinct ids a query, drawn from [-1, n + 2): −1 and ids at
    or past ``rows`` are invalid slots."""
    return np.stack([rng.choice(n + 3, w, replace=False) - 1 for _ in range(q)])


@pytest.mark.parametrize("d", [7, 100, 768, 1536])
def test_window_scores_against_float64(d):
    rng = np.random.default_rng(d)
    n, rows, q, w = 700, 650, 5, 160
    host = rng.standard_normal((n, d), np.float32)
    queries = rng.standard_normal((q, d), np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    mul = (1.0 / np.linalg.norm(host, axis=1)).astype(np.float32)
    add = (0.1 * rng.standard_normal(n)).astype(np.float32)
    mask = rng.random(n) < 0.7
    ids = _windows(rng, q, w, rows, n)

    got = host_rescore.window_scores(host, ids, queries, mul, add, mask, rows)

    ok = (ids >= 0) & (ids < rows)
    safe = np.where(ok, ids, 0)
    ok &= mask[safe]
    want = np.einsum("qd,qwd->qw", queries.astype(np.float64), host[safe].astype(np.float64))
    want = want * mul[safe] + add[safe]
    assert got.dtype == np.float32 and got.shape == (q, w)
    assert np.array_equal(got == -np.inf, ~ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-5)


def test_window_scores_bit_identical_across_threads():
    """8 × 1,024 slots of 100-wide rows start every thread asked for."""
    rng = np.random.default_rng(11)
    n, d, q, w = 3000, 100, 8, 1024
    host = rng.standard_normal((n, d), np.float32)
    queries = rng.standard_normal((q, d), np.float32)
    mul, add = _aux(host, "l2")
    ids = rng.integers(-2, n + 2, (q, w))
    mask = rng.random(n) < 0.9
    one = host_rescore.window_scores(host, ids, queries, mul, add, mask, n, threads=1)
    for threads in (2, 3, 8, None):
        np.testing.assert_array_equal(host_rescore.window_scores(host, ids, queries, mul, add, mask, n, threads), one)
    # a row scores alike in any slot and beside any other query block
    np.testing.assert_array_equal(
        host_rescore.window_scores(host, ids[3:5, ::-1], queries[3:5], mul, add, mask, n, threads=5),
        one[3:5, ::-1],
    )


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_rescore_topk_bit_identical_across_query_blocks(metric):
    rng = np.random.default_rng(3)
    n, d, q, w, k = 1200, 48, 13, 300, 20
    host = rng.standard_normal((n, d), np.float32)
    queries = rng.standard_normal((q, d), np.float32)
    mul, add = _aux(host, metric)
    mask = rng.random(n) < 0.8
    ids = _windows(rng, q, w, n, n)
    want = residency._host_rescore_topk(host, mul, add, mask, queries, ids, n, k, metric)
    for q_block in (1, 4, 13):
        got = residency._host_rescore_topk(host, mul, add, mask, queries, ids, n, k, metric, q_block=q_block)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("w", [256, 6], ids=["window", "short_window"])
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_rescore_topk_against_the_jax_package(metric, w):
    """Ids equal to ``fenix_tpu``'s host rescore, distances within 1e-5,
    with invalid slots, a mask, and a window shorter than k padded."""
    rng = np.random.default_rng(64 + w)
    n, rows, d, q, k = 2000, 1900, 64, 20, 10
    host = rng.standard_normal((n, d), np.float32)
    queries = rng.standard_normal((q, d), np.float32)
    mul, add = _aux(host, metric)
    mask = rng.random(n) < 0.75
    ids = _windows(rng, q, w, rows, n).astype(np.int32)
    got_d, got_i = residency._host_rescore_topk(host, mul, add, mask, queries, ids, rows, k, metric)
    want_d, want_i = jresidency._host_rescore_topk(host, mul, add, mask, queries, ids, rows, k, metric)
    assert got_d.dtype == np.float32 and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-5)
    if w < k:
        assert (got_i[:, w:] == -1).all()


def test_rescore_fused_counts_one_pass_a_rescore(monkeypatch):
    """One scoring pass (``host_rescore.window_scores``) a rescore,
    whatever its query blocks; cosine gathers nothing, so its score
    seconds are the rescore's; l2 gathers its winners."""
    rng = np.random.default_rng(9)
    n, d, k = 1500, 32, 10
    host = rng.standard_normal((n, d), np.float32)
    queries = rng.standard_normal((150, d), np.float32)
    ids = rng.integers(-1, n, (150, 64))
    passes = []
    real = host_rescore.window_scores

    def counted(*args):
        passes.append(1)
        return real(*args)

    monkeypatch.setattr(host_rescore, "window_scores", counted)
    names = ("residency.rescore_seconds", "residency.rescore_score_seconds", "residency.rescore_gather_seconds")
    before = METRICS.snapshot()
    for q in (1, 150, 64):  # 150 queries: three blocks of 64
        residency._timed_rescore(host, *_aux(host, "cosine"), None, queries[:q], ids[:q], n, k, "cosine")
    mid = METRICS.snapshot()
    delta = {m: mid.get(m, 0.0) - before.get(m, 0.0) for m in names}
    assert len(passes) == 3
    assert delta["residency.rescore_gather_seconds"] == 0.0
    assert delta["residency.rescore_score_seconds"] == pytest.approx(delta["residency.rescore_seconds"], rel=1e-9)
    residency._timed_rescore(host, *_aux(host, "l2"), None, queries, ids, n, k, "l2")
    after = METRICS.snapshot()
    assert len(passes) == 4
    assert after["residency.rescore_gather_seconds"] > mid.get("residency.rescore_gather_seconds", 0.0)


def test_window_scores_checks_its_inputs():
    rng = np.random.default_rng(1)
    host = rng.standard_normal((50, 8), np.float32)
    ids = rng.integers(0, 50, (2, 5))
    q = rng.standard_normal((2, 8), np.float32)
    ones, zeros = np.ones(50, np.float32), np.zeros(50, np.float32)
    bad = [
        dict(host=host.astype(np.float64)),
        dict(host=np.asfortranarray(host)),
        dict(queries=q[:, :7]),
        dict(rows=51),
        dict(aux_mul=ones[:40]),
        dict(mask=np.ones(40, bool)),
        dict(threads=0),
    ]
    for change in bad:
        args = dict(host=host, ids=ids, queries=q, aux_mul=ones, aux_add=zeros, mask=None, rows=50, threads=None)
        args.update(change)
        with pytest.raises(ValueError):
            host_rescore.window_scores(**args)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises from the pass; nothing scores in its
    place."""
    broken = tmp_path / "host_rescore.cpp"
    broken.write_text("extern \"C\" int fenix_window_scores( {\n")
    monkeypatch.setenv("FENIX_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(host_rescore, "_SOURCE", broken)
    monkeypatch.setattr(host_rescore, "_LIB", None)
    host = np.ones((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="g\\+\\+ host_rescore.cpp failed"):
        host_rescore.window_scores(host, np.zeros((1, 2), np.int64), np.ones((1, 3), np.float32),
                                   np.ones(4, np.float32), np.zeros(4, np.float32), None, 4)
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_build_stays_out_of_import(tmp_path):
    """Importing the rescore builds nothing; the library lands in the
    kernels' build directory, named for its source, flags and host."""
    code = (
        "import fenix_tpu_torch.engine.residency\n"
        "from fenix_tpu_torch.ops import host_rescore\n"
        "assert host_rescore._LIB is None\n"
    )
    env = {**os.environ, "FENIX_TORCH_BUILD_DIR": str(tmp_path), "PYTHONPATH": REPO}
    done = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert not list(tmp_path.iterdir())
    path = host_rescore.library_path()
    assert path.parent == kernels.build_dir() and path.name.startswith("libfenix_host_rescore-")
