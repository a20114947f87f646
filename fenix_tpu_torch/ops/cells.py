"""Composite-cell scoring for the multi-codebook coder — port of
``fenix_tpu/ops/cells.py``.

Each of the ``n`` codebooks quantizes the *full* vector; a composite cell
is one centroid choice per codebook; the cell score is the sum of the
per-codebook distances; cell ids enumerate the cartesian product with
codebook 0 as the most significant base-``k`` digit. The sum separates,
so nearest-cell assignment is ``n`` independent argmins, and the top
``m`` cells come from scoring the ``k^n`` sums when that is small, else
from a bounded beam over the codebooks.

Tie rule: the first minimum (``torch.argmin``, ``np.argmin``) and the
earliest id among equal scores (a stable sort), as ``jnp.argmin`` and
``lax.top_k`` give them. ``assign_cells_np`` and ``topk_cells_np`` are
the JAX package's numpy functions, so host routes rank and assign with
the same arithmetic whichever package serves: the product is numpy's,
and the elementwise finish (the same IEEE operations in the same order)
and the first-min argmin run as in-place torch CPU ops, on every core of
the host, where numpy takes one. Probed serving on a card ranks with
``topk_cells`` instead, on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from fenix_tpu_torch.ops.distance import canonical_metric, pairwise_distance

# k^n at or below this is scored by direct enumeration.
DENSE_CELL_LIMIT = 1 << 20

# topk_cells ranks the queries in chunks of at most this many cells
# ([chunk, k^n]): the fp32 scores, the stable sort's int64 iota, its
# scratch copies of keys and positions, and its sorted keys and positions
# come to about 40 bytes a cell, so a chunk stays within 256 MiB (1,638
# queries at 4,096 cells, 6 at DENSE_CELL_LIMIT).
RANK_CHUNK_CELLS = (256 << 20) // 40

# Composite cell ids are int32; configurations past this are refused up
# front instead of wrapping.
MAX_CELLS = (1 << 31) - 1


def check_cell_space(codebook_size: int, num_codebooks: int) -> None:
    if codebook_size**num_codebooks > MAX_CELLS:
        raise ValueError(
            f"codebook_size**num_codebooks = {codebook_size}**{num_codebooks} "
            f"exceeds the int32 composite-cell id space ({MAX_CELLS}); "
            "reduce codebook_size or num_codebooks"
        )


def codebook_distances(
    targets: torch.Tensor,  # [Q, D]
    codebooks: torch.Tensor,  # [n, K, D]
    metric: str,
) -> torch.Tensor:  # [Q, n, K]
    metric = canonical_metric(metric)
    n, k, d = codebooks.shape
    return pairwise_distance(targets, codebooks.reshape(n * k, d), metric).reshape(-1, n, k)


def assign_cells(
    vectors: torch.Tensor,  # [N, D]
    codebooks: torch.Tensor,  # [n, K, D]
    metric: str,
) -> torch.Tensor:  # [N] int32 composite cell id
    """Nearest composite cell via per-codebook argmin (sum-separable)."""
    n, k, _ = codebooks.shape
    digits = torch.argmin(codebook_distances(vectors, codebooks, metric), dim=-1)  # [N, n]
    weights = k ** torch.arange(n - 1, -1, -1, dtype=torch.int64, device=vectors.device)
    return (digits * weights).sum(dim=-1).to(torch.int32)


def _enumerate_cell_scores(dist: torch.Tensor) -> torch.Tensor:
    """[Q, n, K] per-codebook distances → [Q, k^n] composite sums, codebook
    0 the most significant digit: cell c's codebook-j index is
    ``(c // k^(n-1-j)) % k``."""
    q, n, _ = dist.shape
    scores = dist[:, 0, :]
    for j in range(1, n):
        scores = (scores[:, :, None] + dist[:, j, None, :]).reshape(q, -1)
    return scores


def _ascending(scores: torch.Tensor, m: int) -> torch.Tensor:
    """Positions of the ``m`` smallest scores per row, earliest on ties."""
    return torch.sort(scores, dim=-1, stable=True).indices[:, :m]


def topk_cells(
    targets: torch.Tensor,  # [Q, D]
    codebooks: torch.Tensor,  # [n, K, D]
    metric: str,
    maxval: int,
) -> torch.Tensor:  # [Q, maxval] int32 cell ids, ascending by score
    """Top-``maxval`` composite cells per target (dense grids), over
    chunks of the queries within ``RANK_CHUNK_CELLS``: each row's ranking
    is its own, whatever the chunk."""
    n, k, _ = codebooks.shape
    if k**n > DENSE_CELL_LIMIT:
        raise NotImplementedError(
            f"k^n = {k**n} exceeds dense enumeration limit; "
            "use per-codebook bounded search (cells.topk_cells_bounded)"
        )
    chunk = max(1, RANK_CHUNK_CELLS // k**n)
    out = [
        _ascending(_enumerate_cell_scores(codebook_distances(targets[lo : lo + chunk], codebooks, metric)), maxval)
        for lo in range(0, targets.shape[0], chunk)
    ]
    return (out[0] if len(out) == 1 else torch.cat(out)).to(torch.int32)


def all_cell_ranks(
    targets: torch.Tensor,  # [Q, D]
    codebooks: torch.Tensor,  # [n, K, D]
    metric: str,
) -> torch.Tensor:  # [Q, k^n] cell ids sorted ascending by score
    """Full stable argsort of the composite cells."""
    scores = _enumerate_cell_scores(codebook_distances(targets, codebooks, metric))
    return _ascending(scores, scores.shape[1]).to(torch.int32)


def topk_cells_bounded(
    targets: torch.Tensor,
    codebooks: torch.Tensor,
    metric: str,
    maxval: int,
    beam: int | None = None,
) -> torch.Tensor:  # [Q, min(maxval, beam)] int32
    """Top-``maxval`` cells without materializing k^n: keep the best
    ``beam`` (default ``maxval·k``) partial sums after each codebook."""
    n, k, _ = codebooks.shape
    beam = beam or maxval * k
    dist = codebook_distances(targets, codebooks, metric)  # [Q, n, K]
    q = dist.shape[0]
    lane = torch.arange(k, dtype=torch.int64, device=dist.device)
    scores = dist[:, 0, :]
    ids = lane.expand(q, k)
    for j in range(1, n):
        cand_scores = (scores[:, :, None] + dist[:, j, None, :]).reshape(q, -1)
        cand_ids = (ids[:, :, None] * k + lane).reshape(q, -1)
        pos = _ascending(cand_scores, min(beam, cand_scores.shape[1]))
        scores = torch.gather(cand_scores, 1, pos)
        ids = torch.gather(cand_ids, 1, pos)
    pos = _ascending(scores, min(maxval, scores.shape[1]))
    return torch.gather(ids, 1, pos).to(torch.int32)


# -- host (numpy) copies -------------------------------------------------------


def _host_codebook_distances(vectors, codebooks, metric: str) -> np.ndarray:
    metric = canonical_metric(metric)
    v = np.asarray(vectors, dtype=np.float32)
    cb = np.asarray(codebooks, dtype=np.float32)
    n, k, d = cb.shape
    flat = cb.reshape(n * k, d)
    if metric == "l2":
        uu = torch.from_numpy(np.sum(np.square(v), axis=-1, keepdims=True))
        vv = torch.from_numpy(np.sum(np.square(flat), axis=-1, keepdims=True).T)
        # sqrt(max(uu - 2 v·c + vv, 0)); 2·(v·c) is exact, so negating it
        # first rounds as numpy's subtraction does
        dist = torch.from_numpy(v @ flat.T).mul_(-2.0).add_(uu).add_(vv).clamp_min_(0.0).sqrt_()
    elif metric == "cosine":
        tn = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        fn = flat / np.maximum(np.linalg.norm(flat, axis=-1, keepdims=True), 1e-12)
        dist = torch.from_numpy(tn @ fn.T).mul_(-0.5).add_(0.5)  # 0.5 - 0.5·(t·f)
    else:
        dist = torch.from_numpy(v @ flat.T).neg_()
    return dist.numpy().reshape(-1, n, k)


def assign_cells_np(vectors, codebooks, metric: str) -> np.ndarray:
    """Host mirror of :func:`assign_cells` (int64 ids): the same pairwise
    distance, the l2 sqrt form included, and the same first-min rule.
    ``index.make`` assigns host-resident tables with it."""
    n, k, _ = np.shape(codebooks)
    dist = torch.from_numpy(_host_codebook_distances(vectors, codebooks, metric))
    digits = torch.argmin(dist, dim=-1).numpy()  # the first minimum, as np.argmin
    weights = (k ** np.arange(n - 1, -1, -1, dtype=np.int64))[None, :]
    return np.sum(digits * weights, axis=-1)


def topk_cells_np(targets, codebooks, metric: str, maxval: int) -> np.ndarray:
    """Host mirror of :func:`topk_cells` for dense cell grids: probed
    serving ranks with it, with no device round trip. The same fp32
    arithmetic and the smallest-id tie rule (stable argsort)."""
    dist = _host_codebook_distances(targets, codebooks, metric)
    q, n, k = dist.shape
    num_cells = k**n
    maxval = min(maxval, num_cells)

    # chunk the queries: the [chunk, k^n] score matrix at DENSE_CELL_LIMIT
    # is 4 MB a row
    chunk = max(1, min(q, (64 << 20) // max(num_cells * 4, 1)))
    out = np.empty((q, maxval), np.int32)
    for lo in range(0, q, chunk):
        hi = min(lo + chunk, q)
        scores = dist[lo:hi, 0, :]
        for j in range(1, n):
            scores = (scores[:, :, None] + dist[lo:hi, j, None, :]).reshape(hi - lo, -1)
        if num_cells > 4 * maxval and num_cells > 4096:
            # argpartition, then a stable (score, id) sort of the selected
            # slice; a boundary tie may select another equal-score cell
            part = np.argpartition(scores, maxval - 1, axis=1)[:, :maxval]
            sel = np.take_along_axis(scores, part, axis=1)
            o1 = np.argsort(part, axis=1, kind="stable")
            part = np.take_along_axis(part, o1, axis=1)
            sel = np.take_along_axis(sel, o1, axis=1)
            o2 = np.argsort(sel, axis=1, kind="stable")
            out[lo:hi] = np.take_along_axis(part, o2, axis=1).astype(np.int32)
        else:
            order = np.argsort(scores, axis=-1, kind="stable")
            out[lo:hi] = order[:, :maxval].astype(np.int32)
    return out
