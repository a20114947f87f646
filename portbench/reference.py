"""The plain float64 reference and the comparison that decides
``correct``.

Plain PyTorch; it imports nothing of the port (``fenix_tpu_torch``) or of
the JAX package, and takes nothing the port has made but the outputs it
judges. It gets the cell's corpus, queries and filter from the harness
and works out what it needs from them again: the exact top-k, and for an
IVF cell its own coder (``ReferenceIVF``). An IVF cell's answers are
judged twice. Against the reference's IVF: the port's coder against the
reference coder (``coder_gap``) and the answers' recall against the
reference IVF's (``recall_gap``). And step by step from the port's own
coder and row cells (set-up's outputs, read from the catalog): each row
indexed to its nearest cell (``assign_gap``) and each answer the exact
top-k among the rows of its query's nearest cells (``rank_gap``), which
finds a wrong row that recall alone would average away.

``Oracle`` is a frozen copy of ``chip_smoke.py:1131-1213`` (class
``Oracle``); the rest is this benchmark's own.

The numbers compared (each against its limit in the configuration file):

- ``failed``: requests in the window that never got their answer;
- ``bad_rows``: served rows that break the answer's shape: an id out of
  range or repeated within a query, a row the filter or the probed cells
  exclude, fewer rows than the reference finds;
- ``dist_gap``: the largest gap between a served distance and the float64
  distance of the served row;
- ``rank_gap``: the largest amount by which the float64 distance of the
  row served at rank r exceeds the reference's r-th distance (0 for the
  exact top-k, up to near ties);
- IVF: ``assign_gap``, ``coder_gap`` and ``recall_gap`` (``ReferenceIVF``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

CELL_TIE = 1e-5  # cells whose float64 distances lie this close may rank either way in fp32
ROW_BLOCK = 1 << 16  # rows per block of a [rows, cells] distance matrix
CODER_STEPS = 16  # the reference coder's full-batch Lloyd steps
CODER_DRAW = 0xC0DE  # the stream of the seed that draws the rows it starts from


class Oracle:
    """Float64 exact ranking on the card, independent of the port's
    code: (distance asc, row id asc). A coarse float64 matmul pass picks
    k + 16 candidates; their distances are then recomputed elementwise
    (identical rows give identical values) and sorted by (distance, id)."""

    def __init__(self, vectors, device):
        # widened on the card, part by part (``vectors`` may be a list of
        # row blocks): a float64 host copy would double host memory
        parts = list(vectors) if isinstance(vectors, (list, tuple)) else [vectors]
        self.v = torch.empty((sum(p.shape[0] for p in parts), parts[0].shape[1]), dtype=torch.float64,
                             device=device)
        start = 0
        for p in parts:
            self.v[start : start + p.shape[0]] = torch.as_tensor(p).to(device)
            start += p.shape[0]
        # in row blocks: a whole [N, D] float64 temporary would double the memory
        self.sq = torch.cat([(b * b).sum(dim=1) for b in self.v.split(1 << 20)])
        self.norm = self.sq.sqrt().clamp_min(1e-12)
        self.device = device

    def exact(self, q, idx, metric):
        """Elementwise float64 distances of rows ``idx`` [Q, c] to ``q``."""
        cand = self.v[idx]  # [Q, c, D]
        if metric == "l2":
            return ((cand - q[:, None, :]) ** 2).sum(-1).sqrt()
        if metric == "cosine":
            qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
            return 0.5 - 0.5 * (cand * qn[:, None, :]).sum(-1) / self.norm[idx]
        return -(cand * q[:, None, :]).sum(-1)

    def topk(self, queries_np, metric, k, mask=None, chunk=64):
        """Top-k of each query over the rows ``mask`` allows: a ``[N]``
        bool tensor for every query, or ``mask(start, stop)`` giving the
        ``[stop - start, N]`` rows of those queries. A query with fewer
        than k allowed rows gets them all, padded with (-1, +inf)."""
        out_ids, out_d = [], []
        for s in range(0, queries_np.shape[0], chunk):
            q = torch.from_numpy(queries_np[s : s + chunk]).to(self.device, torch.float64)
            if metric == "l2":
                d = (q * q).sum(1, keepdim=True) - 2.0 * q @ self.v.T + self.sq[None, :]
            elif metric == "cosine":
                qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
                d = 0.5 - 0.5 * (qn @ self.v.T) / self.norm[None, :]
            else:
                d = -(q @ self.v.T)
            if mask is not None:
                m = mask(s, s + q.shape[0]) if callable(mask) else mask[None, :]
                d = torch.where(m, d, torch.inf)
                del m
            coarse, idx = torch.topk(d, min(k + 16, d.shape[1]), dim=1, largest=False)
            del d
            # candidates the mask refused (a query with fewer allowed rows
            # than the window) rank last at +inf
            fine = torch.where(torch.isfinite(coarse), self.exact(q, idx, metric), torch.inf)
            idx, order = torch.sort(idx, dim=1)
            fine = torch.gather(fine, 1, order)
            fine, order = torch.sort(fine, dim=1, stable=True)
            idx = torch.where(torch.isfinite(fine), torch.gather(idx, 1, order), -1)
            # the (k+16)-th coarse distance must clear the k-th exact one,
            # or a tied row past the window could belong in the top k (a
            # window that holds every allowed row has no row past it)
            if metric == "l2":  # the coarse pass ranks squared distances
                coarse = coarse.clamp_min(0.0).sqrt()
            margin = coarse[:, -1] - fine[:, k - 1]
            full = torch.isfinite(coarse[:, -1])
            if (full & (margin <= 1e-9 * (1.0 + fine[:, k - 1].abs()))).any():
                raise AssertionError("oracle window too narrow for the ties at k")
            out_ids.append(idx[:, :k].cpu())
            out_d.append(fine[:, :k].cpu())
        return torch.cat(out_ids).numpy(), torch.cat(out_d).numpy()


# -- filters ------------------------------------------------------------------

_COMPARE: dict[str, Callable] = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def filter_mask(expr: "dict | None", columns: dict[str, torch.Tensor]) -> "torch.Tensor | None":
    """The rows a filter (the wire form of an expression tree) keeps: an
    evaluator of its own over the cell's columns, for field, literal,
    comparison, and, or and not."""
    if expr is None:
        return None

    def ev(node: Any):
        if not isinstance(node, dict):
            return node
        op, args = node["op"], node["args"]
        if op == "field":
            return columns[args[0]]
        if op == "lit":
            return args[0]
        vals = [ev(a) for a in args]
        if op in _COMPARE:
            return _COMPARE[op](*vals)
        if op == "and":
            return vals[0] & vals[1]
        if op == "or":
            return vals[0] | vals[1]
        if op == "not":
            return ~vals[0]
        raise ValueError(f"the reference evaluates no {op!r} filter")

    return ev(expr)


# -- IVF ----------------------------------------------------------------------


def _pairwise(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    """Float64 ``[A, B]`` distances (cosine as ``0.5 - 0.5·cos``, l2, dot)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    if metric == "cosine":
        a = a / a.norm(dim=1, keepdim=True).clamp_min(1e-12)
        b = b / b.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return 0.5 - 0.5 * a @ b.T
    if metric == "l2":
        return torch.cdist(a, b)
    return -(a @ b.T)


def probe_sets(queries_np: np.ndarray, centroids: torch.Tensor, metric: str, probes: int):
    """Each query's cells that are probed for certain (``strict``: nearer
    than the first cell past the ``probes`` nearest by more than
    ``CELL_TIE``) and that may be (``loose``: no farther than the
    ``probes``-th by more than it), as ``[Q, C]`` bool tensors; without
    near ties both are the ``probes`` nearest."""
    d = _pairwise(torch.from_numpy(queries_np).to(centroids.device), centroids, metric)
    last = torch.kthvalue(d, probes, dim=1).values[:, None]
    if probes >= d.shape[1]:
        return d <= last, d <= last
    past = torch.kthvalue(d, probes + 1, dim=1).values[:, None]
    return d < past - CELL_TIE, d <= last + CELL_TIE


def probed_rows(cellmask: torch.Tensor, cells: torch.Tensor, keep=None):
    """``mask(start, stop)`` for ``Oracle.topk``: the rows of the cells a
    ``[Q, C]`` cell mask marks for those queries (``cells``: each row's
    cell), and ``keep`` allows."""

    def mask(a: int, b: int) -> torch.Tensor:
        m = cellmask[a:b][:, cells]
        return m if keep is None else m & keep[None, :]

    return mask


def nearest(rows: torch.Tensor, centroids: torch.Tensor, metric: str, dist=_pairwise):
    """Each row's nearest centroid ``[N]`` and its distance ``[N]``, in
    row blocks (``dist`` gives a block's ``[rows, C]`` distances)."""
    own, best = [], []
    for s in range(0, rows.shape[0], ROW_BLOCK):
        d = dist(rows[s : s + ROW_BLOCK], centroids, metric)
        m = d.min(dim=1)
        best.append(m.values)
        own.append(m.indices)
    return torch.cat(own), torch.cat(best)


def train_coder(rows: torch.Tensor, size: int, metric: str, seed: int, steps: int, dist=_pairwise) -> torch.Tensor:
    """The reference's own coder over ``rows``: ``size`` rows drawn by the
    seed, then ``steps`` full-batch Lloyd steps, each centroid the mean of
    the rows nearest it (cosine: of the unit rows); a centroid that no row
    is nearest to stays. In the rows' type and ``dist``'s precision."""
    pick = np.random.default_rng([int(seed), CODER_DRAW]).choice(rows.shape[0], size, replace=False)
    centroids = rows[torch.from_numpy(pick).to(rows.device)].clone()
    for _ in range(steps):
        own, _ = nearest(rows, centroids, metric, dist)
        sums = torch.zeros_like(centroids)
        for s in range(0, rows.shape[0], ROW_BLOCK):
            block = rows[s : s + ROW_BLOCK]
            if metric == "cosine":
                block = block / block.norm(dim=1, keepdim=True).clamp_min(1e-12)
            sums.index_add_(0, own[s : s + ROW_BLOCK], block)
        counts = torch.bincount(own, minlength=size).to(sums.dtype)
        held = counts > 0
        centroids[held] = sums[held] / counts[held, None]
    return centroids


def index_stats(oracle: Oracle, centroids: torch.Tensor, cells: torch.Tensor, metric: str) -> dict:
    """``assign_gap`` (how much farther a row's indexed cell lies from it
    than its nearest cell) and ``objective`` (the mean float64 distance of
    a row to its indexed centroid: the k-means objective) of a coder's
    centroids ``[C, D]`` and row cells ``[N]``."""
    n, c = oracle.v.shape[0], centroids.shape[0]
    if cells.shape[0] != n or int(cells.min()) < 0 or int(cells.max()) >= c:
        return {"assign_gap": float("inf"), "objective": float("inf")}
    gap, total = 0.0, 0.0
    for start in range(0, n, ROW_BLOCK):
        d = _pairwise(oracle.v[start : start + ROW_BLOCK], centroids, metric)
        own = d.gather(1, cells[start : start + ROW_BLOCK, None])[:, 0]
        gap = max(gap, float((own - d.min(dim=1).values).max()))
        total += float(own.sum())
    return {"assign_gap": gap, "objective": total / n}


def misses(exact: np.ndarray, ids: np.ndarray) -> float:
    """One less the recall of ``ids`` against the ``exact`` top-k (recall@k,
    as ann-benchmarks counts it; -1 pads either)."""
    hits = sum(np.intersect1d(e[e >= 0], i[i >= 0]).size for e, i in zip(exact, ids))
    return 1.0 - hits / max(1, int((exact >= 0).sum()))


class ReferenceIVF:
    """The reference's own IVF over the cell's corpus and queries: its
    float64 coder trained from the seed (``train_coder``), every row
    indexed to its nearest cell, and each query's exact top-k among the
    rows of its ``probes`` nearest cells. A coder and its answers are
    judged against it:

    - ``coder_gap``: the coder's objective over the reference coder's, less 1;
    - ``recall_gap``: the answers' ``miss_rate`` less the reference IVF's,
      both against the exact top-k over every row the filter keeps.
    """

    def __init__(self, oracle: Oracle, size: int, coder_metric: str, seed: int, queries_np: np.ndarray,
                 metric: str, k: int, probes: int, keep=None) -> None:
        self.oracle, self.coder_metric, self.queries, self.metric = oracle, coder_metric, queries_np, metric
        self.centroids = train_coder(oracle.v, size, coder_metric, seed, CODER_STEPS)
        cells, _ = nearest(oracle.v, self.centroids, coder_metric)
        self.objective = index_stats(oracle, self.centroids, cells, coder_metric)["objective"]
        self.exact, _ = oracle.topk(queries_np, metric, k, mask=keep)
        sure, _ = probe_sets(queries_np, self.centroids, metric, probes)
        ids, _ = oracle.topk(queries_np, metric, k, mask=probed_rows(sure, cells, keep))
        self.miss_rate = misses(self.exact, ids)

    def judge(self, centroids: torch.Tensor, cells: torch.Tensor, ids: np.ndarray) -> dict:
        """``assign_gap``, ``coder_gap`` and ``recall_gap`` of a coder's
        centroids and row cells and of the answers ``ids`` served from them
        (with ``miss_rate`` and both objectives as readings)."""
        stats = index_stats(self.oracle, centroids, cells, self.coder_metric)
        miss = misses(self.exact, ids)
        return {"assign_gap": stats["assign_gap"], "coder_gap": stats["objective"] / self.objective - 1.0,
                "recall_gap": miss - self.miss_rate, "miss_rate": miss, "ref_miss_rate": self.miss_rate,
                "objective": stats["objective"], "ref_objective": self.objective}


# -- the comparison -----------------------------------------------------------


def judge(
    oracle: Oracle,
    queries_np: np.ndarray,  # [S, D] float32, the queries the sampled requests sent
    ids: np.ndarray,  # [S, k] served ids, -1 padded
    dists: np.ndarray,  # [S, k] served distances
    metric: str,
    strict=None,  # rows the answer must search: None, a [N] bool tensor or mask(start, stop)
    loose=None,  # rows the answer may hold (None: strict's)
    chunk: int = 64,
) -> dict:
    """``bad_rows``, ``dist_gap`` and ``rank_gap`` of the served answers
    against the float64 top-k over ``strict``'s rows."""
    k = ids.shape[1]
    n = oracle.v.shape[0]
    loose = strict if loose is None else loose
    bad, dist_gap, rank_gap = 0, 0.0, 0.0
    for s in range(0, queries_np.shape[0], chunk):
        q_np = queries_np[s : s + chunk]
        ref_ids, ref_d = oracle.topk(q_np, metric, k, mask=(lambda a, b: strict(s + a, s + b)) if callable(strict)
                                     else strict, chunk=chunk)
        want = (ref_ids >= 0).sum(1)  # the rows the reference finds
        got_ids = torch.from_numpy(ids[s : s + chunk]).to(oracle.device)
        valid = (got_ids >= 0) & (got_ids < n)
        safe = torch.where(valid, got_ids, 0)
        if loose is not None:
            allowed = loose(s, s + q_np.shape[0]) if callable(loose) else loose[None, :].expand(q_np.shape[0], -1)
            valid &= allowed.gather(1, safe)
        srt = torch.sort(torch.where(valid, got_ids, -1 - torch.arange(k, device=oracle.device)), dim=1).values
        dup = torch.zeros_like(valid)
        dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        rank = torch.arange(k, device=oracle.device)[None, :]
        due = rank < torch.from_numpy(want).to(oracle.device)[:, None]
        served = (got_ids != -1) | due  # a row served, or one that should have been
        bad += int((served & ~valid).sum()) + int(dup.sum())
        q = torch.from_numpy(q_np).to(oracle.device, torch.float64)
        true = oracle.exact(q, safe, metric)
        got_d = torch.from_numpy(dists[s : s + chunk]).to(oracle.device, torch.float64)
        if valid.any():
            dist_gap = max(dist_gap, float((got_d - true).abs()[valid].max()))
        ref = torch.from_numpy(ref_d).to(oracle.device)
        both = valid & due
        if both.any():
            rank_gap = max(rank_gap, float((true - ref)[both].max()))
    return {"bad_rows": bad, "dist_gap": dist_gap, "rank_gap": rank_gap}


def verdict(numbers: dict, limits: dict) -> bool:
    """Whether every number compared is within its limit."""
    return all(numbers[name] <= limit for name, limit in limits.items())
