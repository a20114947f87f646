"""Distance metrics: metric canon, normalization, pairwise matrices —
port of ``fenix_tpu/ops/distance.py``.

Semantics parity with the reference: l2, cosine as ``0.5 - 0.5·cos`` and
dot as the negated inner product, all "smaller is closer".
"""

from __future__ import annotations

import torch

# Canonical metric names; aliases mirror the reference's flight.py:254.
METRIC_ALIASES: dict[str, str] = {
    "l2": "l2",
    "euclidean": "l2",
    "cosine": "cosine",
    "dot": "dot",
    "inner_product": "dot",
}

NEG_INF = float("-inf")


def canonical_metric(metric: str) -> str:
    try:
        return METRIC_ALIASES[metric]
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}; expected one of {sorted(METRIC_ALIASES)}")


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along ``dim``: divide by max(norm, eps)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def pairwise_distance(u: torch.Tensor, v: torch.Tensor, metric: str) -> torch.Tensor:
    """``[..., Q, D] × [..., N, D] → [..., Q, N]`` distance matrix (fp32
    products, TF32 off; leading dimensions batch, as the k-means step's
    codebook axis does).

    l2 keeps the reference's expansion ``sqrt(max(‖u‖² − 2u·v + ‖v‖², 0))``:
    assignment near-ties follow its rounding, and the numpy copies in
    ``ops/cells.py`` use it too. The arithmetic runs in place on the one
    product buffer (``−2·uv`` is exact, and ``a + (−b)`` rounds as
    ``a − b``), so a ``[65536, 16384]`` block needs one 4 GiB matrix."""
    metric = canonical_metric(metric)
    if metric == "cosine":
        u, v = normalize(u), normalize(v)
    uv = torch.matmul(u, v.transpose(-1, -2))
    if metric == "l2":
        uu = torch.sum(torch.square(u), dim=-1, keepdim=True)  # [..., Q, 1]
        vv = torch.sum(torch.square(v), dim=-1).unsqueeze(-2)  # [..., 1, N]
        return uv.mul_(-2.0).add_(uu).add_(vv).clamp_min_(0.0).sqrt_()
    if metric == "cosine":
        return uv.mul_(-0.5).add_(0.5)
    return uv.neg_()


def all_distances(corpus: torch.Tensor, queries: torch.Tensor, metric: str) -> torch.Tensor:
    """Full ``[Q, N_pad]`` distance matrix (the no-top-k read's values)."""
    return pairwise_distance(queries, corpus, metric)
