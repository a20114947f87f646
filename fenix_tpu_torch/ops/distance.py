"""Metric canon and normalization — port of ``fenix_tpu/ops/distance.py:23-45``.

Semantics parity with the reference: l2, cosine as ``0.5 - 0.5·cos`` and
dot as the negated inner product, all "smaller is closer". Only what the
exact-search slice needs is ported; the pairwise matrices wait for the
no-top-k read.
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
