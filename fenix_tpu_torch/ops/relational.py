"""Filter compaction on the device — port of ``compact_indices`` and
``compact`` from ``fenix_tpu/ops/relational.py``.

The JAX package packs the True rows of a mask to the front with one
stable sort (XLA lowers it to the TPU's sort unit). Here a prefix count
gives every True row its slot and one scatter writes it there: the same
output, in linear work. Sort, joins and group-by aggregates wait for the
analytics port (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import torch


def compact_indices(mask: torch.Tensor, width: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched filter compaction of ``[..., N]`` bool masks: the indices of
    the True entries of each row, in ascending order, packed to the front
    and padded with ``N``, cut to ``width`` columns (``N`` when None), as
    int32; and each row's True count, as int32."""
    n = mask.shape[-1]
    w = n if width is None else width
    slot = torch.cumsum(mask, dim=-1) - 1  # the slot of each True entry
    # False entries and True entries past the width go to a spare column
    dest = torch.where(mask & (slot < w), slot, w)
    iota = torch.arange(n, dtype=torch.int32, device=mask.device).expand(mask.shape)
    packed = torch.full((*mask.shape[:-1], w + 1), n, dtype=torch.int32, device=mask.device)
    packed.scatter_(-1, dest, iota)
    count = mask.sum(dim=-1, dtype=torch.int32)
    return packed[..., :w], count


def compact(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """1-D form of :func:`compact_indices`: ``(indices padded with N,
    count)``; the selected rows are ``indices[:count]``."""
    return compact_indices(mask)
