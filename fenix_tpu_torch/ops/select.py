"""Streamed no-top-k reads: the distance column over every selected row —
port of ``fenix_tpu/ops/select.py``.

A read with ``maxval=None`` returns every row that passes the filter
(and, with ``probes``, lies in one of the query's probe cells) with its
exact distance, in table order. The selection runs on the device:

- one count pass over the corpus gives the selected rows per
  (row chunk[, query]) — a small copy to the host;
- each chunk that holds matches is compacted at a width of its largest
  count, and only the selected ids and distances leave the device.

Host transfer is O(selected rows), never O(Q·N). Probe membership is a
batched ``searchsorted`` of the rows' cell ids into each query's sorted
probe cells, with no ``[Q, C, P]`` broadcast. The JAX package computes
these in XLA, not Pallas, so they are torch ops here.

Distances: cosine and dot from the fp32 product (TF32 off, as everywhere
in ``ops``); l2 as ``‖q − v‖`` of each returned row, the port's rule for
l2 (ROADMAP queue 3, "Fixed in the port"), where the JAX package's
expanded ``sqrt(‖q‖² − 2q·v + ‖v‖²)`` cancels for near rows.
"""

from __future__ import annotations

import torch

from fenix_tpu_torch.ops import relational
from fenix_tpu_torch.ops.distance import canonical_metric, pairwise_distance

_MEMBER_ENTRIES = 1 << 25  # (query, row) membership entries per count-pass step
_GATHER_ELEMS = 1 << 26  # f32 elements of one [Q, rows, D] l2 difference block


def chunk_for(n_pad: int, q_pad: int, block: int) -> int:
    """Row-chunk width: ``block``, halved while the [Q, chunk] distance
    tile would exceed ~64 MB. Always divides ``n_pad`` (device columns pad
    to whole blocks; blocks are powers of two)."""
    chunk = min(block, n_pad)
    while chunk > 512 and chunk * q_pad > (1 << 24):
        chunk //= 2
    while n_pad % chunk:
        chunk //= 2
    return max(chunk, 1)


def _probe_member(codes: torch.Tensor, cells_sorted: torch.Tensor) -> torch.Tensor:
    """``[C]`` cell ids × ``[Q, P]`` per-query SORTED probe cells →
    ``[Q, C]`` membership, by a batched ``searchsorted``: O(Q·C·log P),
    no ``[Q, C, P]`` tensor."""
    q, p = cells_sorted.shape
    values = codes.to(cells_sorted.dtype)[None, :].expand(q, -1).contiguous()
    idx = torch.searchsorted(cells_sorted, values, out_int32=True)
    return torch.gather(cells_sorted, 1, idx.clamp_max(p - 1).long()) == values


def count_selected_mask(fmask: torch.Tensor, rows: int, *, chunk: int) -> torch.Tensor:
    """Selected rows per chunk of a filter-only selection
    (query-independent): ``[n_chunks]`` int32."""
    n_pad = fmask.shape[0]
    valid = torch.arange(n_pad, device=fmask.device) < rows
    return (fmask & valid).view(n_pad // chunk, chunk).sum(dim=1, dtype=torch.int32)


def count_selected_probed(
    fmask: "torch.Tensor | None",
    coded: torch.Tensor,
    cells_sorted: torch.Tensor,
    rows: int,
    *,
    chunk: int,
) -> torch.Tensor:
    """Selected rows per (chunk, query) with probe pruning: ``[n_chunks,
    Q]`` int32. ``fmask`` may be None (no filter). Membership is taken
    over spans of whole chunks, ``_MEMBER_ENTRIES`` entries at a time."""
    n_pad = coded.shape[0]
    q = cells_sorted.shape[0]
    base = torch.arange(n_pad, device=coded.device) < rows
    if fmask is not None:
        base &= fmask
    span = chunk * max(1, _MEMBER_ENTRIES // (q * chunk))
    counts = []
    for start in range(0, n_pad, span):
        stop = min(start + span, n_pad)
        member = _probe_member(coded[start:stop], cells_sorted) & base[None, start:stop]
        counts.append(member.view(q, (stop - start) // chunk, chunk).sum(dim=-1, dtype=torch.int32).T)
    return torch.cat(counts)


def distances(
    queries: torch.Tensor,  # [Q, D] f32
    rows: torch.Tensor,  # [R, D] f32
    metric: str,
    idx: "torch.Tensor | None" = None,  # [Q, W] row numbers into ``rows``
) -> torch.Tensor:
    """Distances of each query to ``rows[idx[j]]`` (``[Q, W]``), or to
    every row of ``rows`` (``[Q, R]``) when ``idx`` is None: the fp32
    product for cosine and dot, ``‖q − v‖`` for l2 (summed over D in
    fp32, in blocks of ``_GATHER_ELEMS``)."""
    metric = canonical_metric(metric)
    if metric != "l2":
        dist = pairwise_distance(queries, rows, metric)
        return dist if idx is None else torch.gather(dist, 1, idx)
    if idx is None:
        idx = torch.arange(rows.shape[0], device=rows.device).expand(queries.shape[0], -1)
    q, w = idx.shape
    step = max(1, _GATHER_ELEMS // max(1, q * rows.shape[1]))
    parts = []
    for start in range(0, w, step):
        diff = rows[idx[:, start : start + step]] - queries[:, None, :]
        parts.append(torch.sqrt(torch.sum(torch.square(diff), dim=-1)))
    return torch.cat(parts, dim=1) if parts else queries.new_empty((q, 0))


def compact_chunk(
    corpus: torch.Tensor,  # [N_pad, D]
    queries: torch.Tensor,  # [Q, D]
    fmask: "torch.Tensor | None",  # [N_pad] bool
    coded: "torch.Tensor | None",  # [N_pad] int32 cell ids
    cells_sorted: "torch.Tensor | None",  # [Q, P] int32, sorted per query
    start: int,  # the chunk's first row
    rows: int,  # real row count
    *,
    metric: str,
    chunk: int,
    width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Selected (global row ids, exact distances) of one row chunk:
    ``ids [Q, width]`` int64, ascending per query, −1 padding, and
    ``dists [Q, width]`` f32, +inf padding."""
    q = queries.shape[0]
    vblock = corpus[start : start + chunk]
    base = torch.arange(start, start + chunk, device=corpus.device) < rows
    if fmask is not None:
        base &= fmask[start : start + chunk]
    if coded is not None:
        mask = _probe_member(coded[start : start + chunk], cells_sorted) & base[None, :]
        idx, _ = relational.compact_indices(mask, width)
    else:  # the same rows for every query: compact once
        idx, _ = relational.compact_indices(base, width)
        idx = idx.expand(q, -1)
    got = idx < chunk
    safe = idx.clamp_max(chunk - 1).long()
    dist = distances(queries, vblock, metric, safe)
    ids = torch.where(got, safe + start, -1)
    return ids, torch.where(got, dist, torch.inf)
