"""Two-phase exact top-k search: bucket maxima → select → rescore.

Port of ``fenix_tpu/ops/topk2.py`` for PyTorch on a CUDA card.

**Phase 1** scores every corpus row against every query with the fused
score ``s = (q·v)·aux_mul + aux_add`` (one formula for all metrics;
filter and padding masks are −inf in ``aux_add``) and keeps only the
max of each ``bucket`` rows. On the card this is a hand-written kernel
for every query count and scan type (fp32, the bf16 scan copy, or the
per-row int8 copy), chosen by dtype and query count in
``ops/kernels.py``. CPU tensors take the kernels' plain PyTorch twin.

**Phase 2** selects the top ``k + pad`` buckets per query, gathers
their rows and rescores them exactly in fp32 (TF32 is off, see
``ops/__init__.py``), then takes the final top-k; an l2 distance is
taken as ``‖q − v‖`` of the winning row (the fused score's expanded
form cancels for near rows). While a capture is active its device time
is timed by a pair of CUDA events (``utils/profiling.device_timer``,
counter ``phase2.device_seconds``), for a caller that collects them.

**Phase A** of the int8-resident and streaming modes
(:func:`topk_window_int8`) stops after a narrowing rescore and returns a
window of candidate row ids for the host to rescore exactly.

Tie rule (the engine's contract): equal distances resolve to the
smallest row id. The reference inherits it from the stable
``lax.top_k``; ``torch.topk`` promises no order on ties, so both
selections here enforce it explicitly: the bucket selection keeps the
lowest bucket indices among maxima tied at the kp-th value, and the
final top-k is a stable descending sort over candidates laid out in
ascending row order.

Exactness: a bucket holding a true top-k row has a bucket max ≥ that
row's score, and at most k buckets hold values ≥ the k-th best, so the
top-k buckets cover the true top-k. The reference's int32 bitcast
result carrier (a TPU denormal workaround) is gone: results come back
as two small ``[Q, k]`` tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from fenix_tpu_torch.ops import kernels
from fenix_tpu_torch.ops.distance import NEG_INF, canonical_metric, normalize
from fenix_tpu_torch.utils import profiling

BUCKET = 128  # rows per bucket for small query batches
# Finer rescore granularity for big query batches: phase-2 gather
# traffic is kp·bucket·D per query.
BUCKET_LARGE_Q = 32
_BUCKET_SWITCH_Q = 64  # above this query count use BUCKET_LARGE_Q
BUCKET_PAD = 8  # extra buckets gathered for fp-rounding safety
_RESCORE_GATHER_CAP = 2 << 30  # phase-2 [chunk, kp, bucket, D] gather cap
_QUANTIZE_CHUNK_ROWS = 1 << 20  # bounds quantize temporaries to one chunk
PHASE2_COUNTER = "phase2.device_seconds"  # phase 2's device time, while a capture is active


# -- metric preparation ----------------------------------------------------


def prepare_queries(queries: torch.Tensor, metric: str) -> torch.Tensor:
    """Query-side transform so the phase-1 score is ``q'·v·aux_mul + aux_add``."""
    metric = canonical_metric(metric)
    if metric == "l2":
        return 2.0 * queries
    if metric == "cosine":
        return normalize(queries)
    return queries


def prepare_aux(
    corpus: torch.Tensor, mask: torch.Tensor | None, metric: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (aux_mul, aux_add) for the fused score.

    l2:     s = 2·q·v − ‖v‖²   (order = −dist² order)
    cosine: s = q̂·v / ‖v‖     (order = cos order)
    dot:    s = q·v
    Masked rows get aux_add = −inf."""
    metric = canonical_metric(metric)
    sq = torch.sum(torch.square(corpus), dim=-1)  # [N]
    if metric == "l2":
        aux_mul = torch.ones_like(sq)
        aux_add = -sq
    elif metric == "cosine":
        aux_mul = 1.0 / torch.clamp_min(torch.sqrt(sq), 1e-12)
        aux_add = torch.zeros_like(sq)
    else:
        aux_mul = torch.ones_like(sq)
        aux_add = torch.zeros_like(sq)
    if mask is not None:
        aux_add = torch.where(mask, aux_add, NEG_INF)
    return aux_mul, aux_add


def _quantize_rows(block: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(block.abs().amax(dim=-1) / 127.0, 1e-30)  # zero rows → zeros
    codes = torch.clamp(torch.round(block / scale[:, None]), -127, 127).to(torch.int8)
    return codes, scale


def quantize_corpus_int8(corpus: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization ``v ≈ sv · v8``: scale
    max|v|/127 with a 1e-30 floor, round half to even, clip to ±127.

    Returns (v8 [N, D] int8, sv [N] f32). Quantized in row chunks so the
    f32 temporaries stay one chunk in size. Scales may differ from the
    JAX package's by 1 ulp (XLA folds /127 into a reciprocal multiply);
    final distances are rescored in fp32 either way."""
    n, d = corpus.shape
    v8 = torch.empty((n, d), dtype=torch.int8, device=corpus.device)
    sv = torch.empty((n,), dtype=torch.float32, device=corpus.device)
    for start in range(0, n, _QUANTIZE_CHUNK_ROWS):
        stop = min(start + _QUANTIZE_CHUNK_ROWS, n)
        v8[start:stop], sv[start:stop] = _quantize_rows(corpus[start:stop])
    return v8, sv


def quantize_rows_int8_np(block) -> tuple[np.ndarray, np.ndarray]:
    """Host (numpy) quantizer with the semantics of
    :func:`quantize_corpus_int8` — a copy of the JAX package's
    ``quantize_rows_int8_np``, bit for bit, so a host int8 mirror (and
    its on-disk sidecar) is the same whichever package built it."""
    block = np.asarray(block, np.float32)
    sv = np.maximum(np.abs(block).max(axis=1, initial=0.0) / 127.0, 1e-30).astype(np.float32)
    v8 = np.clip(np.round(block / sv[:, None]), -127, 127).astype(np.int8)
    return v8, sv


def quantize_queries_int8(queries_p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric int8 quantization of *prepared* queries.

    Returns (q8 [Q, D] int8, inv_sq [Q] f32). Dividing ``aux_add`` by the
    per-query scale (multiplying by ``inv_sq``) instead of scaling the
    dot keeps each query's score order exact in real arithmetic."""
    q8, sq = _quantize_rows(queries_p)
    return q8, 1.0 / sq


def scores_to_distances(scores: torch.Tensor, queries: torch.Tensor, metric: str) -> torch.Tensor:
    """Exact distance from the fused score."""
    metric = canonical_metric(metric)
    if metric == "l2":
        uu = torch.sum(torch.square(queries), dim=-1, keepdim=True)  # [Q, 1]
        return torch.sqrt(torch.clamp_min(uu - scores, 0.0))
    if metric == "cosine":
        return 0.5 - 0.5 * scores
    return -scores


def bucket_for(q: int, n: int) -> int:
    """Rescore-bucket granularity for a (query count, corpus rows) pair."""
    bucket = BUCKET if q <= _BUCKET_SWITCH_Q else BUCKET_LARGE_Q
    while n % bucket != 0:
        bucket //= 2
    return bucket


# -- phase 1 + bucket selection ----------------------------------------------


def bucket_scores(
    queries_p: torch.Tensor,  # [Q, D] prepared f32
    corpus: torch.Tensor,  # [N, D] f32
    aux_mul: torch.Tensor,
    aux_add: torch.Tensor,
    bucket: int,
    corpus_scan: torch.Tensor | None = None,  # [N, D] bf16 copy
    corpus_scan_int8: tuple[torch.Tensor, torch.Tensor] | None = None,  # (v8, sv)
) -> torch.Tensor:  # [Q, N // bucket]
    """Phase-1 dispatch over the scan copies: fp32, bf16 or int8."""
    if corpus_scan_int8 is not None:
        v8, sv = corpus_scan_int8
        q8, inv_sq = quantize_queries_int8(queries_p)
        return kernels.bucket_scores(q8, v8, aux_mul * sv, aux_add, bucket, inv_sq=inv_sq)
    if corpus_scan is not None:
        q_scan = queries_p.to(corpus_scan.dtype).contiguous()
        return kernels.bucket_scores(q_scan, corpus_scan, aux_mul, aux_add, bucket)
    return kernels.bucket_scores(queries_p.contiguous(), corpus, aux_mul, aux_add, bucket)


def topk_buckets(bucket_max: torch.Tensor, kp: int) -> torch.Tensor:
    """Top-``kp`` bucket indices per query, in ascending index order.

    Flat selection: everything above the kp-th largest maximum, plus the
    lowest-index buckets tied at it — the set ``lax.top_k``'s stable
    order yields. (The reference's group hierarchy exists because
    top-k sorts on a TPU.)"""
    q, nb = bucket_max.shape
    thr = torch.topk(bucket_max, kp, dim=1).values[:, -1:]  # kp-th largest
    above = bucket_max > thr
    tie = bucket_max == thr
    room = kp - above.sum(dim=1, keepdim=True)
    keep = above | (tie & (torch.cumsum(tie, dim=1, dtype=torch.int32) <= room))
    return keep.nonzero()[:, 1].view(q, kp)


# -- phase 2: gather + exact rescore -------------------------------------------


def topk_two_phase(
    corpus: torch.Tensor,  # [N_pad, D] f32
    queries: torch.Tensor,  # [Q, D] f32
    aux_mul: torch.Tensor,  # [N_pad]
    aux_add: torch.Tensor,  # [N_pad]  (−inf on masked/padding rows)
    k: int,
    metric: str,
    corpus_scan: torch.Tensor | None = None,
    corpus_scan_int8: tuple[torch.Tensor, torch.Tensor] | None = None,
    with_scores: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Exact top-k: (distances [Q, k], row ids [Q, k]; +inf / −1 padding),
    in (score desc, row id asc) order.

    ``corpus_scan`` substitutes a bf16 copy for phase 1 and
    ``corpus_scan_int8`` a ``(v8, sv)`` pair from
    :func:`quantize_corpus_int8`. Phase 2 always rescores against the
    fp32 ``corpus``, so returned distances are fp32-exact; only bucket
    selection sees the scan precision (int8 doubles the margin).
    ``with_scores`` also returns the fused scores ``[Q, k]`` (−inf
    padding), the key a caller merging several calls must order by: l2
    distances are recomputed as ‖q − v‖ and need not follow the score
    order at near ties."""
    metric = canonical_metric(metric)
    n, d = corpus.shape
    q = queries.shape[0]
    bucket = bucket_for(q, n)
    n_buckets = n // bucket
    queries_p = prepare_queries(queries, metric)

    pad = BUCKET_PAD * 2 if corpus_scan_int8 is not None else BUCKET_PAD
    kp = min(k + pad, n_buckets)
    bucket_max = bucket_scores(
        queries_p, corpus, aux_mul, aux_add, bucket, corpus_scan, corpus_scan_int8
    )
    with profiling.device_timer(PHASE2_COUNTER, corpus.device):
        bidx = topk_buckets(bucket_max, kp)  # ascending → candidates in row order
        del bucket_max
        out = _rescore(corpus, queries, queries_p, aux_mul, aux_add, bidx, bucket, k, metric)
    return out if with_scores else out[:2]


def _rescore(
    corpus: torch.Tensor,  # [N_pad, D] f32
    queries: torch.Tensor,  # [Q, D] f32
    queries_p: torch.Tensor,  # [Q, D] prepared
    aux_mul: torch.Tensor,
    aux_add: torch.Tensor,
    bidx: torch.Tensor,  # [Q, kp] selected buckets, ascending
    bucket: int,
    k: int,
    metric: str,
    probe: "tuple[torch.Tensor, torch.Tensor] | None" = None,  # (coded [N_pad], cells [Q, P])
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 2: gather the selected buckets' rows, rescore them fp32-true,
    and take the top-k by (score desc, row id asc); with ``probe``, rows
    whose cell is not among the query's probe cells score −inf. Returns
    (dist, ids, scores)."""
    n, d = corpus.shape
    q, kp = bidx.shape
    n_buckets = n // bucket
    rows = corpus.view(n_buckets, bucket, d)
    mul_b = aux_mul.view(n_buckets, bucket)
    add_b = aux_add.view(n_buckets, bucket)
    kk = min(k, kp * bucket)
    lane = torch.arange(bucket, device=corpus.device)

    # Chunk the [chunk, kp, bucket, D] candidate gather against the cap.
    per_query = kp * bucket * d * 4
    chunk = max(1, min(q, max(64, _RESCORE_GATHER_CAP // per_query)))
    top_s, top_ids, top_d = [], [], []
    for start in range(0, q, chunk):
        qp_c = queries_p[start : start + chunk]
        b_c = bidx[start : start + chunk]
        c = qp_c.shape[0]
        # Elementwise product + sum: fp32-true, and identical rows score
        # identically wherever they sit (a blocked GEMM may sum in a
        # position-dependent order, which would break exact ties).
        s = (rows[b_c] * qp_c[:, None, None, :]).sum(dim=-1)  # [C, kp, bucket]
        s = (s * mul_b[b_c] + add_b[b_c]).reshape(c, kp * bucket)
        ids = (b_c[:, :, None] * bucket + lane).reshape(c, kp * bucket)
        if probe is not None:
            coded, cells = probe
            ok = probe_member(coded[ids], cells[start : start + chunk])
            s = s.masked_fill(~ok, NEG_INF)
        s_sorted, pos = torch.sort(s, dim=1, descending=True, stable=True)
        sel = torch.gather(ids, 1, pos[:, :kk])
        top_s.append(s_sorted[:, :kk])
        top_ids.append(sel)
        if metric == "l2":
            # ‖q − v‖ of the winning rows: the expanded ‖q‖² − s cancels
            # for near rows (about 1e-4 relative at D=768)
            diff = corpus[sel] - queries[start : start + chunk, None, :]
            top_d.append(torch.sqrt(torch.sum(torch.square(diff), dim=-1)))
    top_s = torch.cat(top_s) if top_s else corpus.new_empty((0, kk))
    top_ids = torch.cat(top_ids) if top_ids else lane.new_empty((0, kk))
    if metric != "l2":
        dist = scores_to_distances(top_s, queries, metric)
    else:
        dist = torch.cat(top_d) if top_d else corpus.new_empty((0, kk))
    return _finish(top_s, top_ids, dist, k)


def _finish(
    top_s: torch.Tensor, top_ids: torch.Tensor, dist: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad ``[Q, kk]`` winners to ``k`` and mark the −inf ones as
    (+inf, −1): (dist, ids, scores)."""
    q, kk = top_s.shape
    if kk < k:  # pad to k
        top_s = torch.cat([top_s, top_s.new_full((q, k - kk), NEG_INF)], dim=1)
        top_ids = torch.cat([top_ids, top_ids.new_full((q, k - kk), -1)], dim=1)
        dist = torch.cat([dist, dist.new_full((q, k - kk), torch.inf)], dim=1)
    missing = top_s == NEG_INF
    dist = torch.where(missing, torch.inf, dist)
    top_ids = torch.where(missing, -1, top_ids)
    return dist, top_ids, top_s


def topk_window_int8(
    v8: torch.Tensor,  # [N_pad, D] int8 scan copy
    sv: torch.Tensor,  # [N_pad] f32 per-row scale
    queries: torch.Tensor,  # [Q, D] f32
    aux_mul: torch.Tensor,  # [N_pad] f32
    aux_add: torch.Tensor,  # [N_pad] f32 (−inf on masked/padding rows)
    k: int,
    w: int,
    metric: str,
) -> torch.Tensor:  # [Q, ww] int64 row ids
    """Phase A of the int8-resident (host-rescore) search: int8 phase-1
    bucket maxima (the K2 kernel), selection of ``kp`` candidate buckets,
    a narrowing rescore of their rows (f32 prepared query × dequantized
    int8 row, with the exact per-row aux), and the top-``ww`` row ids
    per query, ``ww = min(w, kp·bucket)`` (callers read the width from
    the shape). The host gathers these rows from the fp32 corpus and
    rescores them exactly (``engine/residency.py``).

    The window may hold masked or padding rows when fewer than ``ww``
    candidates score above −inf; the host rescore re-applies validity.
    Ties keep the smallest row ids (stable sort over candidates in
    ascending bucket order), as the reference's stable ``lax.top_k``.
    The narrowing score is fp32-true (elementwise product + sum, TF32
    off), where the reference's einsum runs one bf16 pass on a TPU."""
    metric = canonical_metric(metric)
    n, d = v8.shape
    q = queries.shape[0]
    queries_p = prepare_queries(queries, metric)
    ams = aux_mul * sv

    bucket = bucket_for(q, n)
    n_buckets = n // bucket
    # enough buckets to fill the window, plus the int8 selection margin
    kp = min(max(k, -(-w // bucket)) + 2 * BUCKET_PAD, n_buckets)
    ww = min(w, kp * bucket)
    bucket_max = bucket_scores(queries_p, v8, aux_mul, aux_add, bucket, corpus_scan_int8=(v8, sv))
    bidx = topk_buckets(bucket_max, kp)  # ascending → candidates in row order
    del bucket_max

    rows8 = v8.view(n_buckets, bucket, d)
    mul_b = ams.view(n_buckets, bucket)
    add_b = aux_add.view(n_buckets, bucket)
    lane = torch.arange(bucket, device=v8.device)
    # the [C, kp, bucket, D] gather widens to f32: chunk it against the cap
    per_query = kp * bucket * d * 4
    chunk = min(q, max(8, _RESCORE_GATHER_CAP // per_query))
    wins = []
    for start in range(0, q, max(chunk, 1)):
        qp_c = queries_p[start : start + chunk]
        b_c = bidx[start : start + chunk]
        c = qp_c.shape[0]
        cand = rows8[b_c].to(torch.float32)  # [C, kp, bucket, D]
        s = cand.mul_(qp_c[:, None, None, :]).sum(dim=-1)  # in place: one f32 copy
        del cand
        s = (s * mul_b[b_c] + add_b[b_c]).reshape(c, kp * bucket)
        ids = (b_c[:, :, None] * bucket + lane).reshape(c, kp * bucket)
        pos = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :ww]
        wins.append(torch.gather(ids, 1, pos))
    return torch.cat(wins) if wins else lane.new_empty((0, ww))


# -- IVF: probed search -------------------------------------------------------

# The masked scan's row chunk keeps its [QT, rows] score tile, and an int8
# chunk widened to f32, under these sizes; a [cells, QT] probe table is
# built when it has at most _PROBE_TABLE_CAP entries, else each query's
# sorted probe list is searched.
_PROBED_TILE = 64 << 20  # score entries (256 MiB of f32)
_PROBED_WIDEN_BYTES = 256 << 20
_PROBE_TABLE_CAP = 64 << 20


def probe_member(codes: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """``codes[c, w] ∈ cells[c]`` as ``[C, W]`` bool, through each row's
    sorted probe list (memory ∝ C·W, whatever P is). A −1 code (padding)
    and a −1 probe slot never match."""
    srt = torch.sort(cells, dim=1).values
    codes = codes.to(srt.dtype).contiguous()
    pos = torch.searchsorted(srt, codes).clamp_max_(srt.shape[1] - 1)
    return (torch.gather(srt, 1, pos) == codes) & (codes >= 0)


def _probe_rows(cells: torch.Tensor):
    """``member(codes [rows]) → [QT, rows]`` bool: row ``i`` belongs to
    query ``q``'s probes. The probed cells are compacted (``unique``) into
    a ``[cells + 1, QT]`` table when that is small (at 1,024 queries × 64
    probes at most 64 Mi entries), so a row chunk costs one gather of
    table rows; otherwise the per-query sorted search of
    :func:`probe_member`."""
    qt = cells.shape[0]
    live = cells >= 0
    uniq = torch.unique(cells[live])  # sorted
    u = uniq.numel()
    if u == 0:
        return lambda codes: torch.zeros((qt, codes.shape[0]), dtype=torch.bool, device=codes.device)
    if (u + 1) * qt > _PROBE_TABLE_CAP:
        return lambda codes: probe_member(codes.expand(qt, -1), cells)
    table = torch.zeros((u + 1, qt), dtype=torch.bool, device=cells.device)  # row u: probed by none
    q_idx = torch.arange(qt, device=cells.device)[:, None].expand_as(cells)
    table[torch.searchsorted(uniq, cells[live]), q_idx[live]] = True

    def member(codes: torch.Tensor) -> torch.Tensor:
        codes = codes.to(uniq.dtype)
        pos = torch.searchsorted(uniq, codes).clamp_max_(u - 1)
        row = torch.where(uniq[pos] == codes, pos, u)
        return table[row].T

    return member


def _int8_products(q8: torch.Tensor, v8: torch.Tensor) -> torch.Tensor:
    """``Q8 · V8ᵀ`` as f32 of the exact integer sums. Up to D = 1024 an
    f32 product of int8 values is exact (127²·1024 < 2²⁴, every partial
    sum an integer f32 holds); wider rows sum exact 1024-wide slices in
    int32, then convert, as the JAX package's int32 accumulate does."""
    d = q8.shape[1]
    if d <= 1024:
        return q8.float() @ v8.float().T
    acc = None
    for lo in range(0, d, 1024):
        part = (q8[:, lo : lo + 1024].float() @ v8[:, lo : lo + 1024].float().T).to(torch.int32)
        acc = part if acc is None else acc.add_(part)
    return acc.float()


def bucket_scores_scan_probed(
    queries_p: torch.Tensor,  # [QT, D] prepared f32 / bf16 / q8 (int8)
    corpus: torch.Tensor,  # [N, D] f32 / bf16 scan copy / v8 (int8)
    aux_mul: torch.Tensor,  # [N] (int8: aux_mul · sv, the corpus scale folded in)
    aux_add: torch.Tensor,  # [N]
    coded: torch.Tensor,  # [N] int32 cell ids (−1 padding)
    cells: torch.Tensor,  # [QT, P] per-query probe cells (−1 padding)
    bucket: int = BUCKET,
    inv_sq: torch.Tensor | None = None,  # [QT] int8: per-query 1/scale
) -> torch.Tensor:  # [QT, N // bucket] f32
    """Phase 1 with each query's probe mask: the fused score of every row,
    −inf where ``coded[row] ∉ cells[q]``, max per bucket.

    Score forms, as the JAX package's scan: fp32 is an fp32 product
    (TF32 off); a bf16 corpus gives bf16 scores and a bf16 epilogue
    (selection only, inside the margin); int8 is ``f32(Σ q8·v8)·(aux_mul·sv)
    + aux_add·inv_sq`` with exact integer sums. Torch ops over row chunks
    bounded by ``_PROBED_TILE``: no kernel of the JAX package computes
    this (XLA fuses it there)."""
    n, d = corpus.shape
    qt = queries_p.shape[0]
    int8_mode = corpus.dtype == torch.int8
    rows = min(_PROBED_TILE // max(qt, 1), _PROBED_WIDEN_BYTES // (4 * d))
    rows = max(bucket, rows // bucket * bucket)
    member = _probe_rows(cells)
    out = torch.empty((qt, n // bucket), dtype=torch.float32, device=corpus.device)
    for start in range(0, n, rows):
        stop = min(start + rows, n)
        mul, add = aux_mul[start:stop], aux_add[start:stop]
        if int8_mode:
            s = _int8_products(queries_p, corpus[start:stop])
            s = s * mul + add * inv_sq[:, None]
        elif corpus.dtype == torch.bfloat16:
            s = queries_p @ corpus[start:stop].T  # bf16 scores
            s = s * mul.to(torch.bfloat16) + add.to(torch.bfloat16)
        else:
            s = (queries_p @ corpus[start:stop].T).mul_(mul).add_(add)
        s.masked_fill_(~member(coded[start:stop]), NEG_INF)
        out[:, start // bucket : stop // bucket] = s.view(qt, -1, bucket).amax(dim=-1)
    return out


def topk_two_phase_probed(
    corpus: torch.Tensor,  # [N_pad, D] f32
    queries: torch.Tensor,  # [Q, D] f32
    aux_mul: torch.Tensor,
    aux_add: torch.Tensor,
    coded: torch.Tensor,  # [N_pad] int32 (−1 on padding)
    cells: torch.Tensor,  # [Q, P] int32 probe cells per query (−1 padding)
    k: int,
    metric: str,
    corpus_scan: torch.Tensor | None = None,
    corpus_scan_int8: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probed (IVF) exact-within-probes top-k, two-phase: the masked scan
    (:func:`bucket_scores_scan_probed`) over the fp32 corpus or a bf16 /
    int8 scan copy, the bucket selection, and the fp32-true rescore with
    the probe mask re-applied. Only selection sees the scan precision
    (int8 doubles the margin); ties go to the smaller row id."""
    metric = canonical_metric(metric)
    n, _ = corpus.shape
    q = queries.shape[0]
    bucket = bucket_for(q, n)
    queries_p = prepare_queries(queries, metric)
    if corpus_scan_int8 is not None:
        v8, sv = corpus_scan_int8
        q8, inv_sq = quantize_queries_int8(queries_p)
        bucket_max = bucket_scores_scan_probed(
            q8, v8, aux_mul * sv, aux_add, coded, cells, bucket, inv_sq=inv_sq
        )
    elif corpus_scan is not None:
        bucket_max = bucket_scores_scan_probed(
            queries_p.to(corpus_scan.dtype), corpus_scan, aux_mul, aux_add, coded, cells, bucket
        )
    else:
        bucket_max = bucket_scores_scan_probed(
            queries_p, corpus, aux_mul, aux_add, coded, cells, bucket
        )
    pad = BUCKET_PAD * 2 if corpus_scan_int8 is not None else BUCKET_PAD
    with profiling.device_timer(PHASE2_COUNTER, corpus.device):
        bidx = topk_buckets(bucket_max, min(k + pad, n // bucket))
        del bucket_max
        out = _rescore(
            corpus, queries, queries_p, aux_mul, aux_add, bidx, bucket, k, metric, probe=(coded, cells)
        )
    return out[:2]


def _topk_min_id(
    s: torch.Tensor, ids: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`topk_values_min_id`, plus the position of each pick in ``s``."""
    big = torch.iinfo(torch.int32).max
    s = s.clone()
    valid = ids >= 0
    vals, sids, where = [], [], []
    for _ in range(k):
        m = s.amax(dim=1)  # [C]
        tie = s == m[:, None]
        sel = torch.where(tie & valid, ids, big).amin(dim=1)
        hit = tie & (ids == sel[:, None])
        where.append(hit.to(torch.uint8).argmax(dim=1))  # the first hit
        s.masked_fill_(hit, NEG_INF)
        vals.append(m)
        sids.append(sel)
    c = s.shape[0]
    if not vals:
        empty = ids.new_empty((c, 0))
        return s.new_empty((c, 0)), empty, empty.long()
    sids = torch.stack(sids, dim=1)
    return torch.stack(vals, dim=1), torch.where(sids == big, -1, sids), torch.stack(where, dim=1)


def topk_values_min_id(
    s: torch.Tensor, ids: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by (score desc, id asc) — the engine's tie contract,
    whatever the candidates' order: k rounds of the max score, then the
    smallest id among the rows tying at it. Returns ``(values [C, k], ids
    [C, k])``, −1 where no valid id tied."""
    vals, sids, _ = _topk_min_id(s, ids, k)
    return vals, sids


def topk_ivf_clustered(
    corpus_s: torch.Tensor,  # [N_pad, D] rows sorted by cell id
    queries: torch.Tensor,  # [Q, D]
    aux_mul_s: torch.Tensor,  # [N_pad] (sorted order)
    aux_add_s: torch.Tensor,  # [N_pad] (sorted order; −inf on masked/padding rows)
    coded_s: torch.Tensor,  # [N_pad] int32 cell ids, sorted (−1 padding)
    orig_ids_s: torch.Tensor,  # [N_pad] int32 original row id per position (−1 padding)
    cells: torch.Tensor,  # [Q, P] int32 probe cells per query
    bucket_lists: torch.Tensor,  # [Q, B] int32 bucket indices (−1 padding)
    k: int,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probed top-k over the IVF-clustered layout, with no corpus scan:
    with rows sorted by cell id, a query's probed cells are at most P
    contiguous ranges, and ``bucket_lists`` (host-computed from the cell
    offsets) names the buckets covering them. Only those buckets are
    gathered and rescored fp32-true; rows of neighbouring cells in the
    boundary buckets are masked by probe membership. Returns ORIGINAL row
    ids ordered by (distance asc, id asc): the min-id rounds of
    :func:`topk_values_min_id` tie on original ids, so the answer equals
    the masked scan's."""
    metric = canonical_metric(metric)
    n, d = corpus_s.shape
    q = queries.shape[0]
    bucket = bucket_for(q, n)
    n_buckets = n // bucket
    queries_p = prepare_queries(queries, metric)
    kp = bucket_lists.shape[1]
    bucket_ok = bucket_lists >= 0
    bidx = torch.where(bucket_ok, bucket_lists, 0).long()

    rows = corpus_s.view(n_buckets, bucket, d)
    mul_b = aux_mul_s.view(n_buckets, bucket)
    add_b = aux_add_s.view(n_buckets, bucket)
    kk = min(k, kp * bucket)
    lane = torch.arange(bucket, device=corpus_s.device)

    per_query = kp * bucket * d * 4
    chunk = max(1, min(q, max(8, _RESCORE_GATHER_CAP // per_query)))
    top_s, top_ids, top_d = [], [], []
    for start in range(0, q, chunk):
        qp_c = queries_p[start : start + chunk]
        b_c = bidx[start : start + chunk]
        c = qp_c.shape[0]
        s = (rows[b_c] * qp_c[:, None, None, :]).sum(dim=-1)  # [C, kp, bucket], fp32-true
        s = (s * mul_b[b_c] + add_b[b_c]).reshape(c, kp * bucket)
        pos = (b_c[:, :, None] * bucket + lane).reshape(c, kp * bucket)  # sorted positions
        ok = probe_member(coded_s[pos], cells[start : start + chunk])
        ok &= bucket_ok[start : start + chunk, :, None].expand(c, kp, bucket).reshape(c, -1)
        s.masked_fill_(~ok, NEG_INF)
        vals, sids, where = _topk_min_id(s, orig_ids_s[pos], kk)
        top_s.append(vals)
        top_ids.append(sids)
        if metric == "l2":
            # ‖q − v‖ of the winners, as topk_two_phase returns it
            diff = corpus_s[torch.gather(pos, 1, where)] - queries[start : start + chunk, None, :]
            top_d.append(torch.sqrt(torch.sum(torch.square(diff), dim=-1)))
    top_s = torch.cat(top_s) if top_s else corpus_s.new_empty((0, kk))
    top_ids = torch.cat(top_ids) if top_ids else orig_ids_s.new_empty((0, kk))
    if metric != "l2":
        dist = scores_to_distances(top_s, queries, metric)
    else:
        dist = torch.cat(top_d) if top_d else corpus_s.new_empty((0, kk))
    return _finish(top_s, top_ids, dist, k)[:2]


def state_from_numpy(
    corpus,
    aux_mul,
    aux_add,
    v8=None,
    sv=None,
    *,
    device: str | torch.device,
):
    """The JAX package's search state, taken as numpy arrays (e.g.
    ``np.asarray`` of ``fenix_tpu.ops.topk2.prepare_aux`` and
    ``quantize_corpus_int8`` outputs), as this package's tensors on
    ``device``: ``(corpus, aux_mul, aux_add, corpus_scan_int8)`` where the
    last is ``(v8, sv)`` or None. Lets one state feed both packages."""
    def put(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    scan_int8 = None
    if v8 is not None:
        scan_int8 = (put(v8, torch.int8), put(sv, torch.float32))
    return (
        put(corpus, torch.float32),
        put(aux_mul, torch.float32),
        put(aux_add, torch.float32),
        scan_int8,
    )
