"""Residency planning and the host-corpus serving modes — port of
``fenix_tpu/engine/residency.py`` (its single-device half).

``dual``   the fp32 corpus (plus the optional bf16/int8 scan copy)
           resident on the device; picked whenever it fits
           (``engine/executor.py`` serves it).
``int8``   int8-resident: only the int8 copy and 16 B/row of aux live
           on the device, built without any device fp32
           (``session.int8_solo``). Device phase A returns a top-W window
           per query (``topk2.topk_window_int8``, the K2 kernel); the host
           gathers those rows from the memory-mapped fp32 corpus and
           rescores them exactly.
``stream`` larger than device memory: the host corpus moves through the
           device in double-buffered chunks (``io.batch.prefetch_to_device``).
           fp32 chunks run the exact two-phase search (the K1 kernel) and
           the host merges them by (score, id); ``precision="int8"``
           streams the host int8 mirror, each chunk gives a window, and
           one host rescore covers their union.

``plan`` picks the mode from host metadata alone: "auto" takes the
first that fits ``FENIX_HBM_BUDGET`` (or the card's memory, see
``utils/hbm.py``); "dual" / "int8" / "stream" force one.

Probed (IVF) requests over a host corpus run on the host, no device
involved (``probed_topk``, and the probed branch of
``execute_nomax_host``): each probed cell is a contiguous slice of the
cell-sorted host layouts (``session.host_clustered_int8`` and its IVF
sidecar, ``session.host_cell_meta``). ``execute_many`` serves a list of compatible top-k requests
in one pass: a micro-batch (``executor.execute_search_batched``), a
lone request being a batch of one. ``maxval=None`` over a host corpus is
``execute_nomax_host``.

Over a mesh (``DeviceCache.mesh``) the modes compose with the row split,
and the budget is per device: ``plan`` compares each device's slice
(1/S of the padded corpus) with it. The int8-resident mode holds 1/S of
the int8 copy on each device (``session.sharded_int8_solo``) and
concatenates the shards' phase-A windows (global ids) before the host
rescore; the stream uploads each chunk row-sharded, S times the
per-device chunk, so every device scans 1/S of every chunk, and merges
the shards' candidates (``parallel/search.py``) before the host merge.

Counters (``stats``): ``search.residency_int8``,
``search.residency_stream``, ``search.stream_chunks``,
``search.residency_host_nomax``, ``search.residency_probed_host`` (the
reference's names), and
``residency.phase_a_seconds`` (host wall time of the device calls, each
ending in the device→host copy of its result),
``residency.rescore_seconds`` (host gather + exact rescore), split into
``residency.rescore_gather_seconds`` (the row gathers) and
``residency.rescore_score_seconds`` (the rest: scores, order, distances),
and ``residency.rescore_rows`` (candidate rows rescored: Q × window).
While a capture is active on a card, ``residency.phase_a_device_seconds``
times the int8-resident phase A on the card by a pair of CUDA events,
read once the window's copy to the host has synchronised.

Spans (``utils/profiling``, recorded while a capture is active):
``residency.int8`` (the int8-resident search) ⊃ ``residency.phase_a``
(the device call and the window's copy) and ``residency.rescore`` (every
mode's host rescore) ⊃ ``residency.gather``, ``residency.score``, one
pair a query block.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, Sequence

import numpy as np
import pyarrow as pa
import torch

from fenix_tpu_torch import native
from fenix_tpu_torch.engine import executor  # circular: used at call time only
from fenix_tpu_torch.io import batch as batch_io
from fenix_tpu_torch.io import ingest
from fenix_tpu_torch.ops import distance as distance_ops
from fenix_tpu_torch.ops import topk2
from fenix_tpu_torch.parallel import mesh as mesh_mod
from fenix_tpu_torch.parallel import search as psearch
from fenix_tpu_torch.utils import hbm, profiling
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

DUAL = "dual"
INT8 = "int8"
STREAM = "stream"
_MODES = ("auto", DUAL, INT8, STREAM)

# fraction of the budget the router plans into (headroom for queries,
# results and transient staging)
_SAFETY = 0.9
# default phase-A window per query (FENIX_RESCORE_WINDOW or the
# request's extra {"window": ...} overrides it)
_DEFAULT_WINDOW = 4096
# float64 bytes of one block of gathered rows in the host l2 read
_NOMAX_BLOCK_BYTES = 128 << 20
PHASE_A_DEVICE_COUNTER = "residency.phase_a_device_seconds"  # while a capture is active
# largest buffer of gathered rows the host rescore keeps between calls
_SCRATCH_BYTES = 2 << 30


def plan(cache, req) -> str:
    """Pick the residency mode for a request from host metadata only
    (no device tensors are built to decide)."""
    forced = getattr(req, "residency", "auto") or "auto"
    if forced not in _MODES:
        raise ValueError(f"unknown residency {forced!r}; one of {_MODES}")
    if forced != "auto":
        return forced

    budget = hbm.budget_bytes(cache.device)
    if budget is None:
        return DUAL

    data = cache.host_table(req.source)
    dim = ingest.vector_field_type(data.schema.field(req.column)).list_size
    n_pad = max(ingest.round_up(data.num_rows, cache.block), cache.block)
    n_dev = 1
    if cache.mesh is not None:
        # the budget is per device: compare each device's slice with it
        n_pad, _ = mesh_mod.shard_rows(data.num_rows, cache.mesh, cache.block)
        n_dev = cache.mesh.size
    fp32 = 4 * n_pad * dim
    scan_extra = {"fp32": 0, "bf16": 2 * n_pad * dim, "int8": n_pad * dim}[req.precision]
    avail = _SAFETY * budget
    if (fp32 + scan_extra + 16 * n_pad) // n_dev <= avail:
        return DUAL
    # past here dual cannot fit: int8-resident when the int8 copy fits,
    # streaming otherwise
    if req.maxval is not None and (n_pad * dim + 16 * n_pad) // n_dev <= avail:
        return INT8
    return STREAM


# -- host-side exact rescore ----------------------------------------------


def _prepare_queries_np(queries: np.ndarray, metric: str) -> np.ndarray:
    """numpy form of ``topk2.prepare_queries``."""
    if metric == "l2":
        return 2.0 * queries
    if metric == "cosine":
        norm = np.sqrt(np.square(queries).sum(axis=-1, keepdims=True))
        return queries / np.maximum(norm, 1e-12)
    return queries


def _scores_to_distances_np(scores, queries, metric: str):
    """numpy form of ``topk2.scores_to_distances``."""
    if metric == "l2":
        uu = np.square(queries).sum(axis=-1, keepdims=True)
        return np.sqrt(np.maximum(uu - scores, 0.0))
    if metric == "cosine":
        return 0.5 - 0.5 * scores
    return -scores


class _RowScratch:
    """The one buffer the host rescore gathers its candidate rows into,
    kept between calls. A fresh ``[64, W, D]`` block (1.6 GB at W = 4,096,
    D = 1,536) is faulted in page by page on every dispatch: on an H100
    host that was 70–80 % of the gather's time and most of its spread from
    run to run. One rescore at a time holds it (a concurrent one allocates
    its own); it grows to the largest block asked for, up to
    ``_SCRATCH_BYTES``, and is never freed."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._buf = np.empty(0, np.float32)

    @contextlib.contextmanager
    def lend(self) -> "Iterator[_RowScratch | None]":
        """The scratch for the block, or None while another rescore holds it."""
        if not self._lock.acquire(blocking=False):
            yield None
            return
        try:
            yield self
        finally:
            self._lock.release()

    def rows(self, n: int, d: int) -> "np.ndarray | None":
        """An ``[n, d]`` float32 view of the buffer (the holder's alone), or
        None past ``_SCRATCH_BYTES``."""
        if 4 * n * d > _SCRATCH_BYTES:
            return None
        if self._buf.size < n * d:
            self._buf = np.empty(n * d, np.float32)
        return self._buf[: n * d].reshape(n, d)


_SCRATCH = _RowScratch()


def _gather_rows(host: np.ndarray, ids: np.ndarray, spent: list, out: "np.ndarray | None" = None) -> np.ndarray:
    """``native.gather_rows`` (into ``out`` when given) in a
    ``residency.gather`` span, its wall seconds added to ``spent[0]``."""
    with profiling.annotate("residency.gather", counter="residency.rescore_gather") as span:
        out = native.gather_rows(host, ids, out=out)
    spent[0] += span.seconds
    return out


def _host_rescore_topk(
    host: np.ndarray,  # [N, D] fp32
    aux_mul: np.ndarray,  # [N] f32
    aux_add: np.ndarray,  # [N] f32
    mask: "np.ndarray | None",  # [N] bool or None
    queries: np.ndarray,  # [Q, D] fp32
    win: np.ndarray,  # [Q, W] candidate row ids (may be invalid)
    rows: int,
    k: int,
    metric: str,
    q_block: int = 64,
    spent: "list | None" = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact fp32 rescore + top-k over per-query candidate windows, on
    the host: a threaded row gather (``native.gather_rows``) and one
    einsum per query block, ordered by (score desc, id asc), i.e.
    (distance asc, id asc). Returns (dist [Q, k] f32, ids [Q, k] int32;
    +inf / −1 padding). ``spent[0]`` gains the gathers' wall seconds. The
    rows of each block are gathered into ``_SCRATCH`` when it is free.

    The reference's code, with one change: an l2 distance is returned as
    ``‖q − v‖`` of the winning row, not as ``sqrt(‖q‖² − s)``. The
    expanded form cancels for near rows (on an H100 host at D=768 it came
    out 1.8e-4 relative off float64 for noisy copies of corpus rows); the
    order stays the score's."""
    spent = [0.0] if spent is None else spent
    with _SCRATCH.lend() as scratch:
        return _rescore_blocks(host, aux_mul, aux_add, mask, queries, win, rows, k, metric, q_block, spent,
                               scratch)


def _rescore_blocks(host, aux_mul, aux_add, mask, queries, win, rows, k, metric, q_block, spent, scratch):
    qt, w = win.shape
    qp = _prepare_queries_np(queries, metric)
    out_d = np.empty((qt, k), np.float32)
    out_i = np.empty((qt, k), np.int32)

    for s in range(0, qt, q_block):
        e = min(s + q_block, qt)
        wb = win[s:e]
        flat = wb.reshape(-1)
        valid = (flat >= 0) & (flat < rows)
        safe = np.where(valid, flat, 0).astype(np.int64)
        buf = scratch.rows(safe.shape[0], host.shape[1]) if scratch is not None else None
        cand = _gather_rows(host, safe, spent, buf).reshape(e - s, w, host.shape[1])
        with profiling.annotate("residency.score"):
            sc = np.einsum("qd,qwd->qw", qp[s:e], cand, dtype=np.float32, optimize=True)
            sc = sc * aux_mul[safe].reshape(e - s, w) + aux_add[safe].reshape(e - s, w)
            ok = valid.reshape(e - s, w)
            if mask is not None:
                ok = ok & mask[safe].reshape(e - s, w)
            sc = np.where(ok, sc, -np.inf)

            kk = min(k, w)
            part = np.argpartition(-sc, kk - 1, axis=1)[:, :kk]
            ps = np.take_along_axis(sc, part, axis=1)
            pi = np.take_along_axis(wb, part, axis=1)
            # (score desc, id asc) with the query-block row as the major key:
            # one sort for the whole block
            qb = e - s
            flat_order = np.lexsort((pi.ravel(), -ps.ravel(), np.repeat(np.arange(qb), kk))).reshape(
                qb, kk
            )
            order = flat_order - (np.arange(qb) * kk)[:, None]
            top_s = np.take_along_axis(ps, order, axis=1)
            top_i = np.take_along_axis(pi, order, axis=1)
            dead = ~np.isfinite(top_s)  # invalid, masked or padding candidates
        if metric == "l2":
            winners = _gather_rows(host, np.where(dead, 0, top_i).ravel(), spent)
            diff = winners.reshape(qb, kk, -1) - queries[s:e, None, :]
            dist = np.sqrt(np.square(diff).sum(axis=-1, dtype=np.float32))
        else:
            dist = _scores_to_distances_np(top_s, queries[s:e], metric)
        dist[dead] = np.inf
        top_i = np.where(dead, -1, top_i).astype(np.int32)
        if kk < k:
            dist = np.concatenate([dist, np.full((qb, k - kk), np.inf, np.float32)], axis=1)
            top_i = np.concatenate([top_i, np.full((qb, k - kk), -1, np.int32)], axis=1)
        out_d[s:e] = dist[:, :k]
        out_i[s:e] = top_i[:, :k]
    return out_d, out_i


def _timed_rescore(host, hmul, hadd, mask, stacked, win, *args) -> tuple[np.ndarray, np.ndarray]:
    """``_host_rescore_topk`` in the ``residency.rescore`` span: its wall
    seconds, and their split into the row gathers and the rest, which add
    up to them; the candidate rows it rescored."""
    spent = [0.0]
    with profiling.annotate("residency.rescore", counter="residency.rescore") as span:
        out = _host_rescore_topk(host, hmul, hadd, mask, stacked, win, *args, spent=spent)
    METRICS.add("residency.rescore_score_seconds", span.seconds - spent[0])
    METRICS.add("residency.rescore_rows", win.size)
    return out


def _host_mask(cache, req) -> "np.ndarray | None":
    return cache.host_filter_mask(req.source, req.filter) if req.filter is not None else None


# -- int8-resident execution ----------------------------------------------


def _request_window(req, n_pad: int, k_pad: int) -> int:
    w = int((req.extra or {}).get("window") or os.environ.get("FENIX_RESCORE_WINDOW", _DEFAULT_WINDOW))
    return max(min(w, n_pad), k_pad)


def int8_topk(cache, req, stacked: np.ndarray, k: int, k_pad: int) -> tuple[np.ndarray, np.ndarray]:
    """(dist [Q, k], ids [Q, k]) via the int8-resident two-phase: device
    phase A window → host gather + exact fp32 rescore."""
    with profiling.annotate("residency.int8"):
        return _int8_topk(cache, req, stacked, k, k_pad)


def _int8_topk(cache, req, stacked: np.ndarray, k: int, k_pad: int) -> tuple[np.ndarray, np.ndarray]:
    metric = distance_ops.canonical_metric(req.metric)
    mesh = cache.mesh
    if mesh is not None:
        v8, sv = cache.sharded_int8_solo(req.source, req.column)
        aux_mul, aux_add = cache.sharded_int8_solo_aux(req.source, req.column, metric)
    else:
        v8, sv = cache.int8_solo(req.source, req.column)
        aux_mul, aux_add = cache.int8_solo_aux(req.source, req.column, metric)
    n_pad, rows = v8.rows_padded, v8.rows

    mask = _host_mask(cache, req)
    if mask is not None:
        if mask.shape[0] != rows:
            raise executor._StaleRevision
        padded = np.zeros(n_pad, bool)
        padded[:rows] = mask
        METRICS.add("filter.host_upload")
        if mesh is not None:
            aux_add = aux_add.map(lambda a, m: torch.where(m, a, distance_ops.NEG_INF),
                                  psearch.put_rows(mesh, padded, n_pad))
        else:
            aux_add = torch.where(torch.from_numpy(padded).to(cache.device), aux_add, distance_ops.NEG_INF)

    w = _request_window(req, n_pad, k_pad)
    with profiling.annotate("residency.phase_a", counter="residency.phase_a"), \
            profiling.device_timings() as timings:
        queries = torch.tensor(stacked, device=cache.device)
        if mesh is not None:
            # [S, Q, W'] global-id windows → one [Q, S·W'] union, shard-major
            fn = psearch.build_serving_window_int8(mesh, k_pad, min(w, v8.data.rows_local), metric)
            wins = fn(v8.data, sv.data, queries, aux_mul, aux_add).cpu().numpy()
            win = np.concatenate(list(wins), axis=1)
        else:
            with profiling.device_timer(PHASE_A_DEVICE_COUNTER, queries.device):
                win = topk2.topk_window_int8(
                    v8.data, sv.data, queries, aux_mul, aux_add, k=k_pad, w=w, metric=metric
                )
            win = win.cpu().numpy()
    profiling.settle(timings)  # the window's copy has passed phase A's events

    host = cache.host_matrix(req.source, req.column)
    hmul, hadd = cache.host_aux(req.source, req.column, metric)
    METRICS.add("search.residency_int8")
    return _timed_rescore(host, hmul, hadd, mask, stacked, win, rows, k, metric)


# -- probed (IVF) execution over the cell-sorted host layout ------------------


def _ranges_to_positions(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """``concatenate([arange(s, e) for s, e in zip(starts, ends)])`` as
    int64, without a loop over the ranges."""
    lens = (ends - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    cml = np.cumsum(lens)
    idx = np.arange(total)
    seg = np.searchsorted(cml, idx, side="right")
    return idx - (cml[seg] - lens[seg]) + starts[seg].astype(np.int64)


def _request_metric(cache, req) -> str:
    """The request's metric, by default its coder's (as on the device
    routes; the JAX package's host routes require one)."""
    metric = req.metric if req.metric is not None else cache.coding(req.coding)["config"]["metric"]
    return distance_ops.canonical_metric(metric)


def probed_topk(cache, req, stacked: np.ndarray, k: int, k_pad: int) -> tuple[np.ndarray, np.ndarray]:
    """(dist [Q, k], ids [Q, k]) of a probed request over a host corpus,
    on the host alone: the probe cells are ranked as on every probed route
    (``executor._rank_cells``); each probed cell is a contiguous slice of
    the cell-sorted int8 layout, scored by ``native.row_score`` (int8 rows,
    fp32 query); the top ``window`` per query (``argpartition``) go to the
    exact fp32 host rescore of the int8-resident mode. Work is O(probed
    rows). The JAX package's function, its per-query loop kept."""
    metric = _request_metric(cache, req)
    cells, _ = executor._rank_cells(cache, req.coding, stacked, metric, int(req.probes))
    codes_s, _, orig, offsets = cache.host_clustered_int8(req.coding, req.source, req.column)
    mul_s, add_s = cache.host_clustered_aux(req.coding, req.source, req.column, metric)
    host = cache.host_matrix(req.source, req.column)
    hmul, hadd = cache.host_aux(req.source, req.column, metric)
    mask = _host_mask(cache, req)
    rows = host.shape[0]
    if orig.shape[0] != rows or (mask is not None and mask.shape[0] != rows):
        raise executor._StaleRevision
    qt = stacked.shape[0]
    qp = _prepare_queries_np(stacked, metric)
    w = _request_window(req, max(rows, 1), k_pad)

    t = time.perf_counter()
    win = np.full((qt, w), -1, np.int32)
    for qi in range(qt):
        pos = _ranges_to_positions(offsets[cells[qi]], offsets[cells[qi] + 1])
        if pos.size == 0:
            continue
        sc = native.row_score(codes_s, pos, qp[qi], mul_s, add_s)
        o = orig[pos]
        if mask is not None:
            sc = np.where(mask[o], sc, -np.inf)
        ww = min(w, pos.size)
        part = np.argpartition(-sc, ww - 1)[:ww] if ww < pos.size else np.arange(pos.size)
        win[qi, :ww] = o[part]
    METRICS.add("residency.probed_score_seconds", time.perf_counter() - t)
    METRICS.add("search.residency_probed_host")
    return _timed_rescore(host, hmul, hadd, mask, stacked, win, rows, k, metric)


# -- streaming (larger than device memory) ----------------------------------


def _stream_chunk_rows(budget: "int | None", dim: int, block: int, itemsize: int) -> int:
    """Rows per streamed chunk: two chunks in flight plus the search's
    working set sit inside the budget, so about a quarter of it per
    chunk, block-aligned."""
    if budget is None:
        budget = 2 << 30
    per_row = itemsize * dim + 8
    rows = int(_SAFETY * budget / 4 / per_row)
    return max((rows // block) * block, block)


def stream_topk(cache, req, stacked: np.ndarray, k: int, k_pad: int) -> tuple[np.ndarray, np.ndarray]:
    """(dist [Q, k], ids [Q, k]) by streaming the host corpus through the
    device in fixed-shape chunks (the ragged tail padded with zero rows,
    ``aux_add = −inf``, ``aux_mul = 0`` and, for int8, scale 1e-30).
    fp32: the exact two-phase search per chunk, host merge by (score, id).
    int8: a phase-A window per chunk, one exact host rescore over the
    union."""
    metric = distance_ops.canonical_metric(req.metric)
    host = cache.host_matrix(req.source, req.column)
    hmul, hadd = cache.host_aux(req.source, req.column, metric)
    mask = _host_mask(cache, req)
    rows, dim = host.shape
    if mask is not None and mask.shape[0] != rows:
        raise executor._StaleRevision
    int8_mode = req.precision == "int8"
    if int8_mode:
        # the memoized host mirror: quantizing inside every search would
        # cost more than the transfer the int8 mode quarters
        codes, scales = cache.host_int8(req.source, req.column)
    mesh = cache.mesh
    n_dev = 1 if mesh is None else mesh.size
    # the budget is per device: over a mesh a chunk is S per-device chunks,
    # one on each device
    chunk_block = cache.block * n_dev
    chunk = min(
        _stream_chunk_rows(hbm.budget_bytes(cache.device), dim, cache.block, 1 if int8_mode else 4) * n_dev,
        max(ingest.round_up(rows, chunk_block), chunk_block),
    )
    queries = torch.tensor(stacked, device=cache.device)
    qt = stacked.shape[0]

    def chunks():
        # full chunks are views of the host corpus or mirror; only the
        # ragged tail is padded on the host
        for start in range(0, rows, chunk):
            end = min(start + chunk, rows)
            pad = chunk - (end - start)
            add_c = hadd[start:end]
            if mask is not None:
                add_c = np.where(mask[start:end], add_c, np.float32(distance_ops.NEG_INF))
            mul_c = hmul[start:end]
            if pad:
                add_c = np.concatenate([add_c, np.full(pad, distance_ops.NEG_INF, np.float32)])
                mul_c = np.concatenate([mul_c, np.zeros(pad, np.float32)])
            if int8_mode:
                c8, sv_c = codes[start:end], scales[start:end]
                if pad:
                    c8 = np.concatenate([c8, np.zeros((pad, dim), np.int8)])
                    sv_c = np.concatenate([sv_c, np.full(pad, 1e-30, np.float32)])
                yield c8, sv_c, mul_c, add_c
            else:
                buf = host[start:end]
                if pad:
                    buf = np.concatenate([buf, np.zeros((pad, dim), np.float32)])
                yield buf, mul_c, add_c

    n_chunks = 0
    parts: list = []
    w_c = max(k_pad, min(_request_window(req, chunk, k_pad), chunk // n_dev))
    if mesh is None:
        placed = batch_io.prefetch_to_device(chunks(), cache.device)
    else:
        # each chunk row-sharded, a slice to each device (uploaded in turn)
        placed = (tuple(psearch.put_rows(mesh, a, chunk) for a in arrays) for arrays in chunks())
        window = psearch.build_serving_window_int8(mesh, k_pad, w_c, metric)
        search = psearch.build_serving_search(mesh, min(k_pad, chunk), metric)
    for i, arrays in enumerate(placed):
        start = i * chunk
        t = time.perf_counter()
        if int8_mode:
            c8, sv_c, mul_c, add_c = arrays
            if mesh is None:
                win = topk2.topk_window_int8(c8, sv_c, queries, mul_c, add_c, k=k_pad, w=w_c, metric=metric)
                win = win.cpu().numpy()
            else:  # [S, Q, W'] → [Q, S·W'], shard-major
                win = np.concatenate(list(window(c8, sv_c, queries, mul_c, add_c).cpu().numpy()), axis=1)
            parts.append(np.where(win >= 0, win + start, -1))
        else:
            buf, mul_c, add_c = arrays
            if mesh is None:
                # the chunk's aux on the device, as dual builds it over the
                # whole table, so both score every row bit for bit alike
                # (the host aux carries the filter and the padding as −inf)
                mul_c, add_c = topk2.prepare_aux(buf, add_c != distance_ops.NEG_INF, metric)
                d_c, i_c, s_c = topk2.topk_two_phase(
                    buf, queries, mul_c, add_c, k=min(k_pad, chunk), metric=metric, with_scores=True
                )
                key_c = -s_c.cpu().numpy()
            else:  # the shards' candidates come merged by (distance, id)
                d_c, i_c = search(buf, queries, mul_c, add_c)
                key_c = d_c.cpu().numpy()
            i_c = i_c.cpu().numpy()
            parts.append((d_c.cpu().numpy(), np.where(i_c >= 0, i_c + start, -1), key_c))
        METRICS.add("residency.phase_a_seconds", time.perf_counter() - t)
        n_chunks += 1
    METRICS.add("search.stream_chunks", n_chunks)
    METRICS.add("search.residency_stream")

    if int8_mode:
        win = np.concatenate(parts, axis=1) if parts else np.full((qt, 1), -1, np.int64)
        return _timed_rescore(host, hmul, hadd, mask, stacked, win, rows, k, metric)

    d_all, i_all, key_all = (np.concatenate(x, axis=1) for x in zip(*parts))
    d_all = np.where(i_all >= 0, d_all, np.inf)
    key_all = np.where(i_all >= 0, key_all, np.inf)
    width = d_all.shape[1]
    # (score desc, id asc) merge of the chunks, the query as the major key:
    # the order topk_two_phase gives one pass over the whole table (an l2
    # distance is recomputed as ‖q − v‖, which may invert rows whose scores
    # nearly tie, so it is no merge key)
    flat_order = np.lexsort((i_all.ravel(), key_all.ravel(), np.repeat(np.arange(qt), width))).reshape(
        qt, width
    )
    order = (flat_order - (np.arange(qt) * width)[:, None])[:, :k]
    dq = np.take_along_axis(d_all, order, axis=1).astype(np.float32)
    iq = np.take_along_axis(i_all, order, axis=1)
    if width < k:
        dq = np.concatenate([dq, np.full((qt, k - width), np.inf, np.float32)], axis=1)
        iq = np.concatenate([iq, np.full((qt, k - width), -1, iq.dtype)], axis=1)
    return dq, np.where(np.isfinite(dq), iq, -1).astype(np.int32)


# -- engine entry points ---------------------------------------------------


def execute_many(cache, reqs: Sequence, mode: str) -> "list[pa.Table]":
    """Serve compatible requests (same source, column, metric, filter,
    precision, coder and probes) through a host-corpus mode as one pass,
    retrying when a catalog mutation lands mid-request. A probed request
    (a coder and nonzero probes) runs ``probed_topk`` over the coded
    table, whatever the mode."""
    r0 = reqs[0]
    probed = bool(r0.coding) and bool(r0.probes)
    coding = r0.coding if probed else None
    if probed:
        fn = probed_topk
    else:
        fn = int8_topk if mode == INT8 else stream_topk
    for _ in range(4):
        stamp = cache.snapshot_stamp(r0.source, r0.column, coding)
        data = cache.coded_table(coding, r0.source, r0.column) if probed else cache.host_table(r0.source)
        column_type = ingest.vector_field_type(data.schema.field(r0.column))
        value_dtype = column_type.value_type.to_pandas_dtype()
        targets = [executor.normalize_target(r.target, column_type.list_size) for r in reqs]
        counts = [t.shape[0] for t in targets]
        stacked = np.concatenate(targets) if len(targets) > 1 else targets[0]
        rows = data.num_rows
        k = int(min(max(r.maxval for r in reqs), rows))
        try:
            dist, ids = fn(cache, r0, stacked, k, executor._canonical_k(k))
        except executor._StaleRevision:
            continue
        if cache.snapshot_stamp(r0.source, r0.column, coding) != stamp:
            continue

        views = cache.host_column_views(r0.source, data, stamp, coding)
        out = []
        offset = 0
        for req, c in zip(reqs, counts):
            m = int(min(req.maxval, rows))
            select = [*req.select] if req.select is not None else data.column_names
            out.append(
                executor.gather_results(
                    data,
                    select + [executor.DIST_COL],
                    dist[offset : offset + c, :m],
                    ids[offset : offset + c, :m],
                    value_dtype,
                    views=views,
                )
            )
            offset += c
        return out
    raise RuntimeError(f"table {r0.source!r} kept changing during search")


def execute_solo(cache, req, mode: str) -> pa.Table:
    if req.maxval is None:
        return execute_nomax_host(cache, req)
    return execute_many(cache, [req], mode)[0]


def execute_nomax_host(cache, req) -> pa.Table:
    """No-top-k read over a host-resident corpus: every row that passes
    the filter (and, probed, lies in one of the query's probe cells), in
    table order, with its exact fp32 distance, computed on the host (the
    output is O(selected rows): no reason to stream the corpus through
    the card for a host-delivered result). The reference's index.py:162,
    as ``fenix_tpu/engine/residency.py:675-739`` serves it, with two
    changes: an unprobed selection is the same for every query, so it is
    found once; and an l2 distance is ``‖q − v‖`` of the selected row (the
    port's l2 rule, :func:`_host_l2`), while cosine and dot come from
    ``native.row_score``. A probed read finds each query's rows through
    the cell-sorted order (``session.host_cell_meta``); its columns are
    the table's, without ``__CODED_ID__``, as in the JAX package.
    Counter: ``search.residency_host_nomax``."""
    probed = bool(req.coding) and bool(req.probes)
    metric = _request_metric(cache, req) if probed else distance_ops.canonical_metric(req.metric)
    for _ in range(4):
        table_stamp = cache.snapshot_stamp(req.source)
        stamp = cache.snapshot_stamp(req.source, req.column, req.coding) if probed else table_stamp
        data = cache.host_table(req.source)
        column_type = ingest.vector_field_type(data.schema.field(req.column))
        value_dtype = column_type.value_type.to_pandas_dtype()
        target = executor.normalize_target(req.target, column_type.list_size)
        host = cache.host_matrix(req.source, req.column)
        rows = host.shape[0]
        qt = target.shape[0]
        mask = cache.host_filter_mask(req.source, req.filter) if req.filter is not None else None
        if mask is not None and mask.shape[0] != rows:
            continue  # the mask and the matrix span revisions
        if probed:
            cells, _ = executor._rank_cells(cache, req.coding, target, metric, int(req.probes))
            try:
                orig, offsets = cache.host_cell_meta(req.coding, req.source, req.column)
            except executor._StaleRevision:
                continue
            if orig.shape[0] != rows:
                continue
            sels = []
            for qi in range(qt):
                sel = np.sort(orig[_ranges_to_positions(offsets[cells[qi]], offsets[cells[qi] + 1])])
                sels.append(sel if mask is None else sel[mask[sel]])
            width = max(max(x.size for x in sels), 1)
            ids = np.full((qt, width), -1, np.int64)
            dist = np.full((qt, width), np.inf, np.float32)
            for qi, sel in enumerate(sels):
                ids[qi, : sel.size] = sel
                dist[qi, : sel.size] = _host_distances(cache, req, host, sel, target[qi : qi + 1], metric)[0]
        else:
            sel = np.arange(rows) if mask is None else np.flatnonzero(mask)
            dist = _host_distances(cache, req, host, sel, target, metric)
            ids = np.broadcast_to(sel, (qt, sel.size))
            if sel.size == 0:  # one dropped slot per query, as the device read
                ids, dist = np.full((qt, 1), -1, np.int64), np.full((qt, 1), np.inf, np.float32)
        if cache.snapshot_stamp(req.source, req.column, req.coding if probed else None) != stamp:
            continue
        select = [*req.select] if req.select is not None else data.column_names
        METRICS.add("search.residency_host_nomax")
        return executor.gather_results(
            data, select + [executor.DIST_COL], dist, ids, value_dtype,
            views=cache.host_column_views(req.source, data, table_stamp),
        )
    raise RuntimeError(f"table {req.source!r} kept changing during search")


def _host_distances(
    cache, req, host: np.ndarray, sel: np.ndarray, target: np.ndarray, metric: str
) -> np.ndarray:
    """``[Q, S]`` f32 distances of every query to the host rows ``sel``:
    ``native.row_score`` for cosine and dot, :func:`_host_l2` for l2."""
    if metric == "l2":
        return _host_l2(host, sel, target)
    hmul, hadd = cache.host_aux(req.source, req.column, metric)
    qp = _prepare_queries_np(target, metric)
    out = np.empty((target.shape[0], sel.size), np.float32)
    for qi in range(target.shape[0]):
        sc = native.row_score(host, sel, qp[qi], hmul, hadd)
        out[qi] = _scores_to_distances_np(sc[None], target[qi : qi + 1], metric)[0]
    return out


def _host_l2(host: np.ndarray, sel: np.ndarray, target: np.ndarray) -> np.ndarray:
    """``[Q, S]`` f32 ``‖q − v‖`` of every query to the host rows ``sel``,
    computed in float64 as ``sqrt(‖q‖² − 2q·v + ‖v‖²)``: one BLAS product
    per block of ``_NOMAX_BLOCK_BYTES`` of gathered rows. In float64 the
    expansion's cancellation stays near 1e-16·‖v‖², far below what fp32
    resolves, where in fp32 it cancels for near rows; and it is several
    times faster than a ``[Q, rows, D]`` difference."""
    q64 = target.astype(np.float64)
    qq = np.einsum("qd,qd->q", q64, q64)[:, None]
    out = np.empty((target.shape[0], sel.size), np.float32)
    step = max(1, _NOMAX_BLOCK_BYTES // (8 * host.shape[1]))
    for start in range(0, sel.size, step):
        block = native.gather_rows(host, sel[start : start + step]).astype(np.float64)
        d2 = qq - 2.0 * (q64 @ block.T) + np.einsum("nd,nd->n", block, block)[None, :]
        out[:, start : start + block.shape[0]] = np.sqrt(np.maximum(d2, 0.0))
    return out
