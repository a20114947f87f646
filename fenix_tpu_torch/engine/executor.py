"""Search query executor: request → device search → Arrow — port of
``fenix_tpu/engine/executor.py`` (its exact top-k path).

One device pass per request: the filter mask folds into the cached
``aux_add`` as −inf, the two-phase search (ops.topk2) runs over the
device-resident corpus, and only the winning row ids and distances
return to the host, where the result rows are gathered from the
memory-mapped Arrow table.

Results are sorted ascending by distance with ties broken by row id
(deterministic, unlike the reference's ``select_k_unstable``).

Served here: exact top-k (``maxval`` set) over one device, ``dual``
residency, fp32/bf16/int8 scan precision, host-evaluated filters; a
request that ``residency.plan`` routes to the int8-resident or streaming
mode goes to ``engine/residency.py`` before any device fp32 is built.
Not ported yet, and raising ``NotImplementedError`` that names the
ROADMAP item: IVF ``coding``/``probes``, ``maxval=None`` (the full
distance column), and multi-device meshes.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import pyarrow as pa
import torch

from fenix_tpu_torch import expr as expr_mod
from fenix_tpu_torch.engine import residency
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest
from fenix_tpu_torch.ops import distance as distance_ops
from fenix_tpu_torch.ops import topk2
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

DIST_COL: str = "__DISTANCE__"
QUERY_COL: str = "__QUERY_ID__"

_PRECISIONS = ("fp32", "bf16", "int8")


def _canonical_k(k: int) -> int:
    """k rounded up to a power of two — the JAX package's candidate
    count, kept so both packages select the same bucket margin."""
    p = 1
    while p < k:
        p <<= 1
    return p


_CACHES: dict[tuple[str, str], DeviceCache] = {}
_CACHES_LOCK = threading.Lock()


def get_cache(root: str, device: "str | torch.device" = "cuda") -> DeviceCache:
    key = (os.path.abspath(root), str(torch.device(device)))
    with _CACHES_LOCK:
        if key not in _CACHES:
            _CACHES[key] = DeviceCache(key[0], device=device)
        return _CACHES[key]


@dataclass
class SearchRequest:
    """Stateless, wire-safe search descriptor."""

    source: str | Sequence[str]
    column: str
    target: np.ndarray  # [Q, D] fp32
    metric: str | None = None
    coding: str | None = None
    select: Sequence[str] | None = None
    filter: expr_mod.Expr | None = None
    maxval: int | None = None
    probes: int | None = None
    # "fp32" = exact; "bf16" / "int8" = half-/quarter-traffic phase-1
    # scan with exact fp32 rescore of candidates (recall ≈ 1).
    precision: str = "fp32"
    residency: str = "auto"
    extra: dict[str, Any] = field(default_factory=dict)


def normalize_target(target: Any, dim: int) -> np.ndarray:
    """Accept ndarray / tensor / Arrow fixed-size-list / flat arrays;
    return ``[Q, dim]`` fp32."""
    if isinstance(target, pa.Table):
        target = target.column("target")
    if isinstance(target, pa.ChunkedArray):
        target = target.combine_chunks()
    if isinstance(target, pa.Array):
        if pa.types.is_fixed_size_list(target.type) or isinstance(target, pa.ExtensionArray):
            target = ingest.fixed_size_list_to_numpy(target)
        else:
            # flat value column of Q·dim scalars (the reference client
            # sends a single query this way)
            target = target.to_numpy(zero_copy_only=False)
    if isinstance(target, pa.FixedSizeListScalar):
        target = np.asarray(target.values)
    if isinstance(target, torch.Tensor):
        target = target.detach().cpu().numpy()

    target = np.asarray(target, dtype=np.float32)
    if target.ndim == 1:
        assert target.size % dim == 0, (target.size, dim)
        target = target.reshape(-1, dim)
    assert target.ndim == 2 and target.shape[1] == dim, (target.shape, dim)
    return target


class _StaleRevision(Exception):
    """A concurrent catalog mutation landed mid-request: the device
    entries read along the way span table revisions. Retried."""


class _FilterPlan:
    """Per-request filter: the predicate evaluates on the HOST table with
    Arrow kernels (the JAX package's host-mask route), and the ``[N_pad]``
    mask folds into the cached ``aux_add`` on the device. A length
    mismatch means the mask and the device layout span table revisions
    → _StaleRevision retry."""

    def __init__(self, filt, data: pa.Table, n_pad: int, rows: int, device) -> None:
        self.filt = filt
        self.data = data
        self.n_pad = n_pad
        self.rows = rows
        self.device = device

    @property
    def active(self) -> bool:
        return self.filt is not None

    def host_mask(self) -> np.ndarray:
        """``[n_pad]`` bool mask via Arrow kernels (padding rows False)."""
        m = np.zeros(self.n_pad, dtype=bool)
        m[: self.rows] = self.filt.mask(self.data)
        return m

    def overlay(self, aux_add: torch.Tensor) -> torch.Tensor:
        if not self.active:
            return aux_add
        m = self.host_mask()
        if m.shape[0] != aux_add.shape[0]:
            raise _StaleRevision
        METRICS.add("filter.host_upload")
        mask = torch.from_numpy(m).to(self.device)
        return torch.where(mask, aux_add, distance_ops.NEG_INF)


def _check_revision(cache: DeviceCache, source, snap_stamp: tuple) -> None:
    """Raise _StaleRevision when a catalog mutation landed after the
    snapshot: the aux and scan copies memoize under their own stamps, so
    checking AFTER assembling the inputs proves they all saw the
    snapshot's files."""
    if cache.snapshot_stamp(source) != snap_stamp:
        raise _StaleRevision


def execute_search(cache: DeviceCache, req: SearchRequest) -> pa.Table:
    """Run a search request against device-resident columns, retrying
    when a concurrent catalog mutation lands mid-request."""
    for _ in range(4):
        try:
            return _execute_search_once(cache, req)
        except _StaleRevision:
            continue
    raise RuntimeError(f"table {req.source!r} kept changing during search")


def _execute_search_once(cache: DeviceCache, req: SearchRequest) -> pa.Table:
    if req.coding is not None or req.probes is not None:
        raise NotImplementedError("IVF coding/probes search (ROADMAP queue 1: IVF port)")
    if req.maxval is None:
        raise NotImplementedError(
            "maxval=None, the full distance column (ROADMAP queue 1: _execute_nomax)"
        )
    if req.precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {req.precision!r}")
    if req.metric is None:
        raise ValueError("metric is required when no coder supplies one")
    # corpora past the budget serve through the host-corpus modes,
    # before any device fp32 is built
    mode = residency.plan(cache, req)
    if mode != residency.DUAL:
        return residency.execute_solo(cache, req, mode)

    # host table + device matrix of the same revision
    data, corpus, snap_stamp = cache.snapshot(req.source, req.column)

    column_type = ingest.vector_field_type(data.schema.field(req.column))
    value_dtype = column_type.value_type.to_pandas_dtype()
    target = normalize_target(req.target, column_type.list_size)
    num_queries = target.shape[0]

    metric = distance_ops.canonical_metric(req.metric)

    n_pad, rows = corpus.rows_padded, corpus.rows
    views = cache.host_column_views(req.source, data, snap_stamp)
    plan = _FilterPlan(req.filter, data, n_pad, rows, cache.device)

    select = [*req.select] if req.select is not None else data.column_names
    select = select + [DIST_COL]

    k = int(min(req.maxval, rows))
    k_pad = min(_canonical_k(k), n_pad)
    queries = torch.tensor(target, device=cache.device)  # target may view Arrow memory

    aux_mul, aux_add = cache.metric_aux(req.source, req.column, metric)
    aux_add = plan.overlay(aux_add)
    corpus_scan = (
        cache.matrix_bf16(req.source, req.column).data if req.precision == "bf16" else None
    )
    corpus_scan_int8 = None
    if req.precision == "int8":
        v8, sv = cache.matrix_int8(req.source, req.column)
        corpus_scan_int8 = (v8.data, sv.data)
    _check_revision(cache, req.source, snap_stamp)

    dists, ids = topk2.topk_two_phase(
        corpus.data,
        queries,
        aux_mul,
        aux_add,
        k=k_pad,
        metric=metric,
        corpus_scan=corpus_scan,
        corpus_scan_int8=corpus_scan_int8,
    )
    # one device→host copy of the small [Q, k] results
    dists = dists[:, :k].cpu().numpy()
    ids = ids[:, :k].cpu().numpy()
    return gather_results(data, select, dists, ids, value_dtype, views=views)


def _gather_chunked(chunks: list[np.ndarray], row_ids: np.ndarray) -> np.ndarray:
    """Rows ``row_ids`` of the concatenation of ``chunks``, without
    concatenating them."""
    starts = np.cumsum([0] + [c.shape[0] for c in chunks])
    which = np.searchsorted(starts, row_ids, side="right") - 1
    order = np.argsort(which, kind="stable")  # group the ids by chunk
    bounds = np.searchsorted(which[order], np.arange(len(chunks) + 1))
    out = np.empty((row_ids.shape[0], *chunks[0].shape[1:]), chunks[0].dtype)
    for c in np.flatnonzero(np.diff(bounds)):  # only the chunks holding ids
        idx = order[bounds[c] : bounds[c + 1]]
        out[idx] = chunks[c][row_ids[idx] - starts[c]]
    return out


def gather_results(
    data: pa.Table,
    select: Sequence[str],
    dists: np.ndarray,  # [Q, k]
    ids: np.ndarray,  # [Q, k] (−1 padding)
    value_dtype,
    views: "dict | None" = None,
) -> pa.Table:
    """Host-side result materialization: take the winning rows, append
    the distance column, add ``__QUERY_ID__`` for multi-query batches.

    Columns with a numpy view (session.host_column_views) gather with
    numpy indexing — vectors chunk by chunk — into single-chunk Arrow
    arrays; the rest (strings, extension types, nullable columns) take a
    per-column Arrow ``take``, keeping their exact result types."""
    num_queries, k = ids.shape
    valid = ids >= 0  # [Q, k]
    row_ids = ids[valid].astype(np.int64)

    names: list[str] = []
    arrays: list[pa.Array | pa.ChunkedArray] = []
    ids_arr: pa.Array | None = None
    for name in select:
        if name == DIST_COL:
            names.append(DIST_COL)
            arrays.append(pa.array(dists[valid].astype(value_dtype)))
            continue
        view = views.get(name) if views is not None else None
        if view is not None:
            v, value_type = view
            if isinstance(v, list):  # per-chunk [rows, D] vector views
                arr = ingest.numpy_to_fixed_size_list(_gather_chunked(v, row_ids), value_type)
            else:
                arr = pa.array(v[row_ids])
        else:
            if ids_arr is None:
                ids_arr = pa.array(row_ids)
            arr = data.column(name).take(ids_arr)
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.combine_chunks()  # result-sized, cheap
        names.append(name)
        arrays.append(arr)

    if num_queries > 1:
        qids = np.broadcast_to(
            np.arange(num_queries, dtype=np.int64)[:, None], (num_queries, k)
        )[valid]
        names.append(QUERY_COL)
        arrays.append(pa.array(qids))
    return pa.table(dict(zip(names, arrays)))
