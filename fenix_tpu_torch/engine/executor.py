"""Search query executor: request → device search → Arrow — port of
``fenix_tpu/engine/executor.py`` (its single-device paths).

One device pass per request: the filter mask folds into the cached
``aux_add`` as −inf, the two-phase search (ops.topk2) runs over the
device-resident corpus, and only the winning row ids and distances
return to the host, where the result rows are gathered from the
memory-mapped Arrow table.

Results are sorted ascending by distance with ties broken by row id
(deterministic, unlike the reference's ``select_k_unstable``).

Served here: exact top-k (``maxval`` set) over one device, ``dual``
residency, fp32/bf16/int8 scan precision; the no-top-k read
(``maxval=None``, ``_execute_nomax`` over ``ops/select.py``); filters on
the card where the predicate allows it, else from the host table
(``_FilterPlan``).

One request path: ``_execute_batch_once`` serves every top-k batch and
``_execute_search_once`` the no-top-k read, each retried by ``_retry``
(four attempts while catalog mutations land mid-request). Each
validates, asks ``residency.plan`` for the mode, takes the revision,
normalises and stacks the targets, runs a route and gathers each
member's rows. DUAL snapshots the host table with the device fp32 and
runs the device routes here. The host-corpus modes build no device fp32:
they take the revision stamp and the host table (the coded one under a
probed top-k), run a route of ``engine/residency.py`` (probe cells
ranked here) and check the stamp again; ``k_pad`` is ``_canonical_k(k)``,
with no device ``n_pad`` to cap it.

IVF (a ``coding`` and a nonzero ``probes``; ``probes=0`` is the exact
search over the coded table, as in the JAX package): the metric defaults
to the coder's; the probe cells are ranked on the card, over the queries
already there (``cells.topk_cells``, counter ``ivf.rank_device``),
and on a CPU device on the host (``cells.topk_cells_np``), the bounded
beam on the device past ``DENSE_CELL_LIMIT``; then one of two routes,
decided before any device layout is built, by the JAX package's rule on
total work ``q_pad · B · bucket ≤ n_pad`` (``_canonical_q`` copied, so
both packages pick the same route though this one pads no queries):
the clustered gather (``topk2.topk_ivf_clustered`` over
``session.clustered``; counter ``search.ivf_clustered``) or the masked
scan (``topk2.topk_two_phase_probed``, fp32/bf16/int8; counter
``search.ivf_scan``). Timers: ``ivf.rank_seconds`` (the cell ranking,
with the read of its host copy) and ``ivf.route_seconds`` (the clustered
layout's host metadata, the bucket lists and the route decision).

Spans (``utils/profiling``, recorded while a capture is active):
``fenix.snapshot`` (``session``), ``executor.prepare`` (targets, host
views, filter plan), ``executor.launch`` (enqueueing phases 1 and 2,
holding ``fenix.rank_cells``, ``ivf.route`` and ``fenix.mask_build``),
``fenix.fetch`` (the wait for the card, timed always, so that a
dispatch's host time leaves it out) and ``fenix.result_gather`` (timer
``results.gather_seconds``); while a capture is active, phase 2's device
time (``ops/topk2``, counter ``phase2.device_seconds``) is read once the
fetch has synchronised. A host-corpus top-k batch runs whole, its rows
gathered included, inside ``executor.host_corpus`` and has no other span
of this module (its route's are ``engine/residency.py``'s).

Micro-batching (``engine/batching.py``): ``batchable`` and ``batch_key``
decide which requests may share a dispatch, and
``execute_search_batched`` runs them as one search over their stacked
queries (DUAL exact at every scan precision, both probed routes chosen
over the stacked batch, the host-corpus routes), with one filter overlay
for the batch. A top-k request alone is a batch of one, so both paths
share every route and counter.

Meshes (a cache with a ``mesh``, ``parallel/mesh.py``): the snapshot's
matrix is the row-sharded one and every route runs over row-sharded
entries (``parallel/search.py``), as the JAX package's mesh branches do.
Exact top-k (``_mesh_exact``): below the ring threshold the queries are
replicated to every shard and the shards' ``[Q, k]`` candidates merge on
the mesh's first device; from ``FENIX_RING`` queries (``auto``: 512, by
the JAX package's padded count; ``off`` disables it) they take the ring,
padded to a multiple of the shard count with zero queries. IVF
(``_mesh_probed``): the per-shard clustered gather when each shard's
gather moves at most one local corpus pass (``search.ivf_clustered``),
else the masked scan on the all-gather route or the ring
(``search.ivf_scan``). Filters fold into the sharded aux in row order or
each shard's clustered order (``_FilterPlan``). The no-top-k read runs
shard by shard and concatenates in shard order, which is table order.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import pyarrow as pa
import torch

from fenix_tpu_torch import expr as expr_mod
from fenix_tpu_torch import native, types
from fenix_tpu_torch.engine import residency
from fenix_tpu_torch.engine.session import DeviceCache, _StaleRevision
from fenix_tpu_torch.index import DIST_COL, QUERY_COL  # the result's column names
from fenix_tpu_torch.io import ingest
from fenix_tpu_torch.ops import cells as cells_ops
from fenix_tpu_torch.ops import distance as distance_ops
from fenix_tpu_torch.ops import select as select_ops
from fenix_tpu_torch.ops import topk2
from fenix_tpu_torch.parallel import search as psearch
from fenix_tpu_torch.utils import profiling
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS


_PRECISIONS = ("fp32", "bf16", "int8")

# The JAX package's canonical query-batch sizes. This package pads no
# queries, but the IVF route rule reads the padded count, so both
# packages route a request alike.
_Q_STEPS = (1, 8, 64, 256, 1024)

# Above this composite-cell count the clustered layout's offset table is
# not built (high-cardinality coders rank with the bounded beam and scan).
_CLUSTERED_MAX_CELLS = 1 << 22


def _canonical_q(q: int) -> int:
    for step in _Q_STEPS:
        if q <= step:
            return step
    return -(-q // 1024) * 1024


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
    return ``[Q, dim]`` fp32. Extension targets (tensor, quint8) view
    through their storage, a quint8 one dequantized as its column would
    be; a table's target field gives the unregistered form its type."""
    if isinstance(target, pa.Table):
        target = types.typed_column(target, "target")
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


def _ring_threshold() -> "int | None":
    """The padded query count from which a mesh's exact and masked-scan
    searches take the ring: ``FENIX_RING`` ``auto`` (512), ``off``, or a
    number (the tests force the ring at small Q with it)."""
    env = os.environ.get("FENIX_RING", "auto").lower()
    if env in ("off", "0", "none"):
        return None
    return 512 if env == "auto" else max(1, int(env))


class _FilterPlan:
    """Per-request filter handling (the JAX package's ``_FilterPlan``: the
    "flat", "clustered", "sharded" and "sharded_clustered" layouts).

    Device pushdown: a device-evaluable predicate (``expr.device_evaluable``:
    bool / integer / float32 columns, exactly representable literals) is
    evaluated on the card over the device scalar columns and memoized per
    (predicate, revision) (``session.device_filter_mask``); counted as
    ``filter.device_pushdown``. Host route (strings, float64 columns, ``/``,
    ``is_null``, integers past int32, nulls): the predicate runs over the
    host table with Arrow kernels, once per request, and the ``[N_pad]``
    mask is copied to the card; counted as ``filter.host_upload``. Either
    mask folds into the cached ``aux_add`` as −inf, in row order or, for
    the clustered layout, permuted into its sorted order (on the card for
    a device mask); over a mesh the mask is row-sharded and a clustered
    one permuted within each shard. A length mismatch means the mask and
    the layout span table revisions → _StaleRevision retry.
    ``filter.seconds`` times the host side of both routes."""

    def __init__(
        self, cache: DeviceCache, source, column: str, filt, data: pa.Table, n_pad: int, rows: int
    ) -> None:
        self.cache = cache
        self.source = source
        self.column = column
        self.filt = filt
        self.data = data
        self.n_pad = n_pad
        self.rows = rows
        self._host: np.ndarray | None = None
        self.pushdown = filt is not None and filt.device_evaluable(data.schema)

    @property
    def active(self) -> bool:
        return self.filt is not None

    def host_mask(self) -> np.ndarray:
        """``[n_pad]`` bool mask via Arrow kernels (padding rows False),
        built once per request."""
        if self._host is None:
            with profiling.annotate("fenix.mask_build"):
                m = np.zeros(self.n_pad, dtype=bool)
                m[: self.rows] = self.filt.mask(self.data)
                self._host = m
        return self._host

    def mask(self, coding: "str | None" = None, sharded: bool = False) -> "torch.Tensor | psearch.Sharded":
        """The request's ``[n_pad]`` device mask, in row order, or in the
        clustered layout's sorted order of ``coding``; row-sharded over the
        mesh with ``sharded``."""
        t = time.perf_counter()
        cache = self.cache
        mask = cache.device_filter_mask(self.source, self.filt, sharded=sharded) if self.pushdown else None
        if mask is not None:
            if mask.shape[0] != self.n_pad:
                raise _StaleRevision
            if coding is not None:
                if sharded:
                    perm = cache.sharded_clustered_perm(coding, self.source, self.column)
                else:
                    perm = cache.clustered_perm(coding, self.source, self.column)
                if perm.shape[0] != self.n_pad:
                    raise _StaleRevision
                mask = psearch.permute_rows_sharded(cache.mesh, mask, perm) if sharded else mask[perm]
            METRICS.add("filter.device_pushdown")
        else:
            m = self.host_mask()
            if coding is not None:
                if sharded:
                    perm_local, _, _ = cache.sharded_clustered_meta(coding, self.source, self.column)
                    per = perm_local.shape[0] // cache.mesh.size
                    perm = np.arange(perm_local.shape[0]) // per * per + perm_local
                else:
                    perm, _ = cache.clustered_meta(coding, self.source, self.column)
                if perm.shape[0] != self.n_pad:
                    raise _StaleRevision
                m = m[perm]
            METRICS.add("filter.host_upload")
            if sharded:
                mask = psearch.put_rows(cache.mesh, m, m.shape[0])
            else:
                mask = torch.from_numpy(m).to(cache.device)
        METRICS.add("filter.seconds", time.perf_counter() - t)
        return mask

    def overlay(self, aux_add, coding: "str | None" = None):
        """``aux_add`` with the filter folded in as −inf; a row-sharded
        ``aux_add`` takes the sharded mask."""
        if not self.active:
            return aux_add
        sharded = isinstance(aux_add, psearch.Sharded)
        mask = self.mask(coding, sharded)
        if mask.shape[0] != aux_add.shape[0]:
            raise _StaleRevision
        if sharded:
            return aux_add.map(lambda a, m: torch.where(m, a, distance_ops.NEG_INF), mask)
        return torch.where(mask, aux_add, distance_ops.NEG_INF)


def _check_revision(cache: DeviceCache, source, column: str, coding, snap_stamp: tuple) -> None:
    """Raise _StaleRevision when a catalog mutation landed after the
    snapshot: the aux, scan copies, coded ids and clustered layouts
    memoize under their own stamps, so checking AFTER assembling the
    inputs proves they all saw the snapshot's files."""
    if cache.snapshot_stamp(source, column, coding) != snap_stamp:
        raise _StaleRevision


def rank_cells(
    device, target: np.ndarray, codebooks: np.ndarray, metric: str, probes: int,
    queries: "torch.Tensor | None" = None, books: "Callable[[], torch.Tensor] | None" = None,
) -> tuple[np.ndarray, torch.Tensor]:
    """Top-``probes`` composite cells per query, as a host ``[Q, P]`` int32
    array and as a tensor on ``device``: the ranking of every probed read.
    A CUDA device ranks them (``cells.topk_cells`` over ``queries``, the
    targets on the card, and ``books()``, the codebooks there; each
    uploaded when not given); a CPU device ranks dense grids on the host
    with the JAX package's numpy ranking (``cells.topk_cells_np``). Past
    ``DENSE_CELL_LIMIT`` the bounded beam runs on the device (as
    ``coder.call``)."""
    device = torch.device(device)
    n_books, k_book, _ = codebooks.shape
    probes = int(min(probes, k_book**n_books))
    dense = k_book**n_books <= cells_ops.DENSE_CELL_LIMIT
    if dense and device.type != "cuda":
        cells_np = cells_ops.topk_cells_np(target, codebooks, metric, probes)
        return cells_np, torch.from_numpy(cells_np).to(device)
    if queries is None:
        queries = torch.tensor(target, device=device)
    on_device = books() if books is not None else torch.tensor(codebooks, device=device)
    rank = cells_ops.topk_cells if dense else cells_ops.topk_cells_bounded
    cells = rank(queries, on_device, metric, probes)
    return cells.cpu().numpy(), cells


def _rank_cells(
    cache: DeviceCache, coding: str, target: np.ndarray, metric: str, probes: int,
    queries: "torch.Tensor | None" = None,
) -> tuple[np.ndarray, torch.Tensor]:
    """:func:`rank_cells` on the cache's device, against the coder's
    memoized device codebooks; a ranking on the card counts
    ``ivf.rank_device``."""
    with profiling.annotate("fenix.rank_cells"):
        cells_np, cells = rank_cells(
            cache.device, target, cache.coding(coding)["tensor"], metric, probes, queries,
            lambda: cache.codebooks(coding),
        )
        if cells.device.type == "cuda":
            METRICS.add("ivf.rank_device")
        return cells_np, cells


def _clustered_eligible(coding_data) -> bool:
    """Whether the coder's cell count permits a clustered offset table."""
    n_books, k_book, _ = coding_data["tensor"].shape
    return int(k_book) ** int(n_books) <= _CLUSTERED_MAX_CELLS


def _ivf_bucket_lists(
    cells_np: np.ndarray, offsets: np.ndarray, bucket: int, n_buckets: int
) -> np.ndarray:
    """Bucket indices covering each query's probed cells in the clustered
    layout (``[Q, B]`` int32, −1 padded; B a power of two). The JAX
    package's function, copied."""
    q, p = cells_np.shape
    sentinel = np.iinfo(np.int64).max
    ok = (cells_np >= 0) & (cells_np < len(offsets) - 1)
    cs = np.where(ok, cells_np, 0)
    starts = np.where(ok, offsets[cs] // bucket, 0)
    ends = np.where(ok, -(-offsets[cs + 1] // bucket), 0)  # ceil
    widths = np.maximum(ends - starts, 0)  # [Q, P]
    m = int(widths.max(initial=0))
    if m == 0:
        return np.full((q, 8), -1, np.int32)

    # [Q, P, M] candidate grid, invalid slots → sentinel
    grid = starts[:, :, None] + np.arange(m)[None, None, :]
    grid = np.where(
        (np.arange(m)[None, None, :] < widths[:, :, None]) & (grid < n_buckets),
        grid,
        sentinel,
    ).reshape(q, p * m)
    grid.sort(axis=1)
    # dedupe within each row: repeats → sentinel, then re-sort compacts
    dup = np.zeros_like(grid, dtype=bool)
    dup[:, 1:] = grid[:, 1:] == grid[:, :-1]
    grid = np.where(dup | (grid == sentinel), sentinel, grid)
    grid.sort(axis=1)

    counts = (grid != sentinel).sum(axis=1)
    width = int(counts.max(initial=1)) or 1
    b = 1 << (width - 1).bit_length()
    b = min(max(b, 8), max(n_buckets, 1))
    out = grid[:, :b].astype(np.int64)
    out[out == sentinel] = -1
    return out.astype(np.int32)


def _retry(attempt: Callable[[], Any], source) -> Any:
    """``attempt()``, made again while a concurrent catalog mutation lands
    mid-request (``_StaleRevision``): four attempts in all, then
    ``RuntimeError``. The one retry of every request path."""
    for _ in range(4):
        try:
            return attempt()
        except _StaleRevision:
            continue
    raise RuntimeError(f"table {source!r} kept changing during search")


def execute_search(cache: DeviceCache, req: SearchRequest) -> pa.Table:
    """Run a search request, retrying when a concurrent catalog mutation
    lands mid-request."""
    return _retry(lambda: _execute_search_once(cache, req), req.source)


def _validate(req: SearchRequest) -> bool:
    """Refuse a bad precision or a missing metric; return whether the
    request probes an IVF coder (the reference's rule: a coder and a
    nonzero probe count; ``probes=0`` answers the exact search over the
    coded table)."""
    if req.precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {req.precision!r}")
    probed = bool(req.coding) and bool(req.probes)
    if req.metric is None and not probed:
        raise ValueError("metric is required when no coder supplies one")
    return probed


def _execute_search_once(cache: DeviceCache, req: SearchRequest) -> pa.Table:
    if req.maxval is not None:  # top-k: a batch of one
        return _execute_batch_once(cache, [req], defer=False)[0]
    probed = _validate(req)
    on_card = residency.plan(cache, req) == residency.DUAL
    if on_card:  # the host table (with __CODED_ID__ under a coder) and the device matrix of one revision
        data, corpus, snap_stamp = cache.snapshot(req.source, req.column, req.coding)
        views_stamp, variant = snap_stamp, req.coding
    else:  # the table's own columns, as in the JAX package; a probed read's revision is the index's too
        views_stamp, variant = cache.snapshot_stamp(req.source), None
        snap_stamp = cache.snapshot_stamp(req.source, req.column, req.coding) if probed else views_stamp
        data = cache.host_table(req.source)
    column_type = ingest.vector_field_type(data.schema.field(req.column))
    value_dtype = column_type.value_type.to_pandas_dtype()
    target = normalize_target(req.target, column_type.list_size)
    metric = residency._request_metric(cache, req)
    views = cache.host_column_views(req.source, data, views_stamp, variant)
    select = [*req.select] if req.select is not None else data.column_names
    queries = torch.tensor(target, device=cache.device) if on_card else None  # target may view Arrow memory
    cells_np, cells = (_rank_cells(cache, req.coding, target, metric, int(req.probes), queries) if probed
                       else (None, None))
    if not on_card:
        dists, ids = residency.execute_nomax_host(cache, req, target, cells_np)
        _check_revision(cache, req.source, req.column, req.coding if probed else None, snap_stamp)
        METRICS.add("search.residency_host_nomax")
        return gather_results(data, select + [DIST_COL], dists, ids, value_dtype, views=views)

    plan = _FilterPlan(cache, req.source, req.column, req.filter, data, corpus.rows_padded, corpus.rows)
    return _execute_nomax(
        cache, req, data, corpus, plan, cells, metric, target, queries,
        value_dtype, select + [DIST_COL], snap_stamp, views,
    )


def batchable(req: SearchRequest) -> bool:
    """Whether a request can join a coalesced dispatch: a top-k search with
    a metric, probed only with an explicit probe count, and no per-request
    ``extra`` knob (a window is one request's; the JAX package batches
    such requests and gives every member the first one's window). Members
    of a batch share one filter overlay, one coder and probe count (the
    batch key carries them); ``maxval`` may differ, since each member's
    top-m is a prefix of the batch's top-k."""
    return (
        req.maxval is not None
        and req.metric is not None
        and (req.coding is None or req.probes is not None)
        and not req.extra
    )


def batch_key(req: SearchRequest) -> tuple:
    """The requests that may share a dispatch: one source, column,
    metric (validated here), precision, residency, coder, probe count and
    predicate (its wire form)."""
    source = (req.source,) if isinstance(req.source, str) else tuple(req.source)
    return (
        source,
        req.column,
        distance_ops.canonical_metric(req.metric),
        req.precision,
        req.residency,
        req.coding,
        req.probes,
        expr_mod.dumps(req.filter),
    )


def execute_search_batched(
    cache: DeviceCache, reqs: Sequence[SearchRequest], defer: bool = False
) -> "list[pa.Table] | Callable[[], list[pa.Table]]":
    """Run compatible top-k requests (one ``batch_key``, all ``batchable``)
    as ONE device search over their stacked queries; a lone request is a
    batch of one, so every route counter and kernel launch moves as on the
    solo path, once per batch.

    With ``defer=True`` the device work is enqueued and a ``finish()``
    closure returned: it waits for this batch's results alone (their copy
    to pinned host memory is enqueued right behind the search, with an
    event) and gathers each member's table. Retried when a catalog
    mutation lands mid-request."""
    return _retry(lambda: _execute_batch_once(cache, reqs, defer), reqs[0].source)


def _fetch_async(*tensors: torch.Tensor) -> "Callable[[], list[np.ndarray]]":
    """Start copying small device results to the host and return the wait
    that gives them as numpy arrays. On a CUDA device the copies go into
    pinned buffers behind an event, so the wait does not also wait for
    work enqueued after them (a later batch's search). The wait is the
    ``fenix.fetch`` span: the device→host readback."""
    if tensors[0].device.type != "cuda":
        arrays = [t.numpy() for t in tensors]

        def ready() -> list[np.ndarray]:
            with profiling.annotate("fenix.fetch", wait=True):
                return arrays

        return ready
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for host, t in zip(hosts, tensors):
        host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> list[np.ndarray]:
        with profiling.annotate("fenix.fetch", wait=True):
            done.synchronize()
            return [host.numpy() for host in hosts]

    return wait


def _execute_batch_once(
    cache: DeviceCache, reqs: Sequence[SearchRequest], defer: bool
) -> "list[pa.Table] | Callable[[], list[pa.Table]]":
    """The top-k request path (module docstring); a deferred host-corpus
    batch returns the tables it has already built."""
    r0 = reqs[0]
    probed = _validate(r0)
    mode = residency.plan(cache, r0)
    on_card = mode == residency.DUAL
    span = profiling.annotate if on_card else contextlib.nullcontext  # the host modes' spans are their own
    with contextlib.nullcontext() if on_card else profiling.annotate("executor.host_corpus"):
        coding = r0.coding if on_card or probed else None
        if on_card:
            data, corpus, snap_stamp = cache.snapshot(r0.source, r0.column, coding)
            n_pad, rows = corpus.rows_padded, corpus.rows
        else:
            snap_stamp = cache.snapshot_stamp(r0.source, r0.column, coding)
            data = cache.coded_table(coding, r0.source, r0.column) if probed else cache.host_table(r0.source)
            rows = data.num_rows
        with span("executor.prepare"):
            column_type = ingest.vector_field_type(data.schema.field(r0.column))
            value_dtype = column_type.value_type.to_pandas_dtype()
            targets = [normalize_target(r.target, column_type.list_size) for r in reqs]
            counts = [t.shape[0] for t in targets]
            stacked = np.concatenate(targets) if len(targets) > 1 else targets[0]
            metric = residency._request_metric(cache, r0)
            views = cache.host_column_views(r0.source, data, snap_stamp, coding)
            if on_card:
                coding_data = cache.coding(r0.coding) if probed else None
                # members share one predicate (the batch key carries its wire
                # form), so one overlay serves the whole batch
                plan = _FilterPlan(cache, r0.source, r0.column, r0.filter, data, n_pad, rows)

        k = int(min(max(r.maxval for r in reqs), rows))
        if on_card:
            k_pad = min(_canonical_k(k), n_pad)
            with profiling.annotate("executor.launch"), profiling.device_timings() as timings:
                queries = torch.tensor(stacked, device=cache.device)  # a target may view Arrow memory
                if probed:
                    dists, ids = _probed_topk(
                        cache, r0, coding_data, corpus, queries, stacked, metric, plan, k_pad, snap_stamp
                    )
                elif cache.mesh is not None:
                    dists, ids = _mesh_exact(cache, r0, corpus, queries, metric, plan, k_pad, snap_stamp)
                else:
                    aux_mul, aux_add = cache.metric_aux(r0.source, r0.column, metric)
                    aux_add = plan.overlay(aux_add)
                    scan = _scan_copies(cache, r0)
                    _check_revision(cache, r0.source, r0.column, r0.coding, snap_stamp)
                    dists, ids = topk2.topk_two_phase(
                        corpus.data, queries, aux_mul, aux_add, k=k_pad, metric=metric, **scan
                    )
                # one device→host copy of the small [Q, k] results
                fetch = _fetch_async(dists[:, :k], ids[:, :k])
        else:
            k_pad = _canonical_k(k)  # no device padding to cap it: k is capped by the host rows
            if probed:
                cells, _ = _rank_cells(cache, r0.coding, stacked, metric, int(r0.probes))
                answer = residency.probed_topk(cache, r0, stacked, k, k_pad, cells)
            else:
                route = residency.int8_topk if mode == residency.INT8 else residency.stream_topk
                answer = route(cache, r0, stacked, k, k_pad)
            _check_revision(cache, r0.source, r0.column, coding, snap_stamp)
            fetch, timings = (lambda: answer), []

        def finish() -> list[pa.Table]:
            dists_np, ids_np = fetch()
            profiling.settle(timings)  # the fetch has passed phase 2's events
            out = []
            offset = 0
            for req, c in zip(reqs, counts):
                m = int(min(req.maxval, rows))
                select = [*req.select] if req.select is not None else data.column_names
                out.append(
                    gather_results(
                        data, select + [DIST_COL], dists_np[offset : offset + c, :m],
                        ids_np[offset : offset + c, :m], value_dtype, views=views,
                    )
                )
                offset += c
            return out

        if on_card and defer:
            return finish
        tables = finish()
    return (lambda: tables) if defer else tables


# result rows from which the chunked vector gather spreads over threads
_THREADED_GATHER_ROWS = 8192
_GATHER_POOL: "ThreadPoolExecutor | None" = None
_GATHER_POOL_LOCK = threading.Lock()

# rows per chunk of a no-top-k read, before chunk_for's cap on the
# [Q, chunk] distance tile
_NOMAX_BLOCK = 1 << 20


def _execute_nomax(
    cache: DeviceCache,
    req: SearchRequest,
    data: pa.Table,
    corpus,
    plan: _FilterPlan,
    cells: "torch.Tensor | None",
    metric: str,
    target: np.ndarray,
    queries: torch.Tensor,
    value_dtype,
    select: Sequence[str],
    snap_stamp: tuple,
    views: "dict | None",
) -> pa.Table:
    """No-top-k read (``maxval=None``): every selected row with its exact
    distance, in table order (the reference's index.py:162, probe pruning
    by the ranked ``cells`` AND'd into the filter). Counters:
    ``search.nomax_full`` and ``search.nomax_selected``.

    Full read (no filter, no probes): the output is ``[Q, rows]``; it is
    computed in row chunks, each copied to the host, so no ``[Q, N_pad]``
    matrix is held on the card. Selected: one count pass, then a
    compaction of each chunk holding matches at a width of its largest
    count rounded up to a power of two, kept on the card and copied to
    the host once. An empty selection returns one −1 / +inf slot per
    query, which ``gather_results`` drops."""
    rows, n_pad = corpus.rows, corpus.rows_padded
    num_queries = target.shape[0]
    # (offset, rows, tensor) per shard; one device is one shard
    sharded = isinstance(corpus.data, psearch.Sharded)
    if sharded:
        per = corpus.data.rows_local
        pieces = [(s * per, min(max(rows - s * per, 0), per), x) for s, x in enumerate(corpus.data.shards)]
        q_on = psearch.replicate(cache.mesh, queries)
    else:
        pieces, q_on = [(0, rows, corpus.data)], [queries]
    chunk = select_ops.chunk_for(pieces[0][2].shape[0], num_queries, _NOMAX_BLOCK)

    if not plan.active and cells is None:
        dists = np.empty((num_queries, rows), np.float32)
        for (offset, valid, x), q_s in zip(pieces, q_on):
            for start in range(0, valid, chunk):
                stop = min(start + chunk, valid)
                dists[:, offset + start : offset + stop] = select_ops.distances(
                    q_s, x[start:stop], metric
                ).cpu().numpy()
        METRICS.add("search.nomax_full")
        _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
        parts = []
        for qi in range(num_queries):
            part = data.append_column(DIST_COL, pa.array(dists[qi].astype(value_dtype))).select(select)
            if num_queries > 1:
                part = part.append_column(QUERY_COL, pa.array(np.full(len(part), qi, dtype=np.int64)))
            parts.append(part)
        return pa.concat_tables(parts)

    fmask = plan.mask(sharded=sharded) if plan.active else None
    coded = cells_sorted = None
    if cells is not None:
        # sorted per query for the searchsorted membership
        cells_sorted = torch.sort(cells, dim=1).values
        coded_col = cache.coded_ids(req.coding, req.source, req.column, sharded=sharded)
        if coded_col.rows_padded != n_pad:
            raise _StaleRevision
        coded = coded_col.data

    def shard_of(x, s: int):
        return x.shards[s] if isinstance(x, psearch.Sharded) else x

    ids_parts: list[np.ndarray] = []
    dist_parts: list[np.ndarray] = []
    for s, ((offset, valid, x), q_s) in enumerate(zip(pieces, q_on)):
        ids_s: list[torch.Tensor] = []
        dist_s: list[torch.Tensor] = []
        fmask_s = None if fmask is None else shard_of(fmask, s)
        coded_s = None if coded is None else shard_of(coded, s)
        cells_s = None if cells_sorted is None else cells_sorted.to(x.device)
        if coded_s is not None:
            counts = select_ops.count_selected_probed(fmask_s, coded_s, cells_s, valid, chunk=chunk)
            chunk_max = counts.max(dim=1).values.cpu().numpy()
        else:
            chunk_max = select_ops.count_selected_mask(fmask_s, valid, chunk=chunk).cpu().numpy()
        for ci in np.flatnonzero(chunk_max):
            width = min(_canonical_k(int(chunk_max[ci])), chunk)
            ids_c, d_c = select_ops.compact_chunk(
                x, q_s, fmask_s, coded_s, cells_s, int(ci) * chunk, valid,
                metric=metric, chunk=chunk, width=width,
            )
            ids_s.append(torch.where(ids_c >= 0, ids_c + offset, -1))
            dist_s.append(d_c)
        if ids_s:  # kept on the device, copied to the host once a shard
            ids_parts.append(torch.cat(ids_s, dim=1).cpu().numpy())
            dist_parts.append(torch.cat(dist_s, dim=1).cpu().numpy())
    if ids_parts:
        # shard-major, then chunk-major: each query's rows stay in table order
        ids_all = np.concatenate(ids_parts, axis=1)
        d_all = np.concatenate(dist_parts, axis=1)
    else:
        ids_all = np.full((num_queries, 1), -1, np.int64)
        d_all = np.full((num_queries, 1), np.inf, np.float32)
    METRICS.add("search.nomax_selected")
    _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
    return gather_results(data, select, d_all, ids_all, value_dtype, views=views)


def _scan_copies(cache: DeviceCache, req: SearchRequest, sharded: bool = False) -> dict:
    """kwargs holding the phase-1 scan copy of the request's precision
    (empty for fp32); the row-sharded copy with ``sharded``."""
    if req.precision == "bf16":
        return {"corpus_scan": cache.matrix_bf16(req.source, req.column, sharded=sharded).data}
    if req.precision == "int8":
        v8, sv = cache.matrix_int8(req.source, req.column, sharded=sharded)
        return {"corpus_scan_int8": (v8.data, sv.data)}
    return {}


def _scan_args(scan: dict) -> tuple:
    """:func:`_scan_copies` as the positional arguments of the
    ``parallel/search.py`` steps."""
    if "corpus_scan" in scan:
        return (scan["corpus_scan"],)
    return scan.get("corpus_scan_int8", ())


def _pad_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``x`` with rows of ``fill`` appended up to ``rows``."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_full((rows - x.shape[0], *x.shape[1:]), fill)])


def _ring_route(cache: DeviceCache, q: int) -> "int | None":
    """The ring's padded query count when a mesh request of ``q`` queries
    takes it (the JAX package's rule on its padded count), else None."""
    threshold = _ring_threshold()
    if threshold is None or _canonical_q(q) < threshold:
        return None
    n = cache.mesh.size
    return -(-q // n) * n


def _mesh_exact(
    cache: DeviceCache, req: SearchRequest, corpus, queries: torch.Tensor, metric: str,
    plan: _FilterPlan, k_pad: int, snap_stamp: tuple,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the mesh: the ring from the threshold on, else
    the replicated queries and the all-gather merge. Results ``[Q,
    k_pad]`` on the mesh's first device."""
    mesh = cache.mesh
    aux_mul, aux_add = cache.sharded_aux(req.source, req.column, metric)
    aux_add = plan.overlay(aux_add)
    scan = _scan_args(_scan_copies(cache, req, sharded=True))
    _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
    q = queries.shape[0]
    ring_q = _ring_route(cache, q)
    if ring_q is not None:
        METRICS.add("search.mesh_ring")
        fn = psearch.build_ring_search(mesh, k_pad, metric, req.precision)
        dists, ids = fn(corpus.data, _pad_rows(queries, ring_q, 0.0), aux_mul, aux_add, *scan)
        return dists[:q], ids[:q]
    METRICS.add("search.mesh_gather")
    fn = psearch.build_serving_search(mesh, k_pad, metric, precision=req.precision)
    return fn(corpus.data, queries, aux_mul, aux_add, *scan)


def _mesh_probed(
    cache: DeviceCache, req: SearchRequest, coding_data, corpus, queries: torch.Tensor, cells_np: np.ndarray,
    cells: torch.Tensor, metric: str, plan: _FilterPlan, k_pad: int, snap_stamp: tuple,
) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF over the mesh: the per-shard clustered gather when each shard's
    gather moves at most about one local corpus pass, else the masked scan
    (all-gather or ring). The route rule is the JAX package's, on the
    padded query count and each shard's bucket lists."""
    mesh = cache.mesh
    q = queries.shape[0]
    q_pad = _canonical_q(q)
    t = time.perf_counter()
    bucket_stack = None
    with profiling.annotate("ivf.route"):
        if _clustered_eligible(coding_data):
            perm_local, offsets, _ = cache.sharded_clustered_meta(req.coding, req.source, req.column)
            if perm_local.shape[0] != plan.n_pad:
                raise _StaleRevision
            per = perm_local.shape[0] // mesh.size
            bucket = topk2.bucket_for(q_pad, per)
            lists = [_ivf_bucket_lists(cells_np, offsets[s], bucket, per // bucket) for s in range(mesh.size)]
            width = max(b.shape[1] for b in lists)
            if q_pad * width * bucket <= per:
                bucket_stack = np.stack(
                    [np.pad(b, ((0, 0), (0, width - b.shape[1])), constant_values=-1) for b in lists]
                )
    METRICS.add("ivf.route_seconds", time.perf_counter() - t)

    if bucket_stack is not None:
        corpus_s, coded_s, orig = cache.sharded_clustered(req.coding, req.source, req.column)
        mul_s, add_s = cache.sharded_clustered_aux(req.coding, req.source, req.column, metric)
        add_s = plan.overlay(add_s, req.coding)
        _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
        METRICS.add("search.ivf_clustered")
        fn = psearch.build_serving_ivf_clustered(mesh, k_pad, metric)
        return fn(corpus_s.data, queries, mul_s, add_s, coded_s.data, orig.data, cells,
                  torch.from_numpy(bucket_stack))

    coded = cache.coded_ids(req.coding, req.source, req.column, sharded=True)
    aux_mul, aux_add = cache.sharded_aux(req.source, req.column, metric)
    aux_add = plan.overlay(aux_add)
    scan = _scan_args(_scan_copies(cache, req, sharded=True))
    _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
    METRICS.add("search.ivf_scan")
    ring_q = _ring_route(cache, q)
    if ring_q is not None:
        # each block's probe cells ride with it (padding queries probe −1,
        # which matches no cell)
        METRICS.add("search.mesh_ring")
        fn = psearch.build_ring_search(mesh, k_pad, metric, req.precision, probed=True)
        dists, ids = fn(corpus.data, _pad_rows(queries, ring_q, 0.0), aux_mul, aux_add, *scan, coded.data,
                        _pad_rows(cells, ring_q, -1))
        return dists[:q], ids[:q]
    METRICS.add("search.mesh_gather")
    fn = psearch.build_serving_search(mesh, k_pad, metric, probed=True, precision=req.precision)
    return fn(corpus.data, queries, aux_mul, aux_add, *scan, coded.data, cells)


def _probed_topk(
    cache: DeviceCache, req: SearchRequest, coding_data, corpus, queries: torch.Tensor,
    target: np.ndarray, metric: str, plan: _FilterPlan, k_pad: int, snap_stamp: tuple,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The IVF routes: the clustered gather when the coder permits an
    offset table and the gather moves at most about one corpus pass, else
    the masked scan. Returns device ``(dists, ids)`` ``[Q, k_pad]``."""
    n_pad = corpus.rows_padded
    q_pad = _canonical_q(target.shape[0])
    t = time.perf_counter()
    cells_np, cells = _rank_cells(cache, req.coding, target, metric, int(req.probes), queries)
    METRICS.add("ivf.rank_seconds", time.perf_counter() - t)
    if cache.mesh is not None:
        return _mesh_probed(cache, req, coding_data, corpus, queries, cells_np, cells, metric, plan, k_pad, snap_stamp)

    t = time.perf_counter()
    bucket_lists = None
    with profiling.annotate("ivf.route"):
        if _clustered_eligible(coding_data):
            perm, offsets = cache.clustered_meta(req.coding, req.source, req.column)
            if perm.shape[0] != n_pad:
                raise _StaleRevision  # snapshot and layout span revisions
            bucket = topk2.bucket_for(q_pad, n_pad)
            bucket_lists = _ivf_bucket_lists(cells_np, offsets, bucket, n_pad // bucket)
            # the clustered gather moves Q·B·bucket rows in scattered chunks,
            # the masked scan reads the corpus once whatever Q is
            if q_pad * bucket_lists.shape[1] * bucket > n_pad:
                bucket_lists = None
    METRICS.add("ivf.route_seconds", time.perf_counter() - t)

    if bucket_lists is None:
        coded = cache.coded_ids(req.coding, req.source, req.column)
        aux_mul, aux_add = cache.metric_aux(req.source, req.column, metric)
        aux_add = plan.overlay(aux_add)
        scan = _scan_copies(cache, req)
        _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
        METRICS.add("search.ivf_scan")
        return topk2.topk_two_phase_probed(
            corpus.data, queries, aux_mul, aux_add, coded.data, cells, k=k_pad, metric=metric, **scan
        )

    corpus_s, coded_s, orig_ids = cache.clustered(req.coding, req.source, req.column)
    aux_mul_s, aux_add_s = cache.clustered_aux(req.coding, req.source, req.column, metric)
    aux_add_s = plan.overlay(aux_add_s, req.coding)
    _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
    METRICS.add("search.ivf_clustered")
    # the gather rescores fp32-true: ``precision`` has no scan to quantize
    return topk2.topk_ivf_clustered(
        corpus_s.data, queries, aux_mul_s, aux_add_s, coded_s.data, orig_ids.data, cells,
        torch.from_numpy(bucket_lists).to(cache.device), k=k_pad, metric=metric,
    )


def _gather_pool() -> ThreadPoolExecutor:
    """The process's threads for the chunked vector gather, made on first
    use (a pool made per request costs about as much as it saves)."""
    global _GATHER_POOL
    with _GATHER_POOL_LOCK:
        if _GATHER_POOL is None:
            _GATHER_POOL = ThreadPoolExecutor(max_workers=os.cpu_count() or 1, thread_name_prefix="fenix-gather")
        return _GATHER_POOL


def _gather_chunked(chunks: list[np.ndarray], row_ids: np.ndarray) -> np.ndarray:
    """Rows ``row_ids`` of the concatenation of ``chunks``, without
    concatenating them, through ``native.gather_rows`` (the JAX package
    gathers its one view so). A table streamed in over Flight has one
    chunk per batch, and a request's rows fall a few hundred to a chunk,
    under the native gather's own thread grain: so each chunk's rows are
    gathered into a contiguous block of a chunk-grouped buffer, the
    chunks spread over threads when there are many rows, and one threaded
    native gather puts the buffer in request order."""
    if len(chunks) == 1:
        return native.gather_rows(chunks[0], row_ids)
    starts = np.cumsum([0] + [c.shape[0] for c in chunks])
    which = np.searchsorted(starts, row_ids, side="right") - 1
    # numpy sorts 16-bit integers stably by radix
    order = np.argsort(which.astype(np.uint16) if len(chunks) <= 1 << 16 else which, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(which, minlength=len(chunks)))])
    local = row_ids[order] - starts[which[order]]
    grouped = np.empty((row_ids.shape[0], *chunks[0].shape[1:]), chunks[0].dtype)

    def gather(c: int) -> None:
        lo, hi = bounds[c], bounds[c + 1]
        native.gather_rows(chunks[c], local[lo:hi], out=grouped[lo:hi])

    held = np.flatnonzero(np.diff(bounds))  # only the chunks holding ids
    if row_ids.shape[0] >= _THREADED_GATHER_ROWS:
        list(_gather_pool().map(gather, held))  # ctypes calls release the GIL
    else:
        for c in held:
            gather(c)
    position = np.empty_like(order)
    position[order] = np.arange(order.shape[0])
    return native.gather_rows(grouped, position)


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

    Columns with a numpy view (session.host_column_views) gather into
    single-chunk Arrow arrays — vectors and typed columns' storage chunk
    by chunk through ``native.gather_rows`` (a typed column wrapped back
    in its type), scalars with numpy indexing; the rest (strings, nested
    columns, nullable columns) take a per-column Arrow ``take``, keeping
    their exact result types. An extension column read without its type
    registered keeps its ``ARROW:extension:*`` field metadata, so the
    result's IPC form is the typed column's."""
    with profiling.annotate("fenix.result_gather", counter="results.gather"):
        num_queries, k = ids.shape
        valid = ids >= 0  # [Q, k]
        row_ids = ids[valid].astype(np.int64)

        fields: list[pa.Field] = []
        arrays: list[pa.Array | pa.ChunkedArray] = []
        ids_arr: pa.Array | None = None
        for name in select:
            if any(f.name == name for f in fields):
                continue  # a repeated name is one column, as in a dict
            if name == DIST_COL:
                arr = pa.array(dists[valid].astype(value_dtype))
                fields.append(pa.field(DIST_COL, arr.type))
                arrays.append(arr)
                continue
            view = views.get(name) if views is not None else None
            if view is not None:
                v, value_type, ext = view
                if isinstance(v, list):  # per-chunk [rows, D] vector (or typed storage) views
                    arr = ingest.numpy_to_fixed_size_list(_gather_chunked(v, row_ids), value_type)
                    if ext is not None:
                        arr = pa.ExtensionArray.from_storage(ext, arr)
                else:
                    arr = pa.array(v[row_ids])
            else:
                if ids_arr is None:
                    ids_arr = pa.array(row_ids)
                arr = data.column(name).take(ids_arr)
                if isinstance(arr, pa.ChunkedArray):
                    arr = arr.combine_chunks()  # result-sized, cheap
            fields.append(pa.field(name, arr.type, metadata=types.extension_metadata(data.schema.field(name))))
            arrays.append(arr)

        if num_queries > 1:
            qids = np.broadcast_to(
                np.arange(num_queries, dtype=np.int64)[:, None], (num_queries, k)
            )[valid]
            fields.append(pa.field(QUERY_COL, pa.int64()))
            arrays.append(pa.array(qids))
        return pa.Table.from_arrays(arrays, schema=pa.schema(fields))
