"""Work-conserving search micro-batching — port of
``fenix_tpu/engine/batching.py``.

Concurrent small searches are bound by the host (a Q=1 request costs
about ten times its phase-1 kernel), so N of them issued one by one
serialize into N × (host overhead + scan). A per-cache dispatcher thread
drains every queued request at once, groups them by
``executor.batch_key`` (one dispatch per distinct source, column,
metric, precision, residency, coder with probes, and predicate) and runs
each group as ONE device search (``executor.execute_search_batched``).
When the server is idle a lone request is dispatched at once, so
batching adds no latency; under load batches form as fast as the card
drains them.

A request that cannot join a batch (``executor.batchable``: no-top-k
reads, no metric, ``extra`` knobs), whose table or column is missing,
whose metric is bad, or with more than ``max_queries // 2`` queries runs
solo on the caller's thread. A batch that fails is retried member by
member, so only a faulty request gets its error; no waiter is left
hanging. Counters: ``batch.dispatches``, ``batch.requests``,
``batch.queries`` and ``batch.drains`` (queue drains, each giving one
dispatch per distinct key).

Spans (``utils/profiling``, recorded while a capture is active): on the
handler's thread ``batch.wait`` (submit to done) or ``search.solo``; on
the dispatcher's ``batch.idle`` (waiting on an empty queue) and
``batch.dispatch`` (one group, its members' request ids); on the
completer's ``batch.finish``. Timers: ``batch.queue_wait_seconds`` (each
request's wait from its enqueue until a drain takes it),
``batch.dispatch_seconds``, and ``batch.dispatch_host_seconds`` and
``batch.dispatch_cpu_seconds`` (a dispatch's wall and its thread's CPU
seconds, less its ``fenix.fetch`` waits for the card).

``FENIX_PIPELINE_DEPTH > 0`` adds a completion thread that waits for
each batch's results while the dispatcher launches the next (at most
that many batches in flight); the default 0 finishes each batch on the
dispatcher thread, as in the JAX package.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque

import numpy as np
import pyarrow as pa

from fenix_tpu_torch.engine import executor
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest
from fenix_tpu_torch.utils import profiling
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

# Upper bound on coalesced queries per dispatch: bounds the [Q, N/bucket]
# phase-1 output and the rescore's staging.
MAX_BATCH_QUERIES = 4096


class _Item:
    __slots__ = ("req", "queries", "key", "request", "enqueued", "result", "error", "done", "inflight")

    def __init__(
        self, req: executor.SearchRequest, queries: int, key: tuple, request: "int | None" = None
    ) -> None:
        self.req = req
        self.queries = queries
        self.key = key
        self.request = request  # the search's request id
        self.enqueued = time.perf_counter()
        self.result: pa.Table | None = None
        self.error: BaseException | None = None
        self.done = threading.Event()
        self.inflight = False


class SearchBatcher:
    """Queue and two-stage pipeline (dispatch / completion) for one
    ``DeviceCache``."""

    def __init__(self, cache: DeviceCache, max_queries: int = MAX_BATCH_QUERIES) -> None:
        self.cache = cache
        self.max_queries = max_queries
        self._queue: deque[_Item] = deque()
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self.pipeline_depth = int(os.environ.get("FENIX_PIPELINE_DEPTH", "0"))
        # (group, finish) pairs in flight; bounded for backpressure
        self._inflight: queue.Queue = queue.Queue(maxsize=max(self.pipeline_depth, 1))
        self._completer: threading.Thread | None = None

    # -- public -----------------------------------------------------------

    def submit(self, req: executor.SearchRequest, request: "int | None" = None) -> pa.Table:
        """``req``'s result; ``request`` is its request id, for the spans."""
        queued = self._queued(req)
        if queued is None:
            with profiling.annotate("search.solo", requests=(request,)):
                return executor.execute_search(self.cache, req)
        with profiling.annotate("batch.wait", requests=(request,)):
            return self._wait(_Item(req, *queued, request))

    def _queued(self, req: executor.SearchRequest) -> "tuple[int, tuple] | None":
        """``(queries, batch key)`` of a request that may join a batch,
        else None: it runs solo, on the caller's thread."""
        if not executor.batchable(req):
            return None
        try:
            field = self.cache.host_table(req.source).schema.field(req.column)
            dim = ingest.vector_field_type(field).list_size
        except Exception:
            return None  # missing table or column: fail on the caller's thread
        queries = _query_count(req.target, dim)
        if queries is None or queries > self.max_queries // 2:
            return None
        try:
            # the key validates the metric: a bad request fails on the
            # caller's thread instead of reaching the dispatcher
            return queries, executor.batch_key(req)
        except Exception:
            return None

    def _wait(self, item: _Item) -> pa.Table:
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="fenix-search-batcher", daemon=True)
                self._thread.start()
            if self.pipeline_depth > 0 and (self._completer is None or not self._completer.is_alive()):
                self._completer = threading.Thread(
                    target=self._complete, name="fenix-search-completer", daemon=True
                )
                self._completer.start()
            self._queue.append(item)
            self._cv.notify()
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.result

    # -- dispatcher ---------------------------------------------------------

    def _drain(self) -> list[_Item]:
        """Everything queued, up to ``max_queries`` queries; waits while the
        queue is empty."""
        with self._cv:
            if not self._queue:
                with profiling.annotate("batch.idle"):
                    while not self._queue:
                        self._cv.wait()
            items: list[_Item] = []
            total = 0
            while self._queue and total + self._queue[0].queries <= self.max_queries:
                item = self._queue.popleft()
                items.append(item)
                total += item.queries
        METRICS.add("batch.queue_wait_seconds", len(items) * time.perf_counter() - sum(i.enqueued for i in items))
        return items

    def _run(self) -> None:
        while True:
            items = self._drain()
            METRICS.add("batch.drains")
            try:
                groups: dict[tuple, list[_Item]] = {}
                for item in items:
                    groups.setdefault(item.key, []).append(item)
                for group in groups.values():
                    self._dispatch(group)
            except Exception:  # noqa: BLE001 — the dispatcher must not die
                pass
            finally:
                # never hang a waiter: whatever is neither in flight nor
                # resolved gets an error now
                for item in items:
                    if not item.done.is_set() and not item.inflight:
                        if item.error is None and item.result is None:
                            item.error = RuntimeError("batch dispatcher error")
                        item.done.set()

    def _dispatch(self, group: list[_Item]) -> None:
        """One group as one device search. Its members are released once
        the dispatch's span and counters are in, so a caller that has its
        answer finds its dispatch counted."""
        with profiling.annotate(
            "batch.dispatch", counter="batch.dispatch", cpu=True, requests=tuple(item.request for item in group)
        ):
            settled = self._search(group)
        for item in settled:
            item.done.set()

    def _search(self, group: list[_Item]) -> list[_Item]:
        """Launch ``group`` and, without a completer, finish it; returns the
        members it settled (none while they are in flight)."""
        METRICS.add("batch.dispatches")
        METRICS.add("batch.requests", len(group))
        METRICS.add("batch.queries", sum(item.queries for item in group))
        try:
            finish = executor.execute_search_batched(self.cache, [item.req for item in group], defer=True)
        except Exception as exc:  # noqa: BLE001 — delivered to the callers
            self._fallback_solo(group, exc)
            return group
        if self.pipeline_depth <= 0:
            self._finish_group(group, finish)
            return group
        for item in group:
            item.inflight = True
        self._inflight.put((group, finish))  # bounded: backpressure
        return []

    def _complete(self) -> None:
        while True:
            group, finish = self._inflight.get()
            with profiling.annotate("batch.finish", requests=tuple(item.request for item in group)):
                self._finish_group(group, finish)
            for item in group:
                item.done.set()

    def _finish_group(self, group: list[_Item], finish) -> None:
        """Each member's result, or its error."""
        try:
            results = finish()
            for item, result in zip(group, results):
                item.result = result
        except Exception as exc:  # noqa: BLE001
            self._fallback_solo(group, exc)

    def _fallback_solo(self, group: list[_Item], exc: BaseException) -> None:
        """A failed batch's results: a poisoned group (one bad target dim,
        say) must not fail innocent members, so each is retried solo."""
        if len(group) > 1:
            for item in group:
                try:
                    item.result = executor.execute_search(self.cache, item.req)
                except Exception as solo_exc:  # noqa: BLE001
                    item.error = solo_exc
        else:
            group[0].error = exc


def _query_count(target, dim: int) -> int | None:
    """Number of queries in a target (a flat array holds Q·dim scalars, as
    ``executor.normalize_target`` reads it), or None when unknown (solo)."""
    if isinstance(target, (pa.Table, pa.ChunkedArray)):
        return len(target)
    if isinstance(target, pa.Array):
        if pa.types.is_fixed_size_list(target.type) or isinstance(target, pa.ExtensionArray):
            return len(target)
        return len(target) // dim if len(target) % dim == 0 else None
    try:
        arr = np.asarray(target)
    except Exception:
        return None
    if arr.ndim == 1:
        return int(arr.size) // dim if arr.size % dim == 0 else None
    if arr.ndim == 2:
        return int(arr.shape[0])
    return None


_BATCHERS: dict[int, SearchBatcher] = {}
_BATCHERS_LOCK = threading.Lock()


def get_batcher(cache: DeviceCache) -> SearchBatcher:
    """The batcher of ``cache`` (one per cache, made on first use)."""
    key = id(cache)
    with _BATCHERS_LOCK:
        batcher = _BATCHERS.get(key)
        if batcher is None or batcher.cache is not cache:
            batcher = SearchBatcher(cache)
            _BATCHERS[key] = batcher
        return batcher
