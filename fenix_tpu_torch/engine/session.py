"""Device-resident column cache — port of ``DeviceCache`` from
``fenix_tpu/engine/session.py``.

A cache of device-resident padded column tensors keyed by (source,
column): the first query against a table pays the host→device copy;
later queries run out of device memory. Tables are immutable artifacts
(rewritten atomically on ingest), so entries are keyed by the table's
revision stamp and rebuilt when it moves.

Ported: the host table, the snapshot (host table + device matrix of one
revision), the fp32 matrix (a new revision rebuilds it in full), the
metric aux vectors, the bf16 and int8 scan copies, zero-copy host column
views for the result gather, the LRU budget and ``invalidate``. All
tensors live on the one ``device`` the cache was made for; nothing moves
to the CPU when a CUDA device was asked for. The incremental append /
delete refreshes and the mesh-sharded layouts wait (ROADMAP queue 1).
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Sequence

import pyarrow as pa
import torch

from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.io.locks import read_stable
from fenix_tpu_torch.ops import distance as distance_ops
from fenix_tpu_torch.ops import topk2
from fenix_tpu_torch.utils import hbm

# Row-block granularity for padded device columns (the JAX package's).
DEFAULT_BLOCK = 16384


def _source_key(source: str | Sequence[str]) -> tuple[str, ...]:
    return (source,) if isinstance(source, str) else tuple(source)


class DeviceCache:
    """Per-root cache of host tables and device-resident columns on one
    ``device`` (default ``cuda``)."""

    def __init__(
        self, root: str, block: int = DEFAULT_BLOCK, device: "str | torch.device" = "cuda"
    ) -> None:
        self.root = root
        self.block = block
        self.device = torch.device(device)
        self._host: dict = {}
        self._device: dict = {}
        # The Flight server dispatches handlers from a thread pool; one
        # reentrant lock serializes cache fills (first query per column)
        # — steady-state hits only read the dicts.
        self._lock = threading.RLock()
        # LRU eviction under FENIX_HBM_BUDGET: recency stamp per entry.
        # itertools.count is atomic under the GIL, and _touch runs on the
        # lock-free hit path.
        self._recency: dict = {}
        self._access = itertools.count(1)
        self.evictions: int = 0

    def _touch(self, ckey) -> None:
        self._recency[ckey] = next(self._access)

    def _maybe_evict(self, keep) -> None:
        """When FENIX_HBM_BUDGET (bytes) is set and cached device entries
        exceed it, drop the least recently used entries (never the one
        just built). In-flight requests keep their tensors alive."""
        env = os.environ.get("FENIX_HBM_BUDGET", "")
        budget = hbm.parse_budget(env) if env else None
        if not budget:
            return
        with self._lock:
            while self.device_bytes() > budget:
                candidates = [k for k in self._device if k != keep]
                if not candidates:
                    return
                victim = min(candidates, key=lambda k: self._recency.get(k, 0))
                del self._device[victim]
                self._recency.pop(victim, None)
                self.evictions += 1

    def _mtimes(self, sources: tuple[str, ...]) -> tuple:
        # revision tokens: base identity + live delta parts (table.stamp)
        return tuple(table.stamp(self.root, s) for s in sources)

    def _memo(self, store: dict, ckey, stamp, build):
        """Double-checked locked memoization keyed by revision stamps."""
        hit = store.get(ckey)
        if hit is not None and hit[0] == stamp:
            if store is self._device:
                self._touch(ckey)
            return hit[1]
        with self._lock:
            hit = store.get(ckey)
            if hit is not None and hit[0] == stamp:
                if store is self._device:
                    self._touch(ckey)
                return hit[1]
            value = build()
            store[ckey] = (stamp, value)
            if store is self._device:
                self._touch(ckey)
                self._maybe_evict(ckey)
            return value

    def device_bytes(self) -> int:
        """Device bytes held by cached entries (deduplicated by storage)."""
        total = 0
        seen: set[int] = set()

        def add(x) -> None:
            nonlocal total
            if isinstance(x, ingest.DeviceColumn):
                add(x.data)
            elif isinstance(x, (tuple, list)):
                for y in x:
                    add(y)
            elif isinstance(x, torch.Tensor) and x.data_ptr() not in seen:
                seen.add(x.data_ptr())
                total += x.numel() * x.element_size()

        with self._lock:
            for _, value in self._device.values():
                add(value)
        return total

    def host_table(self, source: str | Sequence[str]) -> pa.Table:
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build() -> pa.Table:
            # A newer revision frees the superseded device entries of
            # this table eagerly (scan copies hold corpus-sized memory).
            # Mutate in place: concurrent _memo calls hold this dict.
            for stale in [
                k
                for k, (entry_stamp, _) in self._device.items()
                if k[0] == key and entry_stamp != stamp
            ]:
                del self._device[stale]
            return table.load(self.root, key if len(key) > 1 else key[0])

        return self._memo(self._host, key, stamp, build)

    def host_column_views(
        self, source: str | Sequence[str], data: pa.Table, token
    ) -> dict:
        """Numpy views of the result-gatherable columns of ``data``:
        null-free int/float/bool primitives (1-D) and float FixedSizeList
        vectors, the latter as a list of zero-copy ``[rows, D]`` views, one
        per Arrow chunk (a table streamed in over Flight has one chunk per
        batch; Arrow ``take`` on such a column concatenates every chunk,
        a corpus-sized copy per request). Other columns are absent and the
        executor takes them with Arrow ``take``. Memoized under the
        caller's snapshot revision ``token``."""
        key = _source_key(source)

        def build() -> dict:
            views: dict = {}
            for name in data.column_names:
                col = data.column(name)
                t = col.type
                try:
                    if col.null_count or isinstance(t, pa.ExtensionType):
                        continue
                    if pa.types.is_fixed_size_list(t) and pa.types.is_floating(t.value_type):
                        if col.num_chunks:
                            chunks = [ingest.fixed_size_list_to_numpy(c) for c in col.chunks]
                            views[name] = (chunks, t.value_type)
                    elif (
                        pa.types.is_integer(t)
                        or pa.types.is_floating(t)
                        or pa.types.is_boolean(t)
                    ):
                        views[name] = (ingest.scalar_column_to_numpy(col), None)
                except (pa.ArrowInvalid, ValueError):
                    continue  # non-viewable layout: Arrow take
            return views

        return self._memo(self._host, (key, "host_column_views"), token, build)

    # -- device columns ---------------------------------------------------

    def matrix(self, source: str | Sequence[str], column: str) -> ingest.DeviceColumn:
        """Padded ``[N_pad, D]`` fp32 vector column on the device. A new
        table revision rebuilds it from the host in full."""
        key = _source_key(source)
        stamp = self._mtimes(key)
        ckey = (key, column, "matrix")

        hit = self._device.get(ckey)
        if hit is not None and hit[0] == stamp:
            self._touch(ckey)
            return hit[1]

        with self._lock:
            hit = self._device.get(ckey)
            if hit is not None and hit[0] == stamp:
                return hit[1]
            self._device.pop(ckey, None)  # free the old revision first
            # the stamp stored with the entry must describe the revision
            # the rows came from
            value, s1 = read_stable(
                lambda: self._mtimes(key),
                lambda: ingest.to_device_matrix(
                    table.load(self.root, key if len(key) > 1 else key[0]).column(column),
                    block=self.block,
                    device=self.device,
                ),
                f"table {source!r}",
            )
            self._device[ckey] = (s1, value)
            self._touch(ckey)
            self._maybe_evict(ckey)
            return value

    def matrix_bf16(self, source: str | Sequence[str], column: str) -> ingest.DeviceColumn:
        """bf16 copy of the vector column for half-traffic phase-1 scans
        (``precision="bf16"``; fp32 stays resident for the rescore)."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build() -> ingest.DeviceColumn:
            full = self.matrix(source, column)
            return ingest.DeviceColumn(data=full.data.to(torch.bfloat16), rows=full.rows)

        return self._memo(self._device, (key, column, "matrix_bf16"), stamp, build)

    def matrix_int8(self, source: str | Sequence[str], column: str):
        """Per-row symmetric int8 copy ``(v8, sv)`` of the vector column
        for quarter-traffic phase-1 scans (``precision="int8"``). Padding
        rows are zeros and quantize to zeros."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            full = self.matrix(source, column)
            v8, sv = topk2.quantize_corpus_int8(full.data)
            return (
                ingest.DeviceColumn(data=v8, rows=full.rows),
                ingest.DeviceColumn(data=sv, rows=full.rows),
            )

        return self._memo(self._device, (key, column, "matrix_int8"), stamp, build)

    def metric_aux(self, source: str | Sequence[str], column: str, metric: str):
        """Cached per-row (aux_mul, aux_add) for the fused score
        (ops.topk2.prepare_aux) with padding rows masked to −inf.
        Request filters overlay on top per query."""
        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            col = self.matrix(source, column)
            valid = torch.arange(col.rows_padded, device=self.device) < col.rows
            return topk2.prepare_aux(col.data, valid, canonical)

        return self._memo(self._device, (key, column, "aux", canonical), stamp, build)

    def snapshot(self, source: str | Sequence[str], column: str):
        """``(host table, device matrix, revision stamp)`` of ONE table
        revision, retried until stable. Fetching them separately could
        straddle a concurrent re-ingest and gather ids from a different
        table version than was scanned. Executors re-check the stamp
        (:meth:`snapshot_stamp`) after fetching the other device entries
        (aux, scan copies), which memoize under their own stamps."""
        def read():
            return self.host_table(source), self.matrix(source, column)

        (data, matrix), stamp = read_stable(
            lambda: self.snapshot_stamp(source), read, f"table {source!r}"
        )
        return data, matrix, stamp

    def snapshot_stamp(self, source: str | Sequence[str]) -> tuple:
        """The revision token :meth:`snapshot` stabilizes under."""
        return self._mtimes(_source_key(source))

    def invalidate(self) -> None:
        with self._lock:
            self._host.clear()
            self._device.clear()
