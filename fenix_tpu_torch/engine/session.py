"""Device-resident column cache — port of ``DeviceCache`` from
``fenix_tpu/engine/session.py``.

A cache of device-resident padded column tensors keyed by (source,
column): the first query against a table pays the host→device copy;
later queries run out of device memory. Entries are keyed by the table's
revision stamp and refreshed when it moves.

Ported: the host table, the snapshot (host table + device matrix of one
revision), the fp32 matrix, the metric aux vectors, the bf16 and int8
scan copies, zero-copy host column views for the result gather, the LRU
budget and ``invalidate``; and for the host-corpus residency modes
(``engine/residency.py``) the host fp32 matrix, the host int8 mirror
with its on-disk sidecar, the host aux and filter masks, and the
int8-resident device copy built without any fp32 on the device. Device
filters: the scalar columns (``scalar``, integers as int32) and
``device_filter_mask``, a predicate evaluated on the card and memoized
per (predicate, revision) in the filter-mask LRU. Joins: the sorted build
side of a join key column (``sorted_key``) and, over a mesh, its
partitioned form (``parted_key`` / ``parted_scalar``: sorted globally on
the host, one contiguous key range per shard). All tensors live on the
``device`` the cache was made for, or, row-sharded, on its mesh's
devices; nothing moves to the CPU when a CUDA device was asked for.

Mutations refresh across one recorded hop instead of re-reading the
corpus: an append grows the fp32 matrix by the delta parts' rows alone
(``_grow_matrix``) and the int8-resident copy by the delta's codes
(``_grow_int8_solo``); a delete or compaction gathers the kept rows on
the card by the keep-mask lineage (``_shrink_matrix``), an upsert does
both. Counted in ``incremental_refreshes`` and ``lineage_refreshes``.
The host int8 mirror quantizes only appended rows and appends them to
its sidecar in place, and gathers kept rows across a delete
(``_host_int8_incremental``). Everything else the device derives from
the matrix (aux, scan copies, clustered layouts) rebuilds from it on the
card under the new stamp.

IVF: the coder (``coding``), the coded host table with the
``__CODED_ID__`` join (``coded_table``, resynced when an index and its
table disagree on rows), the device cell-id column (``coded_ids``) and
the clustered layout: ``clustered_meta`` (host permutation and cell
offsets), ``clustered`` (the permuted fp32 copy, its cell ids and
original row ids, counted in ``device_bytes`` and under the LRU) and
``clustered_aux``, and ``clustered_perm`` (the permutation on the card,
for device filter masks). Past the budget, the cell-sorted host layouts
of the probed host search: ``host_cell_meta``, ``host_clustered_int8``
with its IVF sidecar, and ``host_clustered_aux``. Entries derived from
an index memoize under the table stamp plus the index files' mtimes.

Meshes (``parallel/mesh.py``): a cache made with a ``mesh`` (``"auto"``,
the default, is ``serving_mesh()`` for a CUDA cache and no mesh for a
CPU one) also holds row-sharded entries (``parallel.search.Sharded``,
every shard a whole number of ``block`` rows, so ``_shard_block`` is
``block · S`` and a sharded ``N_pad`` differs from the flat one): the
fp32 matrix (``sharded_matrix``, which an append grows and a delete
shrinks across one recorded hop, counted as the flat matrix's refreshes
are), its validity and aux, the scan copies (``matrix_bf16`` /
``matrix_int8(sharded=True)``), the cell ids, the scalar filter columns
and device filter masks, the per-shard clustered IVF layout
(``sharded_clustered_meta`` / ``sharded_clustered`` /
``sharded_clustered_aux`` / ``sharded_clustered_perm``) and the
int8-resident copy built without device fp32 (``sharded_int8_solo`` and
its aux). ``snapshot`` pairs the host table with the sharded matrix
when a mesh is up.
"""

from __future__ import annotations

import collections
import fcntl
import functools
import glob
import hashlib
import io
import itertools
import json
import logging
import os
import re
import shutil
import threading
import time
from typing import Sequence

import numpy as np
import pyarrow as pa
import torch
from numpy.lib import format as npf

from fenix_tpu_torch import coder as coder_mod
from fenix_tpu_torch import expr as expr_mod
from fenix_tpu_torch import index as index_mod
from fenix_tpu_torch import types
from fenix_tpu_torch.io import arrow, ingest, table
from fenix_tpu_torch.io.locks import catalog_lock, read_stable
from fenix_tpu_torch.ops import distance as distance_ops
from fenix_tpu_torch.ops import relational, topk2
from fenix_tpu_torch.parallel import mesh as mesh_mod
from fenix_tpu_torch.parallel import search as psearch
from fenix_tpu_torch.utils import hbm, profiling
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

LOGGER = logging.getLogger("fenix_tpu_torch")

# Row-block granularity for padded device columns (the JAX package's).
DEFAULT_BLOCK = 16384
# filter masks (host and device) kept per cache, per full predicate with
# its literals: an LRU, since parametric literals would grow it forever
_MASK_CACHE_LIMIT = 128
_INT8_UPLOAD_BLOCKS = 32  # blocks per host→device copy of the int8 mirror
# device entries a new revision refreshes from, instead of dropping them
_REFRESHED_KINDS = ("matrix", "int8_solo", "sharded_matrix")


class _StaleRevision(Exception):
    """A concurrent catalog mutation landed mid-request: the entries read
    along the way span table revisions. Retried by the executor."""


def _source_key(source: str | Sequence[str]) -> tuple[str, ...]:
    return (source,) if isinstance(source, str) else tuple(source)


def _require_int32(host: np.ndarray, column: str) -> np.ndarray:
    """Integer host columns go to the device as int32, the type the device
    expression evaluates them in (the JAX package's device has 32-bit
    lanes). Values outside int32 raise ``ValueError`` instead of wrapping;
    other columns pass through. The JAX package converts int64 only and
    keeps narrower integers: the two differ only where column-by-column
    arithmetic overflows a narrow type."""
    if np.issubdtype(host.dtype, np.integer) and host.dtype != np.int32:
        info = np.iinfo(np.int32)
        if host.size and (host.max() > info.max or host.min() < info.min):
            raise ValueError(
                f"column {column!r} has values outside the device int32 range"
            )
        return host.astype(np.int32)
    return host


@functools.lru_cache(maxsize=256)
def _mask_eval_fn(skeleton_json: str) -> "tuple[expr_mod.Expr, tuple[str, ...]]":
    """The parsed skeleton of a predicate (literals slotted out by
    ``expr.split_literals``) and its fields in order, memoized: requests
    that differ only in literal values share one entry. The JAX package
    keys its jit here; eager torch has nothing to compile."""
    skeleton = expr_mod.Expr.from_json(skeleton_json)
    return skeleton, tuple(sorted(skeleton.fields()))


def _quantize_chunk_rows(dim: int, target_bytes: int = 256 << 20) -> int:
    """Rows per host-quantize slice, sized by bytes: each slice makes
    f32 temporaries about 3× its size."""
    return max(1, target_bytes // (4 * dim))


def _quantize_np(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``topk2.quantize_rows_int8_np`` over ``rows`` in byte-sized slices,
    counted in ``cache.mirror_rows_quantized``."""
    n, d = rows.shape
    codes = np.empty((n, d), np.int8)
    scales = np.empty(n, np.float32)
    step = _quantize_chunk_rows(d)
    for s in range(0, n, step):
        codes[s : s + step], scales[s : s + step] = topk2.quantize_rows_int8_np(rows[s : s + step])
    METRICS.add("cache.mirror_rows_quantized", n)
    return codes, scales


def _write_meta(meta_path: str, stamp_s: str, column: str, shape) -> None:
    """The int8 sidecar's ``meta.json`` (the JAX package's keys), through
    a tmp file."""
    tmp = meta_path + f".tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"stamp": stamp_s, "column": column, "rows": int(shape[0]), "dim": int(shape[1])}, fh)
    os.replace(tmp, meta_path)


def _sweep_dead_tmp(cdir: str) -> None:
    """Remove sidecar ``.tmp-<pid>-*`` files of writers that died (the
    names carry the writer's pid). A live writer's files stay: deleting
    them would make its ``os.replace`` fail mid-write."""
    for orphan in glob.glob(os.path.join(glob.escape(cdir), ".tmp-*")) + glob.glob(
        os.path.join(glob.escape(cdir), "*.tmp-*")
    ):
        m = re.search(r"\.tmp-(\d+)", os.path.basename(orphan))
        if m and int(m.group(1)) != os.getpid():
            try:
                os.kill(int(m.group(1)), 0)
                continue  # writer alive: leave its files
            except ProcessLookupError:
                pass  # dead: sweep
            except OSError:
                continue  # EPERM etc: assume alive
        try:
            os.unlink(orphan)
        except OSError:
            pass


def _npy_append_rows(path: str, arr: np.ndarray, expect_rows: int) -> bool:
    """Append ``arr``'s rows to a ``.npy`` file in place, rewriting the
    header's shape: the O(delta) disk half of the mirror's append
    refresh. False, with the file untouched, when the file does not hold
    ``expect_rows`` rows (a concurrent writer won), the dtype or inner
    shape differ, or the grown shape does not fit the fixed-size header;
    the caller then rewrites in full. The data lands before the header
    grows, so a torn write leaves a parseable old-shape file (and no meta:
    readers rebuild). The JAX package's function."""
    with open(path, "r+b") as fh:
        version = npf.read_magic(fh)
        if version == (1, 0):
            shape, fortran, dtype = npf.read_array_header_1_0(fh)
        elif version == (2, 0):
            shape, fortran, dtype = npf.read_array_header_2_0(fh)
        else:
            return False
        hdr_end = fh.tell()
        if fortran or dtype != arr.dtype or shape[1:] != arr.shape[1:] or shape[0] != expect_rows:
            return False
        buf = io.BytesIO()
        try:
            npf.write_array_header_1_0(
                buf,
                {"descr": npf.dtype_to_descr(dtype), "fortran_order": False,
                 "shape": (shape[0] + arr.shape[0],) + shape[1:]},
            )
        except ValueError:
            return False
        hdr = buf.getvalue()
        if len(hdr) != hdr_end:
            return False  # the shape's digits crossed the header padding
        fh.seek(0, 2)
        fh.write(np.ascontiguousarray(arr).tobytes())
        fh.seek(0)
        fh.write(hdr)
        fh.flush()
        os.fsync(fh.fileno())
    return True


def _grown(old: torch.Tensor, delta: np.ndarray, old_rows: int, new_pad: int, fill: float) -> torch.Tensor:
    """A new ``[new_pad, ...]`` buffer holding ``old``'s first
    ``old_rows`` rows (copied on the device), then the host rows
    ``delta`` (the only upload), then ``fill`` to the end. The old buffer
    is left as it is: a search in flight may still read it."""
    new = torch.empty((new_pad, *old.shape[1:]), dtype=old.dtype, device=old.device)
    new[:old_rows].copy_(old[:old_rows])
    stop = old_rows + delta.shape[0]
    ingest.upload(new[old_rows:stop], delta)
    new[stop:].fill_(fill)
    return new


def _grown_sharded(old: "psearch.Sharded", delta: np.ndarray, old_rows: int, new_pad: int, fill) -> "psearch.Sharded":
    """:func:`_grown` of a row-sharded buffer: new ``[new_pad, ...]``
    shards holding ``old``'s first ``old_rows`` rows (contiguous runs
    copied between the shards' devices when the capacity grows), then the
    host rows ``delta`` (the only upload), then ``fill``. The old shards
    are left as they are."""
    mesh, l_old = old.mesh, old.rows_local
    per = new_pad // mesh.size
    stop = old_rows + delta.shape[0]
    shards = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = s * per, (s + 1) * per
        dst = torch.empty((per, *old.shape[1:]), dtype=old.dtype, device=dev)
        g = lo
        while g < min(hi, old_rows):  # old rows, one run per old shard
            o = g // l_old
            end = min(hi, old_rows, (o + 1) * l_old)
            dst[g - lo : end - lo].copy_(old.shards[o][g - o * l_old : end - o * l_old], non_blocking=True)
            g = end
        a, b = max(lo, old_rows), min(hi, stop)
        if a < b:
            ingest.upload(dst[a - lo : b - lo], delta[a - old_rows : b - old_rows])
        dst[min(max(stop - lo, 0), per) :].fill_(fill)
        shards.append(dst)
    return psearch.Sharded(mesh, shards)


def _kept_sharded(old: "psearch.Sharded", idx: np.ndarray, new_pad: int) -> "psearch.Sharded":
    """The rows ``idx`` (ascending global ids) of a row-sharded buffer,
    re-placed contiguously as ``[new_pad, ...]`` shards with zero padding
    rows: each run of kept rows owned by one old shard is gathered on its
    device (one int64 index upload) and copied to its new shard."""
    mesh, l_old = old.mesh, old.rows_local
    per = new_pad // mesh.size
    shards = []
    for s, dev in enumerate(mesh.devices):
        dst = torch.zeros((per, *old.shape[1:]), dtype=old.dtype, device=dev)
        sel = idx[s * per : (s + 1) * per]
        owner = sel // l_old
        bounds = np.flatnonzero(np.diff(owner)) + 1  # idx ascends: one run per owner
        for a, b in zip(np.concatenate([[0], bounds]), np.concatenate([bounds, [sel.size]])):
            if a == b:
                continue
            o = int(owner[a])
            ix = torch.empty(b - a, dtype=torch.int64, device=mesh.devices[o])
            ingest.upload(ix, (sel[a:b] - o * l_old).astype(np.int64))
            dst[a:b].copy_(old.shards[o].index_select(0, ix), non_blocking=True)
        shards.append(dst)
    return psearch.Sharded(mesh, shards)


class DeviceCache:
    """Per-root cache of host tables and device-resident columns on one
    ``device`` (default ``cuda``) and, with a ``mesh``, row-sharded over
    its devices."""

    def __init__(
        self,
        root: str,
        block: int = DEFAULT_BLOCK,
        device: "str | torch.device" = "cuda",
        mesh: "mesh_mod.Mesh | str | None" = "auto",
    ) -> None:
        self.root = root
        self.block = block
        self.device = torch.device(device)
        if isinstance(mesh, mesh_mod.Mesh) and mesh.process_count > 1:
            raise ValueError("a DeviceCache serves one process; its mesh spans several")
        # "auto" resolves on first use (serving_mesh counts the cards)
        self._mesh = mesh
        self.clustered_builds: int = 0  # clustered layouts built (flat and per shard)
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
        # in-flight builds outside the lock (ckey -> Event), _memo_unlocked
        self._builds: dict = {}
        self._masks: collections.OrderedDict = collections.OrderedDict()
        self.device_mask_builds: int = 0  # device filter masks evaluated
        # revisions served by growing a device buffer by an append's rows,
        # and by the keep-mask lineage (delete, compaction, upsert)
        self.incremental_refreshes: int = 0
        self.lineage_refreshes: int = 0

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

    def _memo_unlocked(self, store: dict, ckey, stamp, build):
        """Memoization whose build runs outside the cache lock (the host
        int8 mirror's quantize + persist takes minutes at scale and must
        not stall every other cold fill). One builder per key: concurrent
        callers wait on its event, then re-check the memo and build
        themselves only if the builder failed or built another revision."""
        while True:
            hit = store.get(ckey)
            if hit is not None and hit[0] == stamp:
                return hit[1]
            with self._lock:
                hit = store.get(ckey)
                if hit is not None and hit[0] == stamp:
                    return hit[1]
                ev = self._builds.get(ckey)
                am_builder = ev is None
                if am_builder:
                    ev = self._builds[ckey] = threading.Event()
            if not am_builder:
                ev.wait()
                continue  # the builder published (or failed): re-check
            try:
                value = build()  # no lock held
                with self._lock:
                    store[ckey] = (stamp, value)
                return value
            finally:
                with self._lock:
                    self._builds.pop(ckey, None)
                ev.set()

    def device_entry_kinds(self) -> dict[str, int]:
        """Cached device entries by kind (``matrix``, ``int8_solo``, ...)."""
        counts: dict[str, int] = {}
        with self._lock:
            for ckey in self._device:
                counts[ckey[2]] = counts.get(ckey[2], 0) + 1
        return counts

    def device_bytes(self) -> int:
        """Device bytes held by cached entries (deduplicated by storage)."""
        total = 0
        seen: set[int] = set()

        def add(x) -> None:
            nonlocal total
            if isinstance(x, ingest.DeviceColumn):
                add(x.data)
            elif isinstance(x, psearch.Sharded):
                add(x.shards)
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
            # this table eagerly (scan copies and clustered layouts hold
            # corpus-sized memory), except the fp32 matrix and the
            # int8-resident copy, which the next refresh grows or
            # shrinks. Entries of an index stamp the table stamp plus the
            # index mtimes: compared by prefix, so a first host load at
            # this revision keeps what this revision built. Mutate in
            # place: concurrent _memo calls hold this dict.
            for stale in [
                k
                for k, (entry_stamp, _) in self._device.items()
                if k[0] == key
                and entry_stamp[: len(stamp)] != stamp
                and not (len(k) == 3 and k[2] in _REFRESHED_KINDS)
            ]:
                del self._device[stale]
            t = time.perf_counter()
            out = table.load(self.root, key if len(key) > 1 else key[0])
            METRICS.add("cache.host_load_seconds", time.perf_counter() - t)
            return out

        return self._memo(self._host, key, stamp, build)

    def host_column_views(
        self, source: str | Sequence[str], data: pa.Table, token, variant: "str | None" = None
    ) -> dict:
        """Numpy views of the result-gatherable columns of ``data``, as
        ``(view, value type, extension type or None)``: null-free
        int/float/bool primitives (1-D), float FixedSizeList vectors and
        the tensor and quint8 columns' FixedSizeList storage (raw codes),
        the latter as a list of zero-copy ``[rows, D]`` views, one per
        Arrow chunk (a table streamed in over Flight has one chunk per
        batch; Arrow ``take`` on such a column concatenates every chunk,
        a corpus-sized copy per request). A typed column's gathered
        storage is wrapped back in its registered type, or keeps its
        field metadata when unregistered (``executor.gather_results``).
        Other columns are absent and the executor takes them with Arrow
        ``take``. Memoized under the caller's snapshot revision ``token``;
        ``variant`` (the coder of a coded table) keeps the plain and coded
        table shapes apart."""
        key = _source_key(source)

        def build() -> dict:
            views: dict = {}
            for name in data.column_names:
                col = data.column(name)
                lv = types.logical_vector(data.schema.field(name))
                t = lv.storage
                try:
                    if col.null_count or lv.kind not in (None, "tensor", "quint8"):
                        continue
                    if pa.types.is_fixed_size_list(t) and (lv.kind is not None or pa.types.is_floating(t.value_type)):
                        if col.num_chunks:
                            chunks = [ingest.storage_view(c) for c in col.chunks]
                            ext = col.type if isinstance(col.type, pa.ExtensionType) else None
                            views[name] = (chunks, t.value_type, ext)
                    elif lv.kind is None and (
                        pa.types.is_integer(t)
                        or pa.types.is_floating(t)
                        or pa.types.is_boolean(t)
                    ):
                        views[name] = (ingest.scalar_column_to_numpy(col), None, None)
                except (pa.ArrowInvalid, ValueError):
                    continue  # non-viewable layout: Arrow take
            return views

        return self._memo(self._host, (key, "host_column_views", variant), token, build)

    # -- host-resident corpus (int8-resident and streaming modes) ----------

    def host_matrix(self, source: str | Sequence[str], column: str) -> np.ndarray:
        """Host ``[N, D]`` fp32 vector column: the exact-rescore side of
        the int8-resident mode and the source of the streaming scan. A
        view of the Arrow memory map for a single-chunk fp32 column (one
        copy otherwise); memoized per revision."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build() -> np.ndarray:
            host = ingest.vector_matrix(self.host_table(source), column)
            return np.ascontiguousarray(host, dtype=np.float32)

        return self._memo(self._host, (key, column, "host_matrix"), stamp, build)

    def host_int8(self, source: str | Sequence[str], column: str):
        """Host int8 mirror ``(codes [N, D] int8, scales [N] f32)`` of the
        vector column (``topk2.quantize_rows_int8_np``), memoized per
        revision: the int8 stream slices its chunks out of it, and
        ``int8_solo`` uploads it.

        Persisted as a revision-stamped sidecar next to the table
        (``table.int8cache_dir/<sha1(column)[:16]>/``: ``codes.npy``,
        ``scales.npy``, ``meta.json`` written last), in the JAX package's
        format, so a restart of either package memory-maps the codes
        instead of quantizing the corpus again. A sidecar one recorded hop
        behind refreshes in O(delta) (``_host_int8_incremental``); any
        other rebuilds in full. Counters: ``cache.int8_sidecar_loads`` /
        ``cache.int8_sidecar_writes``, ``cache.mirror_rows_quantized``,
        ``cache.mirror_delta_refreshes`` and
        ``cache.int8_mirror_build_seconds`` (quantize + write)."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            cdir = self._int8_cdir(key, column)
            stamp_s = json.dumps(stamp)
            loaded = self._read_int8_sidecar(cdir, column)
            if loaded is not None and loaded[2].get("stamp") == stamp_s:
                METRICS.add("cache.int8_sidecar_loads")
                return loaded[0], loaded[1]
            t = time.perf_counter()
            refreshed = self._host_int8_incremental(key, column, stamp, cdir, stamp_s, loaded)
            if refreshed is not None:
                METRICS.add("cache.int8_mirror_build_seconds", time.perf_counter() - t)
                return refreshed
            host = self.host_matrix(source, column)
            codes, scales = _quantize_np(host)
            out = self._write_int8_sidecar(cdir, codes, scales, stamp_s, column)
            METRICS.add("cache.int8_mirror_build_seconds", time.perf_counter() - t)
            return out

        return self._memo_unlocked(self._host, (key, column, "host_int8"), stamp, build)

    def _host_int8_incremental(self, key: tuple, column: str, stamp, cdir, stamp_s: str, sidecar):
        """The mirror refreshed across one recorded hop from the revision
        it holds (in memory, else the sidecar's), or None for a full
        rebuild. An append quantizes only the appended rows and, when the
        sidecar holds the previous revision, appends them to its files in
        place; a delete or compaction gathers the kept rows by the
        keep-mask lineage, quantizing nothing. The JAX package's refresh."""
        if len(key) != 1:
            return None
        name = key[0]
        old = self._host.get((key, column, "host_int8"))
        old_stamp = old_codes = old_scales = None
        if old is not None:
            old_stamp, (old_codes, old_scales) = old
        sidecar_stamp = None
        if sidecar is not None:
            try:
                sidecar_stamp = table.stamps_from_json(sidecar[2]["stamp"])
            except (KeyError, TypeError, ValueError):
                sidecar = None
        if old_codes is None and sidecar is not None:
            old_stamp = sidecar_stamp
            old_codes, old_scales = sidecar[0], sidecar[1]
        if old_codes is None or old_stamp is None:
            return None

        # one recorded hop from the old revision to this one: a pure
        # append, or a lineage hop (delete, compaction) with parts on top
        keep = None
        delta_names = table.append_delta(old_stamp[0], stamp[0])
        if delta_names is None:
            lin = table.lineage(self.root, name)
            if lin is None:
                return None
            lin_old, lin_new, keep = lin
            if lin_old != old_stamp[0] or keep.shape[0] != old_codes.shape[0]:
                return None
            delta_names = [] if lin_new == stamp[0] else table.append_delta(lin_new, stamp[0])
            if delta_names is None:
                return None

        dcodes = dscales = None
        if delta_names:
            try:
                parts = table.load_parts(self.root, name, delta_names)
                delta = ingest.vector_matrix(parts, column).astype(np.float32, copy=False)
            except (FileNotFoundError, KeyError, TypeError):
                return None  # a raced mutation or a schema change
            # parts load by name, and a compaction followed by an append can
            # reuse a name: rows read under a moved stamp must not be
            # persisted as this revision's
            if self._mtimes(key) != stamp:
                return None
            dcodes, dscales = _quantize_np(delta)

        rows_same = keep is None or bool(keep.all())
        sidecar_current = sidecar is not None and sidecar_stamp == old_stamp
        if rows_same and dcodes is not None and sidecar_current:
            appended = self._append_int8_sidecar(
                cdir, dcodes, dscales, stamp_s, column, int(old_codes.shape[0])
            )
            if appended is not None:
                METRICS.add("cache.mirror_delta_refreshes")
                return appended
            # a concurrent writer or a full header: rewrite below

        base_c, base_s = old_codes, old_scales
        if not rows_same:
            idx = np.flatnonzero(keep)
            base_c, base_s = np.asarray(old_codes)[idx], np.asarray(old_scales)[idx]
        if dcodes is not None:
            base_c = np.concatenate([np.asarray(base_c), dcodes])
            base_s = np.concatenate([np.asarray(base_s), dscales])
        elif rows_same and sidecar_current:
            # a compaction: the sidecar's data is this revision's already,
            # so only its meta is stamped anew
            try:
                _write_meta(os.path.join(cdir, "meta.json"), stamp_s, column, old_codes.shape)
                METRICS.add("cache.mirror_delta_refreshes")
                return old_codes, old_scales
            except OSError:
                pass
        METRICS.add("cache.mirror_delta_refreshes")
        return self._write_int8_sidecar(
            cdir, np.ascontiguousarray(base_c), np.ascontiguousarray(base_s), stamp_s, column
        )

    @staticmethod
    def _append_int8_sidecar(cdir, dcodes, dscales, stamp_s: str, column: str, old_rows: int):
        """Grow the persisted sidecar in place by the delta's codes and
        scales (O(delta) disk I/O) under the appenders' flock, meta
        invalidated first and written last; the reloaded ``(codes,
        scales)``, or None for a full rewrite."""
        if cdir is None:
            return None
        meta_path = os.path.join(cdir, "meta.json")
        try:
            with open(os.path.join(cdir, ".append.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if os.path.exists(meta_path):
                    os.unlink(meta_path)  # invalidate before touching data
                codes_path = os.path.join(cdir, "codes.npy")
                scales_path = os.path.join(cdir, "scales.npy")
                if not _npy_append_rows(codes_path, dcodes, old_rows):
                    return None
                if not _npy_append_rows(scales_path, dscales, old_rows):
                    return None
                _write_meta(meta_path, stamp_s, column, (old_rows + dcodes.shape[0], dcodes.shape[1]))
                # reload inside the flock: a writer in another process
                # could otherwise pair codes and scales of two revisions
                codes = np.load(codes_path, mmap_mode="r")
                scales = np.load(scales_path)
                if codes.shape[0] != scales.shape[0]:
                    return None
            METRICS.add("cache.int8_sidecar_writes")
            return codes, scales
        except (OSError, ValueError):
            return None

    def _int8_cdir(self, key: tuple, column: str) -> "str | None":
        if len(key) != 1:
            return None  # joined sources keep their mirror in memory only
        return os.path.join(
            table.int8cache_dir(self.root, key[0]), hashlib.sha1(column.encode()).hexdigest()[:16]
        )

    @staticmethod
    def _read_int8_sidecar(cdir: "str | None", column: str):
        """``(codes mmap, scales, meta)`` of whatever revision the sidecar
        holds (the caller checks the stamp), or None."""
        if cdir is None or not os.path.isdir(cdir):
            return None
        meta_path = os.path.join(cdir, "meta.json")
        try:
            with open(meta_path) as fh:
                meta = json.load(fh)
            if meta.get("column") != column:
                return None
            codes = np.load(os.path.join(cdir, "codes.npy"), mmap_mode="r")
            scales = np.load(os.path.join(cdir, "scales.npy"))
            # a writer in another process may have replaced the files
            # between the meta read and the loads
            with open(meta_path) as fh:
                if json.load(fh) != meta:
                    return None
            if scales.shape[0] != codes.shape[0] or codes.shape[0] != meta.get("rows"):
                return None
            return codes, scales, meta
        except (OSError, ValueError, EOFError):
            return None  # corrupt or absent: the caller rebuilds

    @staticmethod
    def _write_int8_sidecar(cdir: "str | None", codes, scales, stamp_s: str, column: str):
        """Full sidecar (re)write: invalidate the meta, replace the data
        files through tmp files, write the meta last — under the flock
        the JAX package's in-place appender takes, so the two never
        interleave. Returns ``(codes, scales)``, the codes memory-mapped
        from the written file."""
        if cdir is None:
            return codes, scales
        meta_path = os.path.join(cdir, "meta.json")
        try:
            os.makedirs(cdir, exist_ok=True)
            with open(os.path.join(cdir, ".append.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                _sweep_dead_tmp(cdir)
                if os.path.exists(meta_path):
                    os.unlink(meta_path)  # invalidate before touching data
                for arr, fname in ((codes, "codes.npy"), (scales, "scales.npy")):
                    tmp = os.path.join(cdir, f".tmp-{os.getpid()}-{fname}")
                    with open(tmp, "wb") as fh:
                        np.save(fh, np.ascontiguousarray(arr))
                    os.replace(tmp, os.path.join(cdir, fname))
                _write_meta(meta_path, stamp_s, column, codes.shape)
                # serve the page-cache-backed mapping, not the anonymous build array
                codes = np.load(os.path.join(cdir, "codes.npy"), mmap_mode="r")
            METRICS.add("cache.int8_sidecar_writes")
        except OSError:
            # disk full or unwritable root: serve from memory, leave no
            # half-written sidecar (no meta = no sidecar to readers)
            shutil.rmtree(cdir, ignore_errors=True)
        return codes, scales

    def host_aux(self, source: str | Sequence[str], column: str, metric: str):
        """Host ``(aux_mul [N], aux_add [N])`` f32 of the fused score over
        the host corpus (numpy form of ``topk2.prepare_aux``, no mask;
        request filters overlay per request)."""
        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            host = self.host_matrix(source, column)
            sq = np.einsum("nd,nd->n", host, host, dtype=np.float32)
            if canonical == "l2":
                return np.ones_like(sq), -sq
            if canonical == "cosine":
                return (1.0 / np.maximum(np.sqrt(sq), 1e-12)).astype(np.float32), np.zeros_like(sq)
            return np.ones_like(sq), np.zeros_like(sq)

        return self._memo(self._host, (key, column, "host_aux", canonical), stamp, build)

    def host_filter_mask(self, source: str | Sequence[str], filt) -> np.ndarray:
        """Host ``[N]`` bool mask of a predicate, memoized per (predicate,
        revision) in a bounded LRU: the host rescore and the stream
        re-apply it per request."""
        key = _source_key(source)
        stamp = self._mtimes(key)
        ckey = (key, "host", filt.to_json())
        with self._lock:
            hit = self._masks.get(ckey)
            if hit is not None and hit[0] == stamp:
                self._masks.move_to_end(ckey)
                return hit[1]
        mask = np.asarray(filt.mask(self.host_table(source)), dtype=bool)
        with self._lock:
            self._masks[ckey] = (stamp, mask)
            self._masks.move_to_end(ckey)
            while len(self._masks) > _MASK_CACHE_LIMIT:
                self._masks.popitem(last=False)
        return mask

    # -- device columns ---------------------------------------------------

    def scalar(self, source: str | Sequence[str], column: str, *, sharded: bool = False) -> ingest.DeviceColumn:
        """Padded 1-D numeric column on the device (the filter columns):
        integers as int32 (:func:`_require_int32`), float64 as float32,
        bools unpacked from Arrow's bits (the JAX package's zero-copy read
        refuses them, so its bool predicates take the host route), padding
        0 with validity carried by ``rows``. A column with nulls raises
        ``ValueError``: its values have no device form, and the host mask
        answers for it. With ``sharded=True`` it is row-sharded and padded
        like :meth:`sharded_matrix`, row-aligned with it."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build() -> ingest.DeviceColumn:
            col = self.host_table(source).column(column)
            if col.null_count:
                raise ValueError(f"column {column!r} has nulls")
            host = _require_int32(col.to_numpy(), column)
            if sharded:
                return psearch.to_sharded_vector(host, self.mesh, self.block)
            return ingest.to_device_vector(host, block=self.block, device=self.device)

        return self._memo(self._device, (key, column, "scalar", sharded), stamp, build)

    def device_filter_mask(
        self, source: str | Sequence[str], filt, *, sharded: bool = False
    ) -> "torch.Tensor | psearch.Sharded | None":
        """Device ``[N_pad]`` bool mask of a device-evaluable predicate,
        evaluated over the device scalar columns (:meth:`scalar`): a
        filtered search moves no per-request mask to the card, and after
        the first build of a (predicate, revision) nothing crosses at
        all. Padding rows may come out True; the aux overlay already masks
        them. Returns None when a referenced column has no device form
        (values outside int32, nulls, a name the table lacks) or the
        predicate references no column: the caller takes the host mask.
        Memoized per full predicate and revision in the LRU of
        ``_MASK_CACHE_LIMIT``; each evaluation counts in
        ``device_mask_builds``."""
        key = _source_key(source)
        stamp = self._mtimes(key)
        ckey = (key, "device", bool(sharded), filt.to_json())
        with self._lock:
            hit = self._masks.get(ckey)
            if hit is not None and hit[0] == stamp:
                self._masks.move_to_end(ckey)
                return hit[1]
        names = filt.fields()
        if not names:
            return None
        try:
            cols = {name: self.scalar(source, name, sharded=sharded).data for name in names}
        except (KeyError, ValueError):
            return None
        skeleton, literals = filt.split_literals()
        skeleton, order = _mask_eval_fn(skeleton.to_json())

        def evaluate(columns: dict) -> torch.Tensor:
            # 0-dim int32 / float32 slots: the literals' types promote as
            # the JAX package's traced slots do
            out = skeleton.device_mask({n: columns[n] for n in order}, [torch.tensor(v) for v in literals])
            return out if out.dtype == torch.bool else out != 0

        if sharded:  # shard by shard, each over its own rows
            mask = psearch.Sharded(
                self.mesh, [evaluate({n: c.shards[s] for n, c in cols.items()}) for s in range(self.mesh.size)]
            )
        else:
            mask = evaluate(cols)
        with self._lock:
            self._masks[ckey] = (stamp, mask)
            self._masks.move_to_end(ckey)
            while len(self._masks) > _MASK_CACHE_LIMIT:
                self._masks.popitem(last=False)
            self.device_mask_builds += 1
        return mask

    def matrix(self, source: str | Sequence[str], column: str) -> ingest.DeviceColumn:
        """Padded ``[N_pad, D]`` fp32 vector column on the device.

        A revision one recorded hop from the cached one refreshes on the
        card: an append uploads only its delta parts' rows
        (``_grow_matrix``); a delete or compaction gathers the kept rows
        by the keep-mask lineage (``_shrink_matrix``); an upsert does both.
        Counted in ``incremental_refreshes`` and ``lineage_refreshes``. Any
        other revision (an overwrite, an append that folded the parts into
        a new base, a cache two hops behind, a corrupt lineage) rebuilds
        from the host. Timers: ``cache.refresh_seconds`` (a refresh's host
        time) and ``cache.host_load_seconds`` (host table loads)."""
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
            if hit is not None and len(key) == 1:
                t = time.perf_counter()
                grown = self._grow_matrix(key[0], column, hit[0][0], hit[1], stamp[0])
                refreshed = grown
                if grown is None:
                    refreshed = self._shrink_matrix(key[0], column, hit[0][0], hit[1], stamp[0])
                # host time: the uploads end in a sync copy, a gather runs on
                METRICS.add("cache.refresh_seconds", time.perf_counter() - t)
                # a compaction between the stamp read and the part loads can
                # fold the parts and reuse their names: the refreshed rows
                # would be another revision's, so a moved stamp rebuilds
                if refreshed is not None and self._mtimes(key) == stamp:
                    self._device[ckey] = (stamp, refreshed)
                    self._touch(ckey)
                    self._maybe_evict(ckey)
                    if grown is not None:
                        self.incremental_refreshes += 1
                    else:
                        self.lineage_refreshes += 1
                    return refreshed
                del grown, refreshed
            del hit
            self._device.pop(ckey, None)  # free the old revision first
            # the stamp stored with the entry must describe the revision
            # the rows came from: the next refresh trusts it
            def build() -> ingest.DeviceColumn:
                data = table.load(self.root, key if len(key) > 1 else key[0])
                return ingest.to_device_matrix(types.typed_column(data, column), block=self.block, device=self.device)

            value, s1 = read_stable(lambda: self._mtimes(key), build, f"table {source!r}")
            self._device[ckey] = (s1, value)
            self._touch(ckey)
            self._maybe_evict(ckey)
            return value

    def _grow_matrix(
        self, source: str, column: str, old_stamp, old: ingest.DeviceColumn, new_stamp
    ) -> "ingest.DeviceColumn | None":
        """The cached matrix grown by the rows of the parts appended since
        ``old_stamp``: only they cross the link. The new buffer has a cold
        rebuild's capacity and zero padding rows; the old one stays whole
        for searches in flight, so both are resident until the copy ends.
        None when the hop is not an append."""
        delta_names = table.append_delta(old_stamp, new_stamp)
        if not delta_names:
            return None
        try:
            parts = table.load_parts(self.root, source, delta_names)
            delta = ingest.vector_matrix(parts, column).astype(np.float32, copy=False)
        except (FileNotFoundError, KeyError, TypeError):
            return None  # a raced mutation or a schema change: rebuild
        new_rows = old.rows + delta.shape[0]
        cold_pad = max(ingest.round_up(new_rows, self.block), self.block, old.rows_padded)
        return ingest.DeviceColumn(
            data=_grown(old.data, np.ascontiguousarray(delta), old.rows, cold_pad, 0), rows=new_rows
        )

    def _shrink_matrix(
        self, source: str, column: str, old_stamp, old: ingest.DeviceColumn, new_stamp, *, sharded: bool = False
    ) -> "ingest.DeviceColumn | None":
        """The cached matrix refreshed across a delete or compaction by the
        recorded keep-mask lineage (``table.record_lineage``): the kept
        rows are gathered on the card by one int32 index upload (4 B a
        kept row), padding rows zeroed; a compaction (every row kept)
        reuses the buffer. Parts appended on top of the hop grow it
        (an upsert). None when the lineage is absent, corrupt or not this
        hop (the caller rebuilds). With ``sharded=True`` the matrix is
        :meth:`sharded_matrix`'s: the kept rows are re-placed contiguously
        over the shards (copies between the shards' devices)."""
        lin = table.lineage(self.root, source)
        if lin is None:
            return None
        lin_old, lin_new, keep = lin
        if lin_old != old_stamp or keep.shape[0] != old.rows:
            return None
        if bool(keep.all()):
            col = old  # a compaction: the same rows under a new base
        elif sharded:
            idx = np.flatnonzero(keep)
            n_pad, _ = mesh_mod.shard_rows(idx.size, self.mesh, self.block)
            col = ingest.DeviceColumn(data=_kept_sharded(old.data, idx, n_pad), rows=int(idx.size))
        else:
            idx = np.flatnonzero(keep).astype(np.int32)
            new_rows = int(idx.size)
            new_pad = max(ingest.round_up(new_rows, self.block), self.block)
            idx_dev = torch.empty(new_rows, dtype=torch.int32, device=self.device)
            ingest.upload(idx_dev, idx)
            data = torch.zeros((new_pad, old.data.shape[1]), dtype=old.data.dtype, device=self.device)
            torch.index_select(old.data, 0, idx_dev, out=data[:new_rows])
            col = ingest.DeviceColumn(data=data, rows=new_rows)
        if new_stamp == lin_new:
            return col
        grow = self._grow_sharded_matrix if sharded else self._grow_matrix
        return grow(source, column, lin_new, col, new_stamp)

    def _base_matrix(self, source: str | Sequence[str], column: str, sharded: bool) -> ingest.DeviceColumn:
        return self.sharded_matrix(source, column) if sharded else self.matrix(source, column)

    def matrix_bf16(self, source: str | Sequence[str], column: str, *, sharded: bool = False) -> ingest.DeviceColumn:
        """bf16 copy of the vector column for half-traffic phase-1 scans
        (``precision="bf16"``; fp32 stays resident for the rescore); with
        ``sharded=True`` of the row-sharded matrix, shard by shard."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build() -> ingest.DeviceColumn:
            full = self._base_matrix(source, column, sharded)
            if sharded:
                return ingest.DeviceColumn(data=psearch.shard_scan_bf16(full.data), rows=full.rows)
            return ingest.DeviceColumn(data=full.data.to(torch.bfloat16), rows=full.rows)

        return self._memo(self._device, (key, column, "matrix_bf16", sharded), stamp, build)

    def matrix_int8(self, source: str | Sequence[str], column: str, *, sharded: bool = False):
        """Per-row symmetric int8 copy ``(v8, sv)`` of the vector column
        for quarter-traffic phase-1 scans (``precision="int8"``). Padding
        rows are zeros and quantize to zeros. Row-wise, so with
        ``sharded=True`` each shard quantizes its own rows."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            full = self._base_matrix(source, column, sharded)
            quantize = psearch.shard_scan_int8 if sharded else topk2.quantize_corpus_int8
            v8, sv = quantize(full.data)
            return (
                ingest.DeviceColumn(data=v8, rows=full.rows),
                ingest.DeviceColumn(data=sv, rows=full.rows),
            )

        return self._memo(self._device, (key, column, "matrix_int8", sharded), stamp, build)

    def int8_solo(self, source: str | Sequence[str], column: str):
        """Per-row int8 device copy ``(v8 [N_pad, D], sv [N_pad])`` built
        without any fp32 on the device: the host mirror (:meth:`host_int8`)
        is uploaded in chunks into a preallocated int8 tensor, so the int8
        copy is the only corpus-sized device allocation. Padding rows are
        zero codes with scale 1e-30. An append grows it by the delta's
        codes (``_grow_int8_solo``); other revisions upload the refreshed
        mirror. Timed as ``cache.int8_upload_seconds``."""
        key = _source_key(source)
        stamp = self._mtimes(key)
        ckey = (key, column, "int8_solo")
        hit = self._device.get(ckey)
        if hit is not None and hit[0] == stamp:
            self._touch(ckey)
            return hit[1]
        if hit is not None and len(key) == 1:
            # grown outside the cache lock: the mirror's build publishes
            # under it. The entry must still be the one grown from, and the
            # table still at the stamp grown to, when it is published.
            t = time.perf_counter()
            grown = self._grow_int8_solo(key, column, hit[0], hit[1], stamp)
            METRICS.add("cache.refresh_seconds", time.perf_counter() - t)  # the mirror's refresh included
            if grown is not None:
                with self._lock:
                    cur = self._device.get(ckey)
                    if cur is not None and cur[0] == hit[0] and self._mtimes(key) == stamp:
                        self._device[ckey] = (stamp, grown)
                        self._touch(ckey)
                        self._maybe_evict(ckey)
                        self.incremental_refreshes += 1
                        return grown
        del hit
        # the mirror builds outside the cache lock (_memo_unlocked): waiting
        # on its builder while holding the lock would stall the whole cache
        codes, scales = self.host_int8(source, column)

        def build():
            stale = self._device.pop(ckey, None)  # free the old revision first
            del stale
            t = time.perf_counter()
            rows, d = codes.shape
            n_pad = max(ingest.round_up(rows, self.block), self.block)
            v8 = torch.empty((n_pad, d), dtype=torch.int8, device=self.device)
            step = _INT8_UPLOAD_BLOCKS * self.block
            for s in range(0, rows, step):
                part = np.asarray(codes[s : s + step])
                ingest.upload(v8[s : s + part.shape[0]], part)
            v8[rows:].zero_()
            sv = torch.full((n_pad,), 1e-30, dtype=torch.float32, device=self.device)
            ingest.upload(sv[:rows], np.asarray(scales, np.float32))
            METRICS.add("cache.int8_upload_seconds", time.perf_counter() - t)  # ends in a sync copy
            return ingest.DeviceColumn(data=v8, rows=rows), ingest.DeviceColumn(data=sv, rows=rows)

        return self._memo(self._device, ckey, stamp, build)

    def _grow_int8_solo(self, key: tuple, column: str, old_stamp, old, new_stamp):
        """The int8-resident copy grown by an append's rows: their codes
        come from the refreshed mirror (which quantized only them), so the
        upload is the delta's. Capacity is a cold build's; padding rows
        keep zero codes and scale 1e-30. None for any other hop (the
        caller uploads the refreshed mirror)."""
        if table.append_delta(old_stamp[0], new_stamp[0]) is None:
            return None
        v8, sv = old
        codes, scales = self.host_int8(key[0], column)
        # the mirror is stamped against the current table: if it moved
        # again while the mirror built, its rows are not new_stamp's
        if self._mtimes(key) != new_stamp:
            return None
        new_rows = codes.shape[0]
        if new_rows <= v8.rows or codes.shape[1] != v8.data.shape[1]:
            return None  # a raced mutation or a schema change
        cold_pad = max(ingest.round_up(new_rows, self.block), self.block, v8.rows_padded)
        delta_c = np.asarray(codes[v8.rows : new_rows])
        delta_s = np.asarray(scales[v8.rows : new_rows], np.float32)
        return (
            ingest.DeviceColumn(data=_grown(v8.data, delta_c, v8.rows, cold_pad, 0), rows=new_rows),
            ingest.DeviceColumn(data=_grown(sv.data, delta_s, v8.rows, cold_pad, 1e-30), rows=new_rows),
        )

    def int8_solo_aux(self, source: str | Sequence[str], column: str, metric: str):
        """Device ``(aux_mul, aux_add)`` [N_pad] for the int8-resident
        scan, uploaded from the host aux (8 B/row); padding rows −inf."""
        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            mul, add = self.host_aux(source, column, canonical)
            rows = mul.shape[0]
            n_pad = max(ingest.round_up(rows, self.block), self.block)
            mul_p = np.ones(n_pad, np.float32)
            mul_p[:rows] = mul
            add_p = np.full(n_pad, distance_ops.NEG_INF, np.float32)
            add_p[:rows] = add
            return torch.from_numpy(mul_p).to(self.device), torch.from_numpy(add_p).to(self.device)

        return self._memo(self._device, (key, column, "int8_solo_aux", canonical), stamp, build)

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

    def sorted_key(self, source: str | Sequence[str], column: str):
        """``(sorted keys, original positions, valid rows)`` of a join key
        column: the build side of the lookup and inner joins
        (``ops.relational.join_lookup_sorted`` / ``join_inner_sorted``),
        built once per revision of the attribute table. Keys are int32
        (:meth:`scalar` guards the range); padding rows take ``INT32_MAX``
        and sort after every real key of that value. Timer
        ``cache.sorted_key_seconds`` (the column's upload and the sort)."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            t = time.perf_counter()
            col = self.scalar(source, column)
            valid = torch.arange(col.rows_padded, device=self.device) < col.rows
            keys = torch.where(valid, col.data.to(torch.int32), relational.INT32_MAX)
            sk, si = relational.sort_with_index(keys)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # once per revision: time the sort itself
            METRICS.add("cache.sorted_key_seconds", time.perf_counter() - t)
            return sk, si, col.rows

        return self._memo(self._device, (key, column, "sorted_key"), stamp, build)

    def parted_key(self, source: str | Sequence[str], column: str):
        """The partitioned build side of a join key column, for attribute
        tables too large to hold on one card: the keys (int32, padded with
        ``INT32_MAX`` to ``max(round_up(rows, _shard_block),
        _shard_block)``) sort globally and stably on the host and split
        into S contiguous sorted ranges, shard ``s`` holding sorted
        positions ``[s·per, (s+1)·per)`` on its device. A probe key then
        searches each range locally, and its first global match lies on
        the first shard whose range holds the key: the one where it
        exceeds ``bounds[s]``, the previous range's last key (shard 0 has
        ``INT32_MIN`` and claims on the bare match).

        Returns ``(sorted keys, original rows (int32), bounds, rows,
        perm)``: the first two :class:`~fenix_tpu_torch.parallel.search.Sharded`,
        ``bounds`` and ``perm`` (sorted position → original row) host
        arrays. Timer ``cache.parted_key_seconds``."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            t = time.perf_counter()
            data = self.host_table(source)
            host = _require_int32(ingest.scalar_column_to_numpy(data.column(column)), column).astype(np.int32)
            rows = host.shape[0]
            n_shards = self.mesh.size
            a_pad = max(ingest.round_up(rows, self._shard_block), self._shard_block)
            keys = np.full(a_pad, relational.INT32_MAX, np.int32)
            keys[:rows] = host
            perm = np.argsort(keys, kind="stable").astype(np.int32)
            sk = keys[perm]
            per = a_pad // n_shards
            bounds = np.full(n_shards, np.iinfo(np.int32).min, np.int32)
            bounds[1:] = sk[np.arange(1, n_shards) * per - 1]
            out = (psearch.put_rows(self.mesh, sk, a_pad), psearch.put_rows(self.mesh, perm, a_pad), bounds, rows, perm)
            METRICS.add("cache.parted_key_seconds", time.perf_counter() - t)
            return out

        return self._memo(self._device, (key, column, "parted_key"), stamp, build)

    def parted_scalar(self, source: str | Sequence[str], column: str, key_column: str) -> "psearch.Sharded":
        """A scalar column permuted into :meth:`parted_key`'s sorted order
        of ``key_column`` and split alongside it, so that a shard's local
        join hit reads its group or value on its own device. Device types
        as :meth:`scalar`'s (integers int32, float64 as float32); padding
        0."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            _, _, _, rows, perm = self.parted_key(source, key_column)
            host = _require_int32(ingest.scalar_column_to_numpy(self.host_table(source).column(column)), column)
            real = perm < rows
            permuted = np.where(real, host[np.where(real, perm, 0)], 0).astype(host.dtype)
            return psearch.put_rows(self.mesh, permuted, permuted.shape[0])

        return self._memo(self._device, (key, column, "parted_scalar", key_column), stamp, build)

    # -- IVF: coders, indexes and the clustered layout ----------------------

    def coding(self, name: str) -> coder_mod.Coding:
        """The coder ``name``, memoized per artifact mtime."""
        stamp = os.path.getmtime(coder_mod.path_of(self.root, name))
        return self._memo(self._host, ("coding", name), stamp, lambda: coder_mod.load(self.root, name))

    def codebooks(self, name: str) -> torch.Tensor:
        """The coder ``name``'s ``[n, K, D]`` fp32 codebooks on the cache's
        device, memoized per artifact mtime as :meth:`coding` is: the
        device cell ranking reads them on every probed search."""
        stamp = os.path.getmtime(coder_mod.path_of(self.root, name))
        # keyed by no table, so a table's new revision keeps it
        return self._memo(
            self._device, ((), name, "codebooks"), stamp,
            lambda: torch.tensor(self.coding(name)["tensor"], device=self.device),
        )

    def _coded_paths(self, coding: str, key: tuple[str, ...], column: str) -> list[str]:
        return [index_mod.path_of(self.root, coding, s, column) for s in key]

    def _coded_stamp(self, coding: str, key: tuple[str, ...], column: str) -> tuple:
        """The table stamp plus the index files' mtimes: an index rebuilt
        over an unchanged table is a new revision of every entry derived
        from it."""
        return self._mtimes(key) + tuple(
            os.path.getmtime(p) for p in self._coded_paths(coding, key, column)
        )

    def _synced_index(self, coding: str, source: str, column: str) -> pa.Table:
        """The index table of one source, rebuilt when its row count
        differs from the table's (a reader inside a writer's
        table-then-index publish, or a crash between the two): the catalog
        lock waits out a writer in flight; a mismatch that persists is
        assigned again from the current table."""
        path = index_mod.path_of(self.root, coding, source, column)
        idx = arrow.load(path)
        if idx.num_rows == table.load(self.root, source).num_rows:
            return idx
        with catalog_lock(self.root):
            idx = arrow.load(path)
            rows = table.load(self.root, source).num_rows
            if idx.num_rows == rows:
                return idx  # the writer finished while we waited
            LOGGER.warning(
                "index %r over %r/%r has %d rows vs the table's %d; resyncing",
                coding, source, column, idx.num_rows, rows,
            )
            index_mod.make(self.root, coding, source, column, device=self.device)
            return arrow.load(path)

    def coded_table(self, coding: str, source: str | Sequence[str], column: str) -> pa.Table:
        """Host table with the ``__CODED_ID__`` column joined on, memoized
        on the table and index revisions."""
        key = _source_key(source)

        def build() -> pa.Table:
            return table.join(
                *[
                    table.join(table.load(self.root, s), self._synced_index(coding, s, column), axis=1)
                    for s in key
                ]
            )

        return self._memo(
            self._host, (key, column, "coded_table", coding), self._coded_stamp(coding, key, column), build
        )

    def _host_codes(self, coding: str, key: tuple[str, ...], column: str) -> np.ndarray:
        """Concatenated (resync-checked) cell ids of the sources."""
        parts = [
            ingest.scalar_column_to_numpy(self._synced_index(coding, s, column).column(index_mod.CODE_COL))
            for s in key
        ]
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    def _padded_codes(
        self, coding: str, key: tuple[str, ...], column: str, sharded: bool = False
    ) -> tuple[np.ndarray, int]:
        """``([N_pad] int32 cell ids, rows)``: −1 on the padding rows (which
        never match a probe cell), row-aligned with :meth:`matrix` (with
        ``sharded``, with :meth:`sharded_matrix`)."""
        codes = self._host_codes(coding, key, column)
        rows = codes.shape[0]
        if sharded:
            n_pad, _ = mesh_mod.shard_rows(rows, self.mesh, self.block)
        else:
            n_pad = max(ingest.round_up(rows, self.block), self.block)
        out = np.full(n_pad, -1, np.int32)
        out[:rows] = codes
        return out, rows

    def coded_ids(
        self, coding: str, source: str | Sequence[str], column: str, *, sharded: bool = False
    ) -> ingest.DeviceColumn:
        """Padded ``[N_pad]`` int32 cell-id column on the device (padding
        −1); with ``sharded=True`` row-sharded like :meth:`sharded_matrix`."""
        key = _source_key(source)

        def build() -> ingest.DeviceColumn:
            codes, rows = self._padded_codes(coding, key, column, sharded)
            if sharded:
                return ingest.DeviceColumn(data=psearch.put_rows(self.mesh, codes, codes.shape[0]), rows=rows)
            return ingest.DeviceColumn(data=torch.from_numpy(codes).to(self.device), rows=rows)

        return self._memo(
            self._device, (key, column, "coded", coding, sharded), self._coded_stamp(coding, key, column), build
        )

    def clustered_meta(self, coding: str, source: str | Sequence[str], column: str):
        """Host side of the IVF-clustered layout: ``(perm, offsets)``.
        ``perm`` maps sorted position → original row (a stable sort by
        cell id: within a cell ascending row id, padding rows last under
        an int-max key); ``offsets[c]`` is cell ``c``'s first sorted
        position (length ``n_cells + 1``). No device work, so the executor
        routes before any device layout is built."""
        key = _source_key(source)

        def build():
            codes, _ = self._padded_codes(coding, key, column)
            n_books, k_book, _ = self.coding(coding)["tensor"].shape
            keys = np.where(codes >= 0, codes, np.iinfo(np.int32).max)
            perm = np.argsort(keys, kind="stable")
            offsets = np.searchsorted(keys[perm], np.arange(int(k_book) ** int(n_books) + 1))
            return perm, offsets

        return self._memo(
            self._host, (key, column, "clustered_meta", coding), self._coded_stamp(coding, key, column), build
        )

    def clustered_perm(self, coding: str, source: str | Sequence[str], column: str) -> torch.Tensor:
        """Device int64 copy of the clustered layout's permutation (sorted
        position → original row): a device filter mask follows the rows
        into the sorted order without a host round trip."""
        key = _source_key(source)

        def build() -> torch.Tensor:
            perm, _ = self.clustered_meta(coding, source, column)
            return torch.from_numpy(perm).to(self.device)

        return self._memo(
            self._device, (key, column, "clustered_perm", coding), self._coded_stamp(coding, key, column), build
        )

    def clustered(self, coding: str, source: str | Sequence[str], column: str):
        """Device side of the IVF-clustered layout, rows sorted by cell id:
        ``(corpus_sorted, coded_sorted, orig_ids_sorted)`` DeviceColumns,
        the last the original row id per position (−1 padding). Built
        only when the router sends a request down the gather route; the
        permuted fp32 copy counts in ``device_bytes``."""
        key = _source_key(source)

        def build():
            self.clustered_builds += 1
            full = self.matrix(source, column)
            coded = self.coded_ids(coding, source, column)
            perm, _ = self.clustered_meta(coding, source, column)
            perm_dev = torch.from_numpy(perm).to(self.device)
            orig = np.where(perm < full.rows, perm, -1).astype(np.int32)
            return (
                ingest.DeviceColumn(data=full.data[perm_dev], rows=full.rows),
                ingest.DeviceColumn(data=coded.data[perm_dev], rows=full.rows),
                ingest.DeviceColumn(data=torch.from_numpy(orig).to(self.device), rows=full.rows),
            )

        return self._memo(
            self._device, (key, column, "clustered", coding), self._coded_stamp(coding, key, column), build
        )

    def clustered_aux(self, coding: str, source: str | Sequence[str], column: str, metric: str):
        """``(aux_mul, aux_add)`` in the clustered layout's sorted order
        (padding rows, sorted last, −inf)."""
        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)

        def build():
            corpus_sorted, _, _ = self.clustered(coding, source, column)
            valid = torch.arange(corpus_sorted.rows_padded, device=self.device) < corpus_sorted.rows
            return topk2.prepare_aux(corpus_sorted.data, valid, canonical)

        return self._memo(
            self._device,
            (key, column, "clustered_aux", coding, canonical),
            self._coded_stamp(coding, key, column),
            build,
        )

    # -- mesh-sharded entries (multi-device serving) -------------------------

    @property
    def mesh(self) -> "mesh_mod.Mesh | None":
        """The mesh this cache shards over, or None for one device. When
        set, the executor's top-k paths run ``parallel/search.py`` over the
        row-sharded entries below."""
        if isinstance(self._mesh, str):  # "auto"
            self._mesh = mesh_mod.serving_mesh() if self.device.type == "cuda" else None
        return self._mesh

    @property
    def _shard_block(self) -> int:
        # every shard holds a whole number of blocks
        return self.block * self.mesh.size

    def sharded_matrix(self, source: str | Sequence[str], column: str) -> ingest.DeviceColumn:
        """Row-sharded ``[N_pad, D]`` fp32 vector column over the mesh: rows
        split contiguously, so a shard-local index plus the shard's offset
        is the global row id (padding at the tail). A revision one recorded
        hop away refreshes as :meth:`matrix` does, counted alike: an append
        uploads only its rows (``_grow_sharded_matrix``; past the capacity
        the existing rows move between the shards' devices), a delete or
        compaction gathers the kept rows (``_shrink_matrix(sharded=True)``).
        Other revisions rebuild from the host (``to_sharded_matrix``)."""
        key = _source_key(source)
        stamp = self._mtimes(key)
        ckey = (key, column, "sharded_matrix")

        hit = self._device.get(ckey)
        if hit is not None and hit[0] == stamp:
            self._touch(ckey)
            return hit[1]

        with self._lock:
            hit = self._device.get(ckey)
            if hit is not None and hit[0] == stamp:
                return hit[1]
            if hit is not None and len(key) == 1:
                t = time.perf_counter()
                grown = self._grow_sharded_matrix(key[0], column, hit[0][0], hit[1], stamp[0])
                refreshed = grown
                if grown is None:
                    refreshed = self._shrink_matrix(key[0], column, hit[0][0], hit[1], stamp[0], sharded=True)
                METRICS.add("cache.refresh_seconds", time.perf_counter() - t)
                # a compaction in the gap can fold the parts and reuse their
                # names: a moved stamp rebuilds
                if refreshed is not None and self._mtimes(key) == stamp:
                    self._device[ckey] = (stamp, refreshed)
                    self._touch(ckey)
                    self._maybe_evict(ckey)
                    if grown is not None:
                        self.incremental_refreshes += 1
                    else:
                        self.lineage_refreshes += 1
                    return refreshed
                del grown, refreshed
            del hit
            self._device.pop(ckey, None)  # free the old revision first

            def build() -> ingest.DeviceColumn:
                data = table.load(self.root, key if len(key) > 1 else key[0])
                return psearch.to_sharded_matrix(types.typed_column(data, column), self.mesh, self.block)

            value, s1 = read_stable(lambda: self._mtimes(key), build, f"table {source!r}")
            self._device[ckey] = (s1, value)
            self._touch(ckey)
            self._maybe_evict(ckey)
            return value

    def _grow_sharded_matrix(
        self, source: str, column: str, old_stamp, old: ingest.DeviceColumn, new_stamp
    ) -> "ingest.DeviceColumn | None":
        """:meth:`_grow_matrix` of the row-sharded matrix: only the delta
        rows are uploaded; the capacity is a cold build's."""
        delta_names = table.append_delta(old_stamp, new_stamp)
        if not delta_names:
            return None
        try:
            parts = table.load_parts(self.root, source, delta_names)
            delta = ingest.vector_matrix(parts, column).astype(np.float32, copy=False)
        except (FileNotFoundError, KeyError, TypeError):
            return None  # a raced mutation or a schema change: rebuild
        new_rows = old.rows + delta.shape[0]
        cold_pad = max(mesh_mod.shard_rows(new_rows, self.mesh, self.block)[0], old.rows_padded)
        return ingest.DeviceColumn(
            data=_grown_sharded(old.data, np.ascontiguousarray(delta), old.rows, cold_pad, 0), rows=new_rows
        )

    def sharded_validity(self, source: str | Sequence[str], column: str) -> "psearch.Sharded":
        """Row-sharded bool ``[N_pad]``: the real (non-padding) rows,
        computed on the devices."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            col = self.sharded_matrix(source, column)
            per = col.data.rows_local
            return psearch.Sharded(self.mesh, [
                torch.arange(s * per, (s + 1) * per, device=dev) < col.rows
                for s, dev in enumerate(self.mesh.devices)
            ])

        return self._memo(self._device, (key, column, "sharded_validity"), stamp, build)

    def sharded_aux(self, source: str | Sequence[str], column: str, metric: str):
        """Row-sharded ``(aux_mul, aux_add)`` (padding rows −inf)."""
        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            col = self.sharded_matrix(source, column)
            return psearch.shard_aux(col.data, self.sharded_validity(source, column), canonical)

        return self._memo(self._device, (key, column, "sharded_aux", canonical), stamp, build)

    def sharded_clustered_meta(self, coding: str, source: str | Sequence[str], column: str):
        """Host side of the per-shard clustered IVF layout: each shard's
        contiguous rows are sorted by cell id on their own (a stable sort,
        padding last), so a probed cell is one contiguous local range per
        shard. ``(perm_local [N_pad] int32: the local row of each slot,
        offsets [S, n_cells + 1] int64: each shard's cell offsets,
        orig_global [N_pad] int32: each slot's global row id, −1
        padding)``."""
        key = _source_key(source)

        def build():
            codes, _ = self._padded_codes(coding, key, column, sharded=True)
            n_cells = self._n_cells(coding)
            n_shards = self.mesh.size
            n_pad = codes.shape[0]
            per = n_pad // n_shards
            intmax = np.iinfo(np.int64).max
            perm_local = np.empty(n_pad, np.int32)
            orig_global = np.empty(n_pad, np.int32)
            offsets = np.empty((n_shards, n_cells + 1), np.int64)
            for s in range(n_shards):
                sl = slice(s * per, (s + 1) * per)
                keys = np.where(codes[sl] >= 0, codes[sl].astype(np.int64), intmax)
                p = np.argsort(keys, kind="stable").astype(np.int32)
                perm_local[sl] = p
                sorted_keys = keys[p]
                offsets[s] = np.searchsorted(sorted_keys, np.arange(n_cells + 1))
                orig_global[sl] = np.where(sorted_keys != intmax, s * per + p, -1)
            return perm_local, offsets, orig_global

        return self._memo(
            self._host, (key, column, "sharded_clustered_meta", coding), self._coded_stamp(coding, key, column), build
        )

    def sharded_clustered_perm(self, coding: str, source: str | Sequence[str], column: str) -> "psearch.Sharded":
        """The per-shard clustered layout's local permutation, row-sharded
        on the devices (int64): a device filter mask follows the rows into
        each shard's sorted order."""
        key = _source_key(source)

        def build():
            perm_local, _, _ = self.sharded_clustered_meta(coding, source, column)
            return psearch.put_rows(self.mesh, perm_local.astype(np.int64), perm_local.shape[0])

        return self._memo(
            self._device, (key, column, "sharded_clustered_perm", coding), self._coded_stamp(coding, key, column), build
        )

    def sharded_clustered(self, coding: str, source: str | Sequence[str], column: str):
        """Device side of the per-shard clustered layout: ``(corpus_sorted,
        coded_sorted, orig_ids)`` row-sharded DeviceColumns, each shard's
        rows permuted on its own device (no host copy)."""
        key = _source_key(source)

        def build():
            self.clustered_builds += 1
            full = self.sharded_matrix(source, column)
            coded = self.coded_ids(coding, source, column, sharded=True)
            _, _, orig_global = self.sharded_clustered_meta(coding, source, column)
            perm = self.sharded_clustered_perm(coding, source, column)
            return (
                ingest.DeviceColumn(data=psearch.permute_rows_sharded(self.mesh, full.data, perm), rows=full.rows),
                ingest.DeviceColumn(data=psearch.permute_rows_sharded(self.mesh, coded.data, perm), rows=full.rows),
                ingest.DeviceColumn(data=psearch.put_rows(self.mesh, orig_global, orig_global.shape[0]), rows=full.rows),
            )

        return self._memo(
            self._device, (key, column, "sharded_clustered", coding), self._coded_stamp(coding, key, column), build
        )

    def sharded_clustered_aux(self, coding: str, source: str | Sequence[str], column: str, metric: str):
        """``(aux_mul, aux_add)`` in the per-shard sorted order (padding
        rows −inf)."""
        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)

        def build():
            corpus_sorted, _, orig = self.sharded_clustered(coding, source, column)
            return psearch.shard_aux(corpus_sorted.data, orig.data.map(lambda o: o >= 0), canonical)

        return self._memo(
            self._device,
            (key, column, "sharded_clustered_aux", coding, canonical),
            self._coded_stamp(coding, key, column),
            build,
        )

    def sharded_int8_solo(self, source: str | Sequence[str], column: str):
        """Row-sharded int8 device copy ``(v8 [N_pad, D], sv [N_pad])``
        uploaded from the host int8 mirror (:meth:`host_int8`) without any
        fp32 on the devices: the mesh-composed int8-resident mode, each
        device holding 1/S of the int8 copy. Padding rows are zero codes
        with scale 1e-30. Every revision uploads the refreshed mirror."""
        key = _source_key(source)
        stamp = self._mtimes(key)
        ckey = (key, column, "sharded_int8_solo")
        hit = self._device.get(ckey)
        if hit is not None and hit[0] == stamp:
            self._touch(ckey)
            return hit[1]
        del hit
        codes, scales = self.host_int8(source, column)  # built outside the cache lock

        def build():
            self._device.pop(ckey, None)  # free the old revision first
            t = time.perf_counter()
            rows = codes.shape[0]
            n_pad, _ = mesh_mod.shard_rows(rows, self.mesh, self.block)
            v8 = psearch.put_rows(self.mesh, codes, n_pad, 0, torch.int8)
            sv = psearch.put_rows(self.mesh, np.asarray(scales, np.float32), n_pad, 1e-30)
            METRICS.add("cache.int8_upload_seconds", time.perf_counter() - t)
            return ingest.DeviceColumn(data=v8, rows=rows), ingest.DeviceColumn(data=sv, rows=rows)

        return self._memo(self._device, ckey, stamp, build)

    def sharded_int8_solo_aux(self, source: str | Sequence[str], column: str, metric: str):
        """Row-sharded ``(aux_mul, aux_add)`` for the mesh-composed
        int8-resident scan, uploaded from the host aux; padding rows
        −inf."""
        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            mul, add = self.host_aux(source, column, canonical)
            return (
                psearch.to_sharded_vector(np.asarray(mul, np.float32), self.mesh, self.block, 1.0).data,
                psearch.to_sharded_vector(np.asarray(add, np.float32), self.mesh, self.block, distance_ops.NEG_INF).data,
            )

        return self._memo(self._device, (key, column, "sharded_int8_solo_aux", canonical), stamp, build)

    # -- IVF past the budget: cell-sorted host layouts ----------------------

    def _n_cells(self, coding: str) -> int:
        n_books, k_book, _ = self.coding(coding)["tensor"].shape
        return int(k_book) ** int(n_books)

    def host_cell_meta(self, coding: str, source: str | Sequence[str], column: str):
        """``(orig [N] int32, offsets [n_cells + 1] int64)`` of the
        cell-sorted host order: ``orig`` maps a sorted position to its row
        (one stable argsort of the cell ids, so rows keep table order
        within a cell), ``offsets[c]`` is cell ``c``'s first position. The
        probed host read and :meth:`host_clustered_int8` hang off it.
        Raises ``_StaleRevision`` when the table and the index span a
        mutation."""
        key = _source_key(source)

        def build():
            n_cells = self._n_cells(coding)
            rows = self.host_table(source).num_rows
            cell_ids = self._host_codes(coding, key, column) if rows else np.zeros(0, np.int64)
            if cell_ids.shape[0] != rows:
                raise _StaleRevision
            perm = np.argsort(cell_ids.astype(np.int64), kind="stable")
            offsets = np.searchsorted(cell_ids[perm], np.arange(n_cells + 1)).astype(np.int64)
            return perm.astype(np.int32), offsets

        return self._memo(
            self._host, (key, column, "host_cell_meta", coding), self._coded_stamp(coding, key, column), build
        )

    def host_clustered_int8(self, coding: str, source: str | Sequence[str], column: str):
        """Cell-sorted host int8 layout of the probed host search:
        ``(codes_sorted [N, D] int8, scales_sorted [N] f32, orig [N] int32,
        offsets [n_cells + 1] int64)``; each probed cell is one contiguous
        slice. Built from the int8 mirror by :meth:`host_cell_meta`'s
        order and persisted as a revision-stamped sidecar under
        ``<int8cache>/<sha1(column)[:16]>/ivf-<sha1(coding)[:16]>/``
        (``codes.npy``, ``scales.npy``, ``orig.npy``, ``offsets.npy``,
        ``meta.json`` written last), in the JAX package's format, so
        either package memory-maps the other's. Counters:
        ``cache.ivf_sidecar_loads`` / ``cache.ivf_sidecar_writes``."""
        key = _source_key(source)
        stamp = self._coded_stamp(coding, key, column)

        def build():
            n_cells = self._n_cells(coding)
            cdir = None
            if len(key) == 1:
                cdir = os.path.join(
                    self._int8_cdir(key, column), "ivf-" + hashlib.sha1(coding.encode()).hexdigest()[:16]
                )
            stamp_s = json.dumps(stamp)
            loaded = self._read_ivf_sidecar(cdir, stamp_s, column, n_cells)
            if loaded is not None:
                METRICS.add("cache.ivf_sidecar_loads")
                return loaded

            codes8, scales = self.host_int8(source, column)
            rows, d = codes8.shape
            orig, offsets = self.host_cell_meta(coding, source, column)
            if orig.shape[0] != rows:
                raise _StaleRevision
            perm = orig.astype(np.int64)
            scales_sorted = np.asarray(scales)[perm]
            step = max(1, (256 << 20) // max(d, 1))  # int8: 1 B an element

            def fill(dst) -> None:
                for s in range(0, rows, step):
                    dst[s : s + step] = codes8[perm[s : s + step]]

            if cdir is not None:
                meta_path = os.path.join(cdir, "meta.json")
                try:
                    os.makedirs(cdir, exist_ok=True)
                    _sweep_dead_tmp(cdir)
                    if os.path.exists(meta_path):
                        os.unlink(meta_path)  # invalidate before the data
                    tmp = os.path.join(cdir, f".tmp-{os.getpid()}-codes.npy")
                    dst = npf.open_memmap(tmp, mode="w+", dtype=np.int8, shape=(rows, d))
                    fill(dst)
                    dst.flush()
                    del dst
                    os.replace(tmp, os.path.join(cdir, "codes.npy"))
                    for arr, fname in ((scales_sorted, "scales.npy"), (orig, "orig.npy"), (offsets, "offsets.npy")):
                        tmp = os.path.join(cdir, f".tmp-{os.getpid()}-{fname}")
                        with open(tmp, "wb") as fh:
                            np.save(fh, arr)
                        os.replace(tmp, os.path.join(cdir, fname))
                    tmp = meta_path + f".tmp-{os.getpid()}"
                    with open(tmp, "w") as fh:
                        json.dump({"stamp": stamp_s, "column": column, "coding": coding, "rows": rows,
                                   "dim": d, "n_cells": n_cells}, fh)
                    os.replace(tmp, meta_path)
                    METRICS.add("cache.ivf_sidecar_writes")
                    codes_sorted = np.load(os.path.join(cdir, "codes.npy"), mmap_mode="r")
                    return codes_sorted, scales_sorted, orig, offsets
                except OSError:
                    shutil.rmtree(cdir, ignore_errors=True)  # serve from memory
            codes_sorted = np.empty((rows, d), np.int8)
            fill(codes_sorted)
            return codes_sorted, scales_sorted, orig, offsets

        return self._memo_unlocked(self._host, (key, column, "host_clustered_int8", coding), stamp, build)

    @staticmethod
    def _read_ivf_sidecar(cdir: "str | None", stamp_s: str, column: str, n_cells: int):
        """The IVF sidecar's four arrays when it holds revision ``stamp_s``
        whole, else None (absent, another revision, torn or corrupt)."""
        if cdir is None or not os.path.isdir(cdir):
            return None
        meta_path = os.path.join(cdir, "meta.json")
        try:
            with open(meta_path) as fh:
                meta = json.load(fh)
            if meta.get("stamp") != stamp_s or meta.get("column") != column:
                return None
            codes = np.load(os.path.join(cdir, "codes.npy"), mmap_mode="r")
            scales = np.load(os.path.join(cdir, "scales.npy"))
            orig = np.load(os.path.join(cdir, "orig.npy"))
            offsets = np.load(os.path.join(cdir, "offsets.npy"))
            with open(meta_path) as fh:
                if json.load(fh) != meta:
                    return None  # replaced by another process meanwhile
            if not (scales.shape[0] == codes.shape[0] == orig.shape[0] and offsets.shape[0] == n_cells + 1):
                return None
            return codes, scales, orig, offsets
        except (OSError, ValueError, EOFError):
            return None

    def host_clustered_aux(self, coding: str, source: str | Sequence[str], column: str, metric: str):
        """``(mul_s, add_s)`` [N] f32 in the cell-sorted host order: the
        row factors ``aux_mul · scale`` and ``aux_add`` of the probed
        host scan, permuted once per (revision, metric) so each probed
        cell reads them as contiguous slices."""
        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)

        def build():
            _, scales_sorted, orig, _ = self.host_clustered_int8(coding, source, column)
            hmul, hadd = self.host_aux(source, column, canonical)
            return (scales_sorted * hmul[orig]).astype(np.float32), hadd[orig].astype(np.float32)

        return self._memo(
            self._host,
            (key, column, "host_clustered_aux", coding, canonical),
            self._coded_stamp(coding, key, column),
            build,
        )

    def snapshot(
        self, source: str | Sequence[str], column: str, coding: str | None = None, sharded: "bool | None" = None
    ):
        """``(host table, device matrix, revision stamp)`` of ONE table
        revision, retried until stable. Fetching them separately could
        straddle a concurrent re-ingest and gather ids from a different
        table version than was scanned. With ``coding`` the host table
        carries the ``__CODED_ID__`` join and the index files' mtimes are
        part of the stamp. Executors re-check the stamp
        (:meth:`snapshot_stamp`) after fetching the other device entries
        (aux, scan copies, coded ids, clustered layouts), which memoize
        under their own stamps. ``sharded`` (default: whether a mesh is
        up) takes :meth:`sharded_matrix`."""
        if sharded is None:
            sharded = self.mesh is not None

        def read():
            data = (
                self.coded_table(coding, source, column) if coding is not None else self.host_table(source)
            )
            return data, self._base_matrix(source, column, sharded)

        with profiling.annotate("fenix.snapshot"):
            (data, matrix), stamp = read_stable(
                lambda: self.snapshot_stamp(source, column, coding), read, f"table {source!r}"
            )
        return data, matrix, stamp

    def snapshot_stamp(
        self, source: str | Sequence[str], column: str | None = None, coding: str | None = None
    ) -> tuple:
        """The revision token :meth:`snapshot` stabilizes under."""
        key = _source_key(source)
        if coding is None:
            return self._mtimes(key)
        return self._coded_stamp(coding, key, column)

    def invalidate(self) -> None:
        with self._lock:
            self._host.clear()
            self._device.clear()
            self._masks.clear()
