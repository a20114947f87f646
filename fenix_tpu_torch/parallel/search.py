"""Row-sharded kNN search with a candidate merge, and the dim-sharded
search — port of ``fenix_tpu/parallel/search.py``.

The corpus rows split contiguously over a mesh (``parallel/mesh.py``):
a :class:`Sharded` array holds one tensor per shard, each on its shard's
device. Every shard runs the single-device two-phase search
(``ops/topk2.py``, its phase 1 the hand-written kernels) over its own
rows, with the bf16 / int8 scan copies sharded alike; then only the
``[Q, k]`` (distance, global id) candidates of each shard cross to the
mesh's lead device, never rows. Where the JAX package has collectives
the port calls the mesh's (``parallel/mesh.py``: copies between devices
in one process, ``torch.distributed`` across processes):

- the ``all_gather`` merge (:func:`merge_candidates`): the shards'
  candidates gathered shard-major (``Mesh.gather``), then the top-k by
  (distance asc, id asc), so every process ends with the same result;
- the ring (:func:`build_ring_search`): the queries split into S blocks,
  block ``b`` starting on shard ``b``; in each of S steps every shard
  searches the block it holds, merges the result into the block's carry,
  and the block with its carry moves to the next shard (``Mesh.ppermute``).
  After S steps each block is home with its global top-k; over several
  processes each keeps the blocks of its own shards. The ring runs over
  the flattened ``(data, model)`` shard order, so ``model_parallel > 1``
  extends it.

Tie contract: shards own ascending contiguous id ranges and each shard's
candidates come (distance, id)-ordered, so the shard-major concatenation
lists tied candidates in id order. Both merges nevertheless sort by id
and then, stably, by distance (:func:`topk_dist_id`), so a tie resolves
to the smallest global id whatever order the candidates arrive in (the
ring merges its carry, from other shards, before the new candidates),
as the JAX package's ``topk_values_min_id`` does.

On distinct cards the shards' searches are enqueued from one thread per
card (``Mesh.map``), since a selection ends in a host read; the merges
and the ring's exchanges are small copies and ops on the lead device.

Over several processes (``parallel/distributed.initialize``) a
:class:`Sharded` holds the local shards only (None for the others), a
process uploads its own row range (:func:`put_rows` with ``start``), and
every shard-wise loop below runs the local shards.

:func:`gather_rowsharded` reads a row-sharded integer column at the
merged winners' global ids (the ``psum`` of the JAX package: each shard
takes the ids it owns, the parts are gathered and add in shard order);
the mesh joins (``engine/analytics.py``) read the winners' join keys so.

:func:`build_dim_sharded_search` splits the D contraction over the
model axis instead (:class:`DimSharded`): each shard's partial products
add on its data shard's first device (the ``psum``, inside one process:
a data row's shards must share their process), and the merge runs over
data shards only. No engine route reaches it; it trades speed for a
corpus whose full-D row shard would not fit one device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from fenix_tpu_torch.io import ingest
from fenix_tpu_torch.ops import topk2
from fenix_tpu_torch.ops.distance import NEG_INF, canonical_metric
from fenix_tpu_torch.parallel.mesh import Mesh, shard_rows

_PRECISIONS = ("fp32", "bf16", "int8")


def _col(parts: Sequence, i: int) -> list:
    """Item ``i`` of each shard's tuple, None where the shard has none."""
    return [None if p is None else p[i] for p in parts]


class Sharded:
    """A row-sharded device array: ``shards[s]`` holds the global rows
    ``[s·L, (s+1)·L)`` on ``mesh.devices[s]``, ``L = rows_local``; None
    for a shard of another process."""

    def __init__(self, mesh: Mesh, shards: Sequence["torch.Tensor | None"]) -> None:
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        self.mesh = mesh
        self.shards = list(shards)

    @property
    def _first(self) -> torch.Tensor:
        return self.shards[self.mesh.local_shards[0]]

    @property
    def rows_local(self) -> int:
        return self._first.shape[0]

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.rows_local * self.mesh.size, *self._first.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self._first.dtype

    def map(self, fn: Callable, *others: "Sharded") -> "Sharded":
        """``fn`` applied shard by shard (to this array's shard and the
        same shard of each of ``others``): row-wise work, enqueued in turn
        (none of it waits on the device)."""
        return Sharded(self.mesh, [None if x is None else fn(x, *(o.shards[s] for o in others))
                                   for s, x in enumerate(self.shards)])

    def gather(self, device: "torch.device | None" = None) -> torch.Tensor:
        """The whole array on ``device`` (default: the mesh's lead device),
        on every process."""
        whole = torch.cat(self.mesh.gather(self.shards))
        return whole if device is None else whole.to(device, non_blocking=True)


def put_rows(mesh: Mesh, parts: "np.ndarray | Sequence[np.ndarray]", n_pad: int, fill=0,
             dtype: "torch.dtype | None" = None, start: int = 0) -> Sharded:
    """Host rows (one array, or row blocks in order), global rows from
    ``start`` on, placed row-sharded as ``[n_pad, ...]``: each local
    shard's slice uploads to its device (``ingest.upload``, counted in
    ``transfer.h2d_bytes``), its rows outside the given ones are ``fill``.
    No padded host copy is made. Over several processes each process
    passes its own row range and its ``start`` (the counterpart of
    ``jax.make_array_from_process_local_data``), or every row."""
    if isinstance(parts, np.ndarray):
        parts = [parts]
    parts = [np.ascontiguousarray(p) for p in parts]
    if dtype is None:
        src = parts[0].dtype if parts else np.dtype(np.float32)
        dtype = torch.float32 if src == np.float64 else ingest.host_tensor(np.empty(0, src)).dtype
    inner = parts[0].shape[1:] if parts else ()
    per = n_pad // mesh.size
    shards = [torch.empty((per, *inner), dtype=dtype, device=dev) if mesh.is_local(s) else None
              for s, dev in enumerate(mesh.devices)]
    first = at = start
    for part in parts:
        stop = at + part.shape[0]
        for s in range(at // per, -(-stop // per)):
            lo, hi = max(at, s * per), min(stop, (s + 1) * per)
            if lo < hi and shards[s] is not None:
                ingest.upload(shards[s][lo - s * per : hi - s * per], part[lo - at : hi - at])
        at = stop
    for s in mesh.local_shards:
        shards[s][: min(max(first - s * per, 0), per)].fill_(fill)
        shards[s][min(max(at - s * per, 0), per) :].fill_(fill)
    return Sharded(mesh, shards)


def to_sharded_matrix(array, mesh: Mesh, block: int) -> ingest.DeviceColumn:
    """A vector column (Arrow, or a host ``[N, D]`` matrix) as a
    row-sharded f32 :class:`Sharded` ``[N_pad, D]`` (``shard_rows``
    padding, zero rows), each Arrow chunk read through its zero-copy view
    (a quint8 column dequantized on the host): the sharded
    ``ingest.to_device_matrix``."""
    if isinstance(array, np.ndarray):
        parts = [array]
    else:
        chunks = array.chunks if hasattr(array, "chunks") else [array]
        parts = [ingest.fixed_size_list_to_numpy(c) for c in chunks if len(c)]
    rows = sum(p.shape[0] for p in parts)
    n_pad, _ = shard_rows(rows, mesh, block)
    if not parts:
        width = array.type.list_size if not isinstance(array, np.ndarray) else array.shape[1]
        parts = [np.zeros((0, width), np.float32)]
    return ingest.DeviceColumn(data=put_rows(mesh, parts, n_pad, 0, torch.float32), rows=rows)


def to_sharded_vector(host: np.ndarray, mesh: Mesh, block: int, fill=0) -> ingest.DeviceColumn:
    """A 1-D host column row-sharded and padded like
    :func:`to_sharded_matrix` (``fill`` in the tail; float64 as
    float32)."""
    n_pad, _ = shard_rows(host.shape[0], mesh, block)
    return ingest.DeviceColumn(data=put_rows(mesh, host, n_pad, fill), rows=host.shape[0])


def replicate(mesh: Mesh, x: torch.Tensor) -> list:
    """``x`` on every local shard's device (one copy per distinct device),
    None for the shards of other processes."""
    copies: dict = {}
    return [copies.setdefault(dev, x.to(dev, non_blocking=True)) if mesh.is_local(s) else None
            for s, dev in enumerate(mesh.devices)]


def shard_corpus(mesh: Mesh, corpus: np.ndarray, mask: "np.ndarray | None" = None,
                 block: int = 8192) -> tuple[Sharded, Sharded]:
    """A host ``[N, D]`` matrix placed row-sharded, padded so that every
    shard holds a whole number of ``block``-row blocks, and its row
    validity (``mask`` on the real rows, False on the padding)."""
    n = corpus.shape[0]
    n_pad, _ = shard_rows(n, mesh, block)
    valid = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
    return put_rows(mesh, corpus, n_pad, 0), put_rows(mesh, valid, n_pad, False)


def shard_aux(corpus: Sharded, mask: "Sharded | None", metric: str) -> tuple[Sharded, Sharded]:
    """Row-sharded ``(aux_mul, aux_add)`` of the fused score
    (``topk2.prepare_aux`` shard by shard; masked rows −inf)."""
    pairs = [
        None if x is None else topk2.prepare_aux(x, None if mask is None else mask.shards[s], metric)
        for s, x in enumerate(corpus.shards)
    ]
    return Sharded(corpus.mesh, _col(pairs, 0)), Sharded(corpus.mesh, _col(pairs, 1))


def shard_scan_int8(corpus: Sharded) -> tuple[Sharded, Sharded]:
    """Row-sharded int8 scan copy ``(v8, sv)`` (per-row quantization)."""
    pairs = [None if x is None else topk2.quantize_corpus_int8(x) for x in corpus.shards]
    return Sharded(corpus.mesh, _col(pairs, 0)), Sharded(corpus.mesh, _col(pairs, 1))


def shard_scan_bf16(corpus: Sharded) -> Sharded:
    """Row-sharded bf16 scan copy."""
    return corpus.map(lambda x: x.to(torch.bfloat16))


def permute_rows_sharded(mesh: Mesh, x: Sharded, perm_local: Sharded) -> Sharded:
    """Shard-local row permutation ``out[s·L + i] = x[s·L + perm[s·L + i]]``
    (``perm_local`` holds local indices): a gather on each shard's
    device, no copy through the host."""
    return x.map(lambda a, p: a[p.long()], perm_local)


# -- the merges -------------------------------------------------------------


def topk_dist_id(dist: torch.Tensor, ids: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of ``[Q, W]`` candidates by (distance asc, id asc),
    whatever their order: a stable sort by id, then a stable sort by
    distance. Infinite distances and −1 ids are no candidate; the result
    is padded with (+inf, −1) to ``k`` columns."""
    dead = torch.isinf(dist) | (ids < 0)
    dist = dist.masked_fill(dead, torch.inf)
    ids = ids.masked_fill(dead, -1)
    big = torch.iinfo(ids.dtype).max
    by_id = torch.sort(ids.masked_fill(dead, big), dim=1, stable=True).indices
    dist, ids = dist.gather(1, by_id), ids.gather(1, by_id)
    order = torch.sort(dist, dim=1, stable=True).indices[:, :k]
    dist, ids = dist.gather(1, order), ids.gather(1, order)
    if dist.shape[1] < k:
        q, pad = dist.shape[0], k - dist.shape[1]
        dist = torch.cat([dist, dist.new_full((q, pad), torch.inf)], dim=1)
        ids = torch.cat([ids, ids.new_full((q, pad), -1)], dim=1)
    return dist, ids


def merge_candidates(mesh: Mesh, dists: Sequence["torch.Tensor | None"], gids: Sequence["torch.Tensor | None"],
                     k: int, shards: "Sequence[int] | None" = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The global top-``k`` ``(dist [Q, k], ids [Q, k])`` on the mesh's
    lead device, on every process, from the ``[Q, k_s]`` candidates of
    each of ``shards`` (default: every shard; each process gives its
    own), whose ids are already global: the ``all_gather`` of the JAX
    package, shard-major."""
    dist = torch.cat(mesh.gather(dists, shards), dim=1)
    ids = torch.cat([i.long() for i in mesh.gather(gids, shards)], dim=1)
    return topk_dist_id(dist, ids, k)


def gather_rowsharded(column: Sharded, gids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``column[gid]`` for global row ids ``gids`` (any shape, on the
    mesh's lead device) from a row-sharded 1-D integer or bool column:
    each shard reads the ids it owns (a contiguous range) on its device
    and contributes 0 elsewhere; the parts are gathered and add up in
    shard order on the lead device.
    Slots where ``valid`` is False read 0. Integer and bool columns only:
    0 is the missing-slot identity, and a float column's legitimate zeros
    would hide an ownership fault."""
    if column.dtype.is_floating_point or column.dtype.is_complex:
        raise TypeError(f"gather_rowsharded takes an integer column, got {column.dtype}")
    mesh, rows_local = column.mesh, column.rows_local
    flat_s = replicate(mesh, gids.reshape(-1))
    valid_s = replicate(mesh, valid.reshape(-1))

    def part(s: int) -> torch.Tensor:
        local = flat_s[s] - s * rows_local
        owned = valid_s[s] & (local >= 0) & (local < rows_local)
        taken = column.shards[s][local.clamp(0, rows_local - 1)]
        return torch.where(owned, taken, torch.zeros_like(taken))

    out = None
    for p in mesh.gather(mesh.map(part)):
        out = p if out is None else (out | p if p.dtype == torch.bool else out + p)
    return out.reshape(gids.shape)


def _to_global(ids: torch.Tensor, offset: int) -> torch.Tensor:
    return torch.where(ids >= 0, ids + offset, -1)


def _split_rest(rest: tuple, with_aux: bool, precision: str, probed: bool):
    """The optional arguments of a search step, in the JAX package's
    order: aux pair, scan copies, then ``(coded, cells)``."""
    aux = None
    if with_aux:
        aux, rest = (rest[0], rest[1]), rest[2:]
    scan = None
    if precision == "bf16":
        scan, rest = ("bf16", rest[0]), rest[1:]
    elif precision == "int8":
        scan, rest = ("int8", (rest[0], rest[1])), rest[2:]
    probe = (rest[0], rest[1]) if probed else None
    return aux, scan, probe


def _scan_kw(scan, s: int) -> dict:
    if scan is None:
        return {}
    if scan[0] == "bf16":
        return {"corpus_scan": scan[1].shards[s]}
    v8, sv = scan[1]
    return {"corpus_scan_int8": (v8.shards[s], sv.shards[s])}


def _local_topk(corpus: Sharded, s: int, queries: torch.Tensor, mul, add, k: int, metric: str,
                scan, coded: "Sharded | None", cells: "torch.Tensor | None"):
    """Shard ``s``'s top-``min(k, L)`` of ``queries`` (on its device),
    global ids."""
    local = corpus.shards[s]
    kk = min(k, local.shape[0])
    if coded is not None:
        d, i = topk2.topk_two_phase_probed(
            local, queries, mul, add, coded.shards[s], cells, k=kk, metric=metric, **_scan_kw(scan, s)
        )
    else:
        d, i = topk2.topk_two_phase(local, queries, mul, add, k=kk, metric=metric, **_scan_kw(scan, s))
    return d, _to_global(i, s * corpus.rows_local)


def _build(mesh: Mesh, k: int, metric: str, probed: bool, with_aux: bool = False, precision: str = "fp32"):
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")

    def local_search(corpus: Sharded, queries: torch.Tensor, mask: "Sharded | None", *rest):
        aux, scan, probe = _split_rest(rest, with_aux, precision, probed)
        if aux is None:  # inline aux: one extra pass over each shard per call
            aux = shard_aux(corpus, mask, metric)
        q_s = replicate(mesh, queries)
        c_s = replicate(mesh, probe[1]) if probe is not None else [None] * mesh.size

        def run(s: int):
            return _local_topk(corpus, s, q_s[s], aux[0].shards[s], aux[1].shards[s], k, metric, scan,
                               probe[0] if probe is not None else None, c_s[s])

        parts = mesh.map(run)
        return merge_candidates(mesh, _col(parts, 0), _col(parts, 1), k)

    return local_search


def build_sharded_search(mesh: Mesh, k: int, metric: str, block: "int | None" = None,
                         with_aux: bool = False, precision: str = "fp32"):
    """A sharded exact top-k step: ``fn(corpus, queries, mask[, aux_mul,
    aux_add][, scan copies]) -> (dist [Q, k], ids [Q, k])`` on the mesh's
    lead device, with ``corpus`` and ``mask`` :class:`Sharded` (from
    :func:`shard_corpus`) and ``queries`` a tensor. ``with_aux`` takes
    row-sharded aux (:func:`shard_aux`) instead of computing it per call;
    ``precision`` "bf16" appends a :func:`shard_scan_bf16` copy, "int8" a
    :func:`shard_scan_int8` pair. Each shard rescores against its fp32
    rows, so distances are fp32-exact. ``block`` is the JAX signature's,
    unused."""
    return _build(mesh, k, metric, probed=False, with_aux=with_aux, precision=precision)


def build_sharded_search_probed(mesh: Mesh, k: int, metric: str, block: "int | None" = None):
    """Sharded IVF search: ``fn(corpus, queries, mask, coded, cells) ->
    (dist, ids)`` with ``coded`` the row-sharded cell ids and ``cells``
    the ``[Q, P]`` probe cells; each shard scans only rows of its
    queries' probe cells."""
    return _build(mesh, k, metric, probed=True)


def build_serving_search(mesh: Mesh, k: int, metric: str, probed: bool = False, precision: str = "fp32"):
    """The sharded step as the engine dispatches it: ``fn(corpus, queries,
    aux_mul, aux_add[, scan copies][, coded, cells]) -> (dist, ids)``,
    the cached row-sharded aux carrying padding and filters."""
    raw = _build(mesh, k, metric, probed=probed, with_aux=True, precision=precision)

    def serving(corpus: Sharded, queries: torch.Tensor, *rest):
        return raw(corpus, queries, None, *rest)

    return serving


def build_serving_window_int8(mesh: Mesh, k: int, w: int, metric: str):
    """Sharded phase A of the int8-resident and int8-stream modes:
    ``fn(v8, sv, queries, aux_mul, aux_add) -> [S, Q, W']`` global row
    ids on the mesh's lead device, each shard's top-``W'`` window of its
    rows (``topk2.topk_window_int8`` at ``min(k, L)``, ``min(w, L)``).
    The host concatenates the windows shard-major and rescores them
    exactly; a window may hold masked or padding rows, which the host
    rescore drops."""

    def window(v8: Sharded, sv: Sharded, queries: torch.Tensor, mul: Sharded, add: Sharded) -> torch.Tensor:
        L = v8.rows_local
        q_s = replicate(mesh, queries)

        def run(s: int):
            ids = topk2.topk_window_int8(
                v8.shards[s], sv.shards[s], q_s[s], mul.shards[s], add.shards[s],
                k=min(k, L), w=min(w, L), metric=metric,
            )
            return _to_global(ids, s * L)

        return torch.stack(mesh.gather(mesh.map(run)))

    return window


def build_serving_ivf_clustered(mesh: Mesh, k: int, metric: str):
    """Sharded IVF over per-shard clustered layouts (each shard's rows
    sorted by cell id): ``fn(corpus_s, queries, aux_mul_s, aux_add_s,
    coded_s, orig_ids_s, cells, bucket_lists) -> (dist, ids)``, where
    ``bucket_lists`` is ``[S, Q, B]`` with shard ``s``'s buckets (in its
    local bucket space) in row ``s``. Every shard gathers only its own
    probed buckets; ``topk2.topk_ivf_clustered`` returns original global
    ids, which merge as they are."""

    def ivf(corpus_s: Sharded, queries, mul, add, coded_s: Sharded, orig: Sharded, cells, bucket_lists):
        kk = min(k, corpus_s.rows_local)
        q_s, c_s = replicate(mesh, queries), replicate(mesh, cells)

        def run(s: int):
            dev = mesh.devices[s]
            return topk2.topk_ivf_clustered(
                corpus_s.shards[s], q_s[s], mul.shards[s], add.shards[s], coded_s.shards[s],
                orig.shards[s], c_s[s], bucket_lists[s].to(dev, non_blocking=True), k=kk, metric=metric,
            )

        parts = mesh.map(run)
        return merge_candidates(mesh, _col(parts, 0), _col(parts, 1), k)

    return ivf


def build_ring_search(mesh: Mesh, k: int, metric: str, precision: str = "fp32", probed: bool = False):
    """The ring top-k: ``fn(corpus, queries, aux_mul, aux_add[, scan
    copies][, coded, cells]) -> (dist [Q, k], ids [Q, k])`` on the mesh's
    lead device, ``Q`` a multiple of the shard count (the executor pads
    it with zero queries). Block ``b`` of the queries (and, probed, of
    their probe cells) starts on shard ``b``; in step ``t`` shard ``s``
    holds block ``(s − t) mod S``, searches it over its own rows and
    merges the result into the block's ``[Q/S, k]`` carry
    (:func:`topk_dist_id`: ties to the smallest global id, whatever the
    arrival order), and the block with its carry moves to the next shard
    (``Mesh.ppermute``). The same answer as the ``all_gather`` merge. Over
    several processes the result holds the rows of the blocks that end on
    this process's shards, in block order (its contiguous share of the
    queries, from ``local_shards[0] · Q/S``)."""
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")
    n = mesh.size
    devices = mesh.devices
    local = mesh.local_shards

    def ring(corpus: Sharded, queries: torch.Tensor, aux_mul: Sharded, aux_add: Sharded, *rest):
        _, scan, probe = _split_rest(rest, False, precision, probed)
        q = queries.shape[0]
        if q % n:
            raise ValueError(f"the ring takes a multiple of {n} queries, got {q}")
        qb = q // n
        # what each shard holds, indexed by shard: a block, its cells, its carry
        held = [None] * n
        cells = [None] * n
        carry_d, carry_i = [None] * n, [None] * n
        for b in local:
            held[b] = queries[b * qb : (b + 1) * qb].to(devices[b], non_blocking=True)
            if probe is not None:
                cells[b] = probe[1][b * qb : (b + 1) * qb].to(devices[b], non_blocking=True)
            carry_d[b] = torch.full((qb, k), torch.inf, device=devices[b])
            carry_i[b] = torch.full((qb, k), -1, dtype=torch.int64, device=devices[b])
        for _ in range(n):
            def step(s: int):
                d, gid = _local_topk(corpus, s, held[s], aux_mul.shards[s], aux_add.shards[s], k, metric, scan,
                                     probe[0] if probe is not None else None, cells[s])
                return topk_dist_id(torch.cat([carry_d[s], d], dim=1), torch.cat([carry_i[s], gid], dim=1), k)

            merged = mesh.map(step)
            carry_d, carry_i = mesh.ppermute(_col(merged, 0)), mesh.ppermute(_col(merged, 1))
            held = mesh.ppermute(held)
            if probe is not None:
                cells = mesh.ppermute(cells)
        dev = mesh.lead
        return (torch.cat([carry_d[b].to(dev, non_blocking=True) for b in local]),
                torch.cat([carry_i[b].to(dev, non_blocking=True) for b in local]))

    return ring


class DimSharded:
    """``[N_pad, D]`` split rows over the data axis and columns over the
    model axis: ``shards[r·M + c]`` holds the ``rows_local`` rows of data
    shard ``r``, columns ``[c·D/M, (c+1)·D/M)``, on ``mesh.devices[r·M +
    c]``. Per-row vectors (mask, aux) are held per data shard on its first
    device, ``mesh.grid[r][0]`` (:meth:`data_rows`). Over several
    processes each data row's shards must lie in one process, which holds
    them; the others are None."""

    def __init__(self, mesh: Mesh, shards: Sequence["torch.Tensor | None"]) -> None:
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        m = len(mesh.grid[0])
        if any(mesh.owners[s] != mesh.owners[s - s % m] for s in range(mesh.size)):
            raise ValueError(f"a data row of the mesh spans processes: owners {mesh.owners}")
        self.mesh = mesh
        self.shards = list(shards)

    @property
    def _first(self) -> torch.Tensor:
        return self.shards[self.mesh.local_shards[0]]

    @property
    def rows_local(self) -> int:
        return self._first.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        m = len(self.mesh.grid[0])
        return (self.rows_local * len(self.mesh.grid), self._first.shape[1] * m)

    def data_rows(self, x: "np.ndarray | torch.Tensor") -> list:
        """A per-row ``[N_pad]`` vector split over the data shards, piece
        ``r`` on ``mesh.grid[r][0]`` (None for another process's row)."""
        x = torch.as_tensor(x)
        per, m = self.rows_local, len(self.mesh.grid[0])
        return [x[r * per : (r + 1) * per].to(row[0], non_blocking=True) if self.mesh.is_local(r * m) else None
                for r, row in enumerate(self.mesh.grid)]


def shard_corpus_dim(mesh: Mesh, corpus, mask=None, block: int = 256) -> tuple[DimSharded, list[torch.Tensor]]:
    """Place a host ``[N, D]`` matrix rows over the data axis and columns
    over the model axis, rows padded (zero) per data shard to a whole
    number of ``block``s; ``D`` must split evenly over the model axis.
    Returns the :class:`DimSharded` corpus and the row validity per data
    shard (``mask`` on the real rows, False on the padding)."""
    rows, m = len(mesh.grid), len(mesh.grid[0])
    n, d = corpus.shape
    assert d % m == 0, (d, mesh.shape)
    per = -(-n // rows)
    per = -(-per // block) * block
    width = d // m
    shards = []
    for r, row in enumerate(mesh.grid):
        if not mesh.is_local(r * m):
            shards.extend([None] * m)
            continue
        part = np.ascontiguousarray(corpus[r * per : (r + 1) * per])
        for c, dev in enumerate(row):
            x = torch.zeros((per, width), dtype=torch.float32, device=dev)
            if part.shape[0]:
                ingest.upload(x[: part.shape[0]], np.ascontiguousarray(part[:, c * width : (c + 1) * width]))
            shards.append(x)
    valid = np.zeros(per * rows, bool)
    valid[:n] = True if mask is None else np.asarray(mask, bool)
    placed = DimSharded(mesh, shards)
    return placed, placed.data_rows(torch.from_numpy(valid))


def build_dim_sharded_search(mesh: Mesh, k: int, metric: str):
    """Exact top-k with the D contraction sharded over the model axis:
    ``fn(corpus, queries_p, aux_mul, aux_add, q_sq) -> (dist [Q, k], ids
    [Q, k])`` on the mesh's lead device, on every process, the ring's
    form.

    ``corpus`` is a :class:`DimSharded` (:func:`shard_corpus_dim`);
    ``queries_p`` the ``[Q, D]`` prepared queries
    (``topk2.prepare_queries``: the full-D normalization happens before the
    column split); ``aux_mul`` / ``aux_add`` the per-row aux of the full-D
    rows (``topk2.prepare_aux``, computed before placement), one piece per
    data shard (``corpus.data_rows``); ``q_sq`` the ``[Q]`` squared norms
    of the raw queries.

    Per data shard ``r``: each shard ``(r, c)`` computes the partial
    product of its query columns and its rows in fp32 (TF32 is off), the M
    partials add on ``(r, 0)``'s device in ``c`` order (the ``psum``), then
    ``s·aux_mul + aux_add`` and the top ``min(k, rows_local)`` by (score
    desc, id asc), ids offset by ``r·rows_local``. The candidates merge over
    the data shards only (the model shards of a row hold the same rows), by
    (score desc, id asc), padded to ``k`` with (−inf, −1): over several
    processes the partial sums stay in a process (a data row's shards
    share one) and the merge gathers across them.

    Distances are the JAX function's conversion: l2 is ``sqrt(max(q_sq −
    s, 0))``, the expanded form, since no shard holds a whole row — not
    the engine's ``‖q − v‖``, so it cancels where the distance is small
    against ‖q‖; cosine ``0.5 − 0.5·s``; dot ``−s``."""
    metric_c = canonical_metric(metric)
    grid = mesh.grid

    def dim_search(corpus: DimSharded, queries_p: torch.Tensor, aux_mul: Sequence[torch.Tensor],
                   aux_add: Sequence[torch.Tensor], q_sq: torch.Tensor):
        m = len(grid[0])
        width = corpus.shape[1] // m
        rows_local = corpus.rows_local
        kk = min(k, rows_local)

        def partial(s: int) -> torch.Tensor:
            c = s % m
            v = corpus.shards[s]
            return queries_p[:, c * width : (c + 1) * width].to(v.device, torch.float32) @ v.T

        partials = mesh.map(partial)
        dists, gids = [None] * mesh.size, [None] * mesh.size  # each data row's at its first shard
        for r, row in enumerate(grid):
            if not mesh.is_local(r * m):
                continue
            dev = row[0]
            total = partials[r * m]
            for c in range(1, m):
                total = total + partials[r * m + c].to(dev, non_blocking=True)
            score = total * aux_mul[r][None, :] + aux_add[r][None, :]
            # iota ids: a stable descending sort puts tied scores in id order
            top_s, top_i = torch.sort(score, dim=1, descending=True, stable=True)
            top_s, top_i = top_s[:, :kk], top_i[:, :kk]
            dead = top_s == NEG_INF
            dists[r * m] = torch.where(dead, torch.inf, -top_s)
            gids[r * m] = torch.where(dead, -1, top_i + r * rows_local)
        # (−score asc, id asc)
        neg, ids = merge_candidates(mesh, dists, gids, k, shards=range(0, mesh.size, m))
        m_s = -neg
        dead = torch.isinf(neg)
        q_sq = q_sq.to(m_s.device, torch.float32)
        if metric_c == "l2":
            dist = torch.sqrt(torch.clamp_min(q_sq[:, None] - m_s, 0.0))
        elif metric_c == "cosine":
            dist = 0.5 - 0.5 * m_s
        else:
            dist = -m_s
        return torch.where(dead, torch.inf, dist), torch.where(dead, -1, ids)

    return dim_search
