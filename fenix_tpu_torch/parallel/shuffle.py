"""Distributed shuffle: hash-partitioned row exchange over a mesh — port of
``fenix_tpu/parallel/shuffle.py`` (BASELINE config 4: "hash-partitioned
tables, skew-handled shuffle").

Each source shard hashes its keys to a destination shard
(``ops/relational.hash_partition``), orders its rows by destination with
one stable sort, and packs them into fixed-capacity windows, one per
destination. The JAX package's ``all_to_all`` is the mesh's
(``Mesh.all_to_all``): window ``d`` of source ``s`` lands in slot ``s`` of
destination ``d``, so after the exchange each destination holds its S
source windows source-major, the JAX layout. In one process that is S × S
copies between the shards' devices; over several processes the windows
between local shards stay copies and the others cross in one message a
process pair. Rows past a window's fill
carry what the clipped gather index gives them (``valid`` marks the real
ones), so every output equals the JAX function's, not only the valid part.

Skew is handled by sampling (:func:`estimate_capacity`) and detected:
``overflow`` flags each (source, destination) window whose rows exceed the
capacity, so the caller can shuffle again with a larger one; no row is
dropped silently.

``chunks > 1`` splits each window into chunks. On distinct cards of one
process (``Mesh.concurrent``) every source enqueues from its own thread: chunk
``c`` is packed on the card's compute stream, its copies go out on a copy
stream per destination behind an event, and chunk ``c + 1`` is packed
while they are in flight; the destination's stream waits for its copies
by events, with no host sync. Otherwise (one device, the CPU, several
processes) the chunks run in turn, each one ``all_to_all``. Either way the
result is bitwise the ``chunks=1`` result.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from fenix_tpu_torch import native
from fenix_tpu_torch.ops import relational
from fenix_tpu_torch.parallel.mesh import Mesh
from fenix_tpu_torch.parallel.search import Sharded


def estimate_capacity(
    sample_keys: np.ndarray, num_partitions: int, rows_per_shard: int, safety: float = 1.5
) -> int:
    """Per-destination window capacity from a host-side key sample:
    ``rows_per_shard · max-partition-fraction · safety``, floored at the
    balanced share times ``safety`` and capped at ``rows_per_shard`` (the
    provable bound). The overflow flag catches the sampling error."""
    _, counts = native.hash_partition(sample_keys, num_partitions)
    frac = counts.max() / max(len(sample_keys), 1)
    balanced = rows_per_shard / num_partitions
    cap = int(np.ceil(max(frac * rows_per_shard * safety, balanced * safety)))
    return min(cap, rows_per_shard)


def _route(keys: torch.Tensor, n_shards: int, capacity: int):
    """One source's destination order: ``(perm, starts, sizes, overflow
    [S])`` — ``perm`` the stable sort of its rows by destination, each
    destination's run starting at ``starts`` with ``sizes`` rows."""
    parts = relational.hash_partition(keys, n_shards)
    sorted_parts, perm = torch.sort(parts, stable=True)
    dest = torch.arange(n_shards, dtype=parts.dtype, device=keys.device)
    starts = torch.searchsorted(sorted_parts, dest, side="left")
    sizes = torch.searchsorted(sorted_parts, dest, side="right") - starts
    return perm, starts, sizes, sizes > capacity


def _pack(rows: torch.Tensor, keys: torch.Tensor, route, c: int, chunk: int, capacity: int):
    """Chunk ``c`` of every destination window of one source: ``(rows
    [S, chunk, ...], keys [S, chunk], valid [S, chunk])``. The gather index
    is clipped to the source's last row, as the JAX package clips it."""
    perm, starts, sizes, _ = route
    n_shards, b = starts.shape[0], keys.shape[0]
    slot = c * chunk + torch.arange(chunk, device=keys.device)
    idx = (starts[:, None] + slot[None, :]).clamp(0, b - 1).reshape(-1)
    valid = slot[None, :] < sizes.clamp_max(capacity)[:, None]
    src = perm[idx]  # the sorted order composed with the window gather
    return (rows[src].view(n_shards, chunk, *rows.shape[1:]), keys[src].view(n_shards, chunk), valid)


def build_shuffle(mesh: Mesh, capacity: int, row_shape: Sequence[int], chunks: int = 1):
    """The exchange step: ``fn(rows, keys) -> (recv, recv_keys, valid,
    overflow)``, with ``rows`` a row-sharded :class:`Sharded` ``[N,
    *row_shape]`` and ``keys`` one ``[N]`` (integer). Every output is
    :class:`Sharded` (the local shards): shard ``d`` of ``recv`` is
    ``[S·capacity, *row_shape]``, its S source windows source-major,
    ``recv_keys`` and ``valid`` alike; shard ``s`` of ``overflow`` is
    ``[S]`` bool, one flag per destination of source ``s`` (``[S·S]``
    gathered)."""
    if chunks != 1 and capacity % chunks:
        raise ValueError(f"capacity {capacity} does not split into {chunks} chunks")
    n = mesh.size
    devices = mesh.devices
    chunk = capacity // chunks
    row_shape = tuple(row_shape)

    def exchange(rows: Sharded, keys: Sharded):
        def empty(shape, dtype) -> list:
            return [torch.empty(shape, dtype=dtype, device=dev) if mesh.is_local(d) else None
                    for d, dev in enumerate(devices)]

        outs = (empty((n, capacity, *row_shape), rows.dtype), empty((n, capacity), keys.dtype),
                empty((n, capacity), torch.bool))

        if mesh.concurrent and mesh.process_count == 1:
            def copy_out(s: int, d: int, c: int, sent) -> None:
                """Chunk ``c`` of source ``s``'s window for ``d`` into slot ``s`` of ``d``."""
                sl = slice(c * chunk, (c + 1) * chunk)
                for out, part in zip(outs, sent):
                    out[d][s, sl].copy_(part[d], non_blocking=True)

            overflow = _exchange_streams(mesh, rows, keys, capacity, chunks, chunk, copy_out)
        else:
            routes = [_route(keys.shards[s], n, capacity) if mesh.is_local(s) else None for s in range(n)]
            for c in range(chunks):
                sent = [None if r is None else _pack(rows.shards[s], keys.shards[s], r, c, chunk, capacity)
                        for s, r in enumerate(routes)]
                sl = slice(c * chunk, (c + 1) * chunk)
                for i, out in enumerate(outs):
                    mesh.all_to_all([None if p is None else p[i] for p in sent],
                                    [None if o is None else o[:, sl] for o in out])
            overflow = [None if r is None else r[3] for r in routes]
        recv, recv_keys, recv_valid = outs
        return (
            Sharded(mesh, [r if r is None else r.view(n * capacity, *row_shape) for r in recv]),
            Sharded(mesh, [k if k is None else k.view(n * capacity) for k in recv_keys]),
            Sharded(mesh, [v if v is None else v.view(n * capacity) for v in recv_valid]),
            Sharded(mesh, overflow),
        )

    return exchange


def _exchange_streams(mesh: Mesh, rows: Sharded, keys: Sharded, capacity: int, chunks: int, chunk: int,
                      copy_out) -> list:
    """The exchange on distinct cards, one thread per source card. Card
    ``s``'s compute stream (its thread's current one) routes and packs;
    each (source, destination) pair has its own copy stream on ``s``,
    ``copy[s][d]``, which takes a chunk's copies behind the event that its
    pack ended, and its own stream on ``d``, ``inbox[s][d]``, where torch's
    cross-device copy fences the destination (it orders a copy after the
    destination's current stream and that stream after the copy). So the
    S × S transfers run side by side, a pair's chunks in order, and no
    compute stream waits mid-exchange. Every stream starts behind the
    allocation of its destination's receive windows (``ready``); each
    card's compute stream waits for all of its pairs at the end."""
    devices = mesh.devices
    n = mesh.size
    copy = [[torch.cuda.Stream(devices[s]) for _ in range(n)] for s in range(n)]
    inbox = [[torch.cuda.Stream(devices[d]) for d in range(n)] for _ in range(n)]
    for d, dev in enumerate(devices):
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        for s in range(n):
            copy[s][d].wait_event(ready)
            inbox[s][d].wait_event(ready)

    def source(s: int):
        compute = torch.cuda.current_stream(devices[s])
        route = _route(keys.shards[s], n, capacity)
        for c in range(chunks):
            sent = _pack(rows.shards[s], keys.shards[s], route, c, chunk, capacity)
            packed = torch.cuda.Event()
            packed.record(compute)
            for d in range(n):
                copy[s][d].wait_event(packed)
                with contextlib.ExitStack() as fences:
                    fences.enter_context(torch.cuda.stream(copy[s][d]))
                    if d != s:
                        fences.enter_context(torch.cuda.stream(inbox[s][d]))
                    copy_out(s, d, c, sent)
                for t in sent:
                    t.record_stream(copy[s][d])  # freed only once its copies ran
        return route[3]

    overflow = mesh.map(source)
    for d, dev in enumerate(devices):
        compute = torch.cuda.current_stream(dev)
        for stream in [inbox[s][d] for s in range(n) if s != d] + [copy[d][d]]:
            done = torch.cuda.Event()
            done.record(stream)
            compute.wait_event(done)
    return overflow
