"""Device meshes: the serving mesh and the row split — port of
``fenix_tpu/parallel/mesh.py``.

A mesh is a ``(data, model)`` grid of ``torch.device``s inside one
process. Corpus rows split into contiguous ranges over the flattened
grid (row-major, the JAX package's ``row_sharding`` over both axes):
shard ``s`` holds global rows ``[s·L, (s+1)·L)`` on ``devices[s]``, so a
shard-local row index plus ``s·L`` is the global row id. The JAX
package's collectives become copies between the shards' devices
(``parallel/search.py``).

``serving_mesh()`` is the process-wide mesh the query engine shards
corpora over: ``FENIX_MESH=auto`` (the default) takes every visible card
when there is more than one, ``off`` forces one device, ``<n>`` the first
n cards. It counts ``torch.cuda.device_count()``, takes distinct cards
only (never the CPU) and resolves once per process.

``make_mesh(devices=...)`` also takes a list that repeats a device: the
counterpart of the forced host device count the JAX tests run under. The
CPU tests build S shards on ``cpu``, and ``chip_smoke.py`` four shards on
one card; ``serving_mesh()`` never builds such a mesh.

A mesh may span processes (``parallel/distributed.initialize``): the
shards are every process's local devices in process order, each process
holds only its own (``local_shards``, contiguous), and the collectives
below cross the boundary on ``torch.distributed``. Every mesh route
calls them; in one process they are the copies between devices:

- :meth:`Mesh.gather`: per-shard tensors to every process, in global
  shard order, on the process's lead device (the ``all_gather``);
- :meth:`Mesh.ppermute`: each shard's block to the next shard (the
  ring's ``ppermute``);
- :meth:`Mesh.all_to_all`: per-pair windows (the shuffle's
  ``all_to_all``).

Across processes a collective runs on one lead device a process, its
first local device: with NCCL (each shard of the world on its own card)
the local shards' tensors copy to the lead card first; with gloo they
stage through host memory, pinned when they come from a card. Every
process must call the same collectives in the same order.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_SERVING_MESH: "Mesh | None | str" = "unset"


class Mesh:
    """A ``(data, model)`` grid of devices; ``devices`` is the flattened
    shard order. Over several processes ``owners[s]`` is the process that
    holds shard ``s`` and ``devices[s]`` its device as that process names
    it; ``backend`` is the ``torch.distributed`` backend ("nccl" or
    "gloo"), None in one process."""

    def __init__(self, grid: Sequence[Sequence[torch.device]], owners: "Sequence[int] | None" = None,
                 process_index: int = 0, backend: "str | None" = None) -> None:
        self.grid = [[torch.device(d) for d in row] for row in grid]
        self.devices = [d for row in self.grid for d in row]
        self.size = len(self.devices)
        self.shape = {DATA_AXIS: len(self.grid), MODEL_AXIS: len(self.grid[0])}
        self.owners = list(owners) if owners is not None else [0] * self.size
        self.process_index = process_index
        self.process_count = max(self.owners) + 1
        self.local_shards = [s for s, p in enumerate(self.owners) if p == process_index]
        self.lead = self.devices[self.local_shards[0]]  # where merged results land
        self.backend = backend
        self._pool: "ThreadPoolExecutor | None" = None
        self._pool_lock = threading.Lock()

    def __repr__(self) -> str:
        spans = f", process {self.process_index} of {self.process_count}" if self.process_count > 1 else ""
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]}{spans})"

    def is_local(self, s: int) -> bool:
        return self.owners[s] == self.process_index

    def reshape(self, model_parallel: int) -> "Mesh":
        """The same shards (devices, processes, backend) as a ``(S /
        model_parallel, model_parallel)`` grid."""
        grid = make_mesh(devices=self.devices, model_parallel=model_parallel).grid
        return Mesh(grid, owners=self.owners, process_index=self.process_index, backend=self.backend)

    @property
    def concurrent(self) -> bool:
        """Whether the local shards sit on distinct CUDA devices, so that
        their work may be enqueued from one thread each."""
        local = [self.devices[s] for s in self.local_shards]
        return (
            len(local) > 1
            and all(d.type == "cuda" for d in local)
            and len({d.index for d in local}) == len(local)
        )

    def map(self, fn: Callable[[int], object]) -> list:
        """``[fn(s) for s in shards]``, None for the shards of other
        processes. On distinct cards each shard runs on its own thread
        with its card current: a host read in one shard's work (a
        selection's ``nonzero``) then waits for that card alone, and the
        other cards' work is already enqueued. On one device (or the CPU)
        the shards run in turn."""
        if not self.concurrent:
            return [fn(s) if self.is_local(s) else None for s in range(self.size)]
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=len(self.local_shards), thread_name_prefix="fenix-shard")

        def run(s: int):
            if self.devices[s].type != "cuda":
                return fn(s)
            with torch.cuda.device(self.devices[s]):
                return fn(s)

        out: list = [None] * self.size
        for s, r in zip(self.local_shards, self._pool.map(run, self.local_shards)):
            out[s] = r
        return out

    # -- collectives ----------------------------------------------------------

    @property
    def _wire(self) -> torch.device:
        """Where a cross-process message lives: the lead card for NCCL,
        host memory for gloo."""
        return self.lead if self.backend == "nccl" else torch.device("cpu")

    def _owned(self, p: int, shards: Sequence[int]) -> list[int]:
        return [s for s in shards if self.owners[s] == p]

    def gather(self, parts: Sequence["torch.Tensor | None"], shards: "Sequence[int] | None" = None) -> list:
        """``parts[s]`` for each ``s`` of ``shards`` (default: every shard),
        in that order, on the lead device: the ``all_gather``. Each process
        gives the parts of its own shards; all have one shape and dtype, and
        every process owns as many of ``shards``."""
        shards = range(self.size) if shards is None else list(shards)
        if self.process_count == 1:
            return [parts[s].to(self.lead, non_blocking=True) for s in shards]
        mine = self._owned(self.process_index, shards)
        if any(len(self._owned(p, shards)) != len(mine) for p in range(self.process_count)):
            raise ValueError(f"every process must own as many of the gathered shards {list(shards)}")
        like = parts[mine[0]]
        buf = _pack(self._wire, [parts[s] for s in mine])
        bufs = [torch.empty_like(buf) for _ in range(self.process_count)]
        dist.all_gather(bufs, buf)
        got = {}
        for p in range(self.process_count):
            if p != self.process_index:
                owned = self._owned(p, shards)
                got.update(zip(owned, _unpack(bufs[p], [like] * len(owned), [self.lead] * len(owned))))
        return [parts[s].to(self.lead, non_blocking=True) if self.is_local(s) else got[s] for s in shards]

    def ppermute(self, blocks: Sequence["torch.Tensor | None"]) -> list:
        """Shard ``s``'s block moved to shard ``s + 1`` (mod S), on that
        shard's device: ``out[(s + 1) % S] = blocks[s]``, None for the
        shards of other processes. Every block has one shape and dtype."""
        n = self.size
        out: list = [None] * n
        sends, recvs = [], []
        for s in self.local_shards:
            d = (s + 1) % n
            if self.is_local(d):
                out[d] = blocks[s].to(self.devices[d], non_blocking=True)
            else:
                sends.append((self.owners[d], d, _pack(self._wire, [blocks[s]])))
            if not self.is_local((s - 1) % n):  # its block comes from another process
                recvs.append((self.owners[(s - 1) % n], s, _pack(self._wire, [blocks[s]], fill=False)))
        self._exchange(sends, recvs)
        for _, d, buf in recvs:
            out[d] = _unpack(buf, [blocks[d]], [self.devices[d]])[0]
        return out

    def all_to_all(self, parts: Sequence["torch.Tensor | None"], out: Sequence["torch.Tensor | None"]) -> None:
        """The ``all_to_all``: ``out[d][s] = parts[s][d]`` for every shard
        ``s`` and each local shard ``d``, written into the given ``out[d]``
        (``[S, ...]`` views on ``d``'s device; ``parts[s]`` ``[S, ...]`` on
        ``s``'s). Windows between local shards are copies, the others cross
        in one message a process pair."""
        local = self.local_shards
        for d in local:
            for s in local:
                out[d][s].copy_(parts[s][d], non_blocking=True)
        if self.process_count == 1:
            return
        like = parts[local[0]][0]
        sends, recvs = [], []
        for p in range(self.process_count):
            if p == self.process_index:
                continue
            theirs = self._owned(p, range(self.size))
            sends.append((p, 0, _pack(self._wire, [parts[s][d] for s in local for d in theirs])))
            recvs.append((p, 0, _pack(self._wire, [like] * (len(theirs) * len(local)), fill=False)))
        self._exchange(sends, recvs)
        for p, _, buf in recvs:
            theirs = self._owned(p, range(self.size))
            pairs = [(s, d) for s in theirs for d in local]
            for (s, d), x in zip(pairs, _unpack(buf, [like] * len(pairs), [self.devices[d] for _, d in pairs])):
                out[d][s].copy_(x, non_blocking=True)

    def _exchange(self, sends: list, recvs: list) -> None:
        """Point-to-point messages ``(process, tag, buffer)``, all posted
        at once and waited for."""
        ops = [dist.P2POp(dist.isend, buf, p, tag=tag) for p, tag, buf in sends]
        ops += [dist.P2POp(dist.irecv, buf, p, tag=tag) for p, tag, buf in recvs]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()


_ALIGN = 16  # byte alignment of each tensor inside a message


def _pack(wire: torch.device, xs: Sequence[torch.Tensor], fill: bool = True) -> torch.Tensor:
    """``xs`` as one byte buffer on ``wire`` (each tensor at a 16-byte
    aligned offset); host buffers are pinned when a card is involved, and
    filled by synchronous copies, so the message is complete when it is
    sent. ``fill=False`` returns an empty buffer of that size (a receive)."""
    sizes = [x.numel() * x.element_size() for x in xs]
    total = sum(-(-n // _ALIGN) * _ALIGN for n in sizes)
    pin = wire.type == "cpu" and torch.cuda.is_available() and any(x.is_cuda for x in xs)
    buf = torch.empty(total, dtype=torch.uint8, device=wire, pin_memory=pin)
    if fill:
        o = 0
        for x, n in zip(xs, sizes):
            buf[o : o + n].copy_(x.contiguous().reshape(-1).view(torch.uint8))
            o += -(-n // _ALIGN) * _ALIGN
    return buf


def _unpack(buf: torch.Tensor, likes: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> list:
    """The tensors of a :func:`_pack` buffer, shaped and typed as
    ``likes``, each on its device."""
    out, o = [], 0
    for like, dev in zip(likes, devices):
        n = like.numel() * like.element_size()
        seg = buf[o : o + n]
        seg = seg.clone() if seg.device == torch.device(dev) else seg.to(dev, non_blocking=True)
        out.append(seg.view(like.dtype).view(like.shape))
        o += -(-n // _ALIGN) * _ALIGN
    return out


def make_mesh(
    n_devices: "int | None" = None,
    model_parallel: int = 1,
    devices: "Sequence[str | torch.device] | None" = None,
) -> Mesh:
    """A ``(n / model_parallel, model_parallel)`` mesh over ``devices``
    (default: the first ``n_devices`` cards, all of them when None)."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n < 1 or n > count:
            raise ValueError(f"need {n} CUDA devices; {count} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if not devs or len(devs) % model_parallel:
        raise ValueError(f"{len(devs)} devices do not split into model_parallel={model_parallel}")
    rows = len(devs) // model_parallel
    return Mesh([devs[r * model_parallel : (r + 1) * model_parallel] for r in range(rows)])


def serving_mesh() -> "Mesh | None":
    """The process-wide serving mesh, or None for single-device serving
    (see the module docstring)."""
    global _SERVING_MESH
    if _SERVING_MESH != "unset":
        return _SERVING_MESH  # type: ignore[return-value]
    env = os.environ.get("FENIX_MESH", "auto").lower()
    if env in ("off", "0", "1", "single", "none"):
        _SERVING_MESH = None
        return None
    count = torch.cuda.device_count()
    n = count if env == "auto" else max(1, min(int(env), count))
    _SERVING_MESH = make_mesh(n) if n > 1 else None
    return _SERVING_MESH


def shard_rows(n_rows: int, mesh: Mesh, block: int) -> tuple[int, int]:
    """``(n_pad, rows per shard)``: ``n_rows`` padded so that every shard
    holds a whole, nonzero number of ``block``-row blocks."""
    step = block * mesh.size
    n_pad = max(-(-n_rows // step) * step, step)
    return n_pad, n_pad // mesh.size
