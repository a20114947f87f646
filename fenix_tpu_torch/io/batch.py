"""Random-batch iteration and the host→device prefetch pipeline — port
of ``fenix_tpu/io/batch.py``.

``RandomBatchIterator`` yields permuted fixed-size row blocks of a table
column, one epoch per pass (a fresh numpy permutation, the remainder
dropped): the JAX package's, so one seed yields the same blocks.

The streaming residency mode (``engine/residency.py``) moves a host
corpus through the card in fixed-shape chunks. An item is a tuple of
arrays, each a plain array or a :class:`Padded` one: the view of its
source rows (often a memory-mapped column) and the pad rows that bring
it to the item's fixed shape, which the stager writes. On a CUDA device
this is double-buffered the CUDA way:

- two pinned host staging buffers of the item's shape and two device
  buffers, allocated once per call (on the caller's stream) from the
  first item;
- a worker thread takes item ``i + 1`` and stages it (:func:`stage`):
  each array's source rows are copied once, straight into the first
  rows of its pinned buffer, and its pad rows are filled there, in row
  ranges of at least 32 MiB spread over the CPUs the process may run on
  (a small item, such as an index assignment block of 65,536 × 100 fp32
  rows, stays one copy on the worker). It then queues the
  upload on a side ``torch.cuda.Stream`` with
  ``copy_(..., non_blocking=True)``;
- a ``torch.cuda.Event`` per upload makes the compute stream wait for
  the copy, and makes the worker wait before it refills a pinned buffer
  whose copy is still in flight; a second event per slot, recorded on
  the compute stream when the consumer asks for the next item, makes
  the side stream wait before it overwrites a device buffer still being
  read.

So item ``i + 1`` is staged and uploaded while item ``i`` computes. The
tensors yielded for item ``i`` are reused for item ``i + 2``: a consumer
enqueues all its work on them before it asks for the next item.

A CPU device takes plain zero-copy tensors (dispatch by device type), a
padded array as the fresh array :func:`whole` stages. An exception
raised while producing an item propagates to the consumer.

Counters (``stats``): ``transfer.padded_items`` (items that came with
pad rows) and ``transfer.pad_rows`` (their pad rows, once an item), on
either device; on CUDA alone ``transfer.h2d_bytes`` and
``transfer.h2d_seconds`` (the uploads, timed with CUDA events on the
side stream), ``transfer.stage_seconds`` (the staging into the pinned
buffers) and ``transfer.wait_seconds`` (time the consumer waited on the
worker). Spans (``utils/profiling``, while a capture is active):
``transfer.stage`` on the worker thread (the staging) and
``transfer.wait`` where the consumer waits for an item.
"""

from __future__ import annotations

import collections
import concurrent.futures
import itertools
from typing import Iterable, Iterator, NamedTuple, Sequence

import numpy as np
import torch

from fenix_tpu_torch import native
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.ops.host_rescore import default_threads
from fenix_tpu_torch.utils import profiling
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

_DEPTH = 2  # items in flight: one computing, one staging/uploading
_STAGE_RANGE_BYTES = 32 << 20  # the least one staging thread copies


class RandomBatchIterator:
    """Permuted fixed-size batches over a table column: each pass is one
    epoch, a fresh full permutation with the remainder dropped, rows
    gathered by the native threaded gather."""

    def __init__(
        self,
        root: str,
        name: str | Sequence[str],
        size: int,
        column: str,
        seed: int | None = None,
    ) -> None:
        self.root = root
        self.name = name
        self.size = size
        self.column = column
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        data = table.load(self.root, self.name)
        matrix = ingest.vector_matrix(data, self.column)
        num_rows = matrix.shape[0]
        perm = self.rng.permutation(num_rows)
        perm = perm[: num_rows // self.size * self.size]
        for start in range(0, perm.size, self.size):
            yield native.gather_rows(matrix, perm[start : start + self.size])


class Padded(NamedTuple):
    """An item's array as its source ``rows`` followed by ``pad`` rows of
    ``fill``: the stager writes the pad where the rows land, so no
    padded copy of the rows is made first."""

    rows: np.ndarray
    pad: int
    fill: float

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.rows.shape[0] + self.pad, *self.rows.shape[1:])

    @property
    def dtype(self) -> np.dtype:
        return self.rows.dtype


def stage(dst: np.ndarray, src: "np.ndarray | Padded", threads: int) -> None:
    """Copy ``src`` into ``dst`` of its (padded) shape: the source rows
    into ``dst``'s first rows, the fill into the rest. ``dst``'s rows are
    split in ranges of at least ``_STAGE_RANGE_BYTES``, at most
    ``threads`` of them, each copied and filled on a thread of its own
    (``np.copyto`` and the fill release the interpreter lock)."""
    rows, pad, fill = (src.rows, src.pad, src.fill) if isinstance(src, Padded) else (src, 0, 0)
    n = rows.shape[0]
    if dst.shape != (n + pad, *rows.shape[1:]):
        raise ValueError(f"cannot stage {rows.shape} rows and {pad} pad rows into {dst.shape}")
    total = dst.shape[0]
    row_bytes = dst.itemsize * int(np.prod(dst.shape[1:]))
    parts = max(1, min(threads, total * row_bytes // _STAGE_RANGE_BYTES))
    bounds = [total * p // parts for p in range(parts + 1)]

    def run(lo: int, hi: int) -> None:
        mid = min(max(n, lo), hi)
        np.copyto(dst[lo:mid], rows[lo:mid])
        dst[mid:hi] = fill

    if parts == 1:
        run(0, total)
        return
    with concurrent.futures.ThreadPoolExecutor(parts - 1, thread_name_prefix="fenix-stage") as pool:
        futures = [pool.submit(run, lo, hi) for lo, hi in zip(bounds[1:-1], bounds[2:])]
        run(bounds[0], bounds[1])
        for f in futures:
            f.result()


def whole(a: "np.ndarray | Padded") -> np.ndarray:
    """``a`` as one array: a plain array as it is, a padded one staged
    into a fresh array (the route for consumers without a pinned slot)."""
    if not isinstance(a, Padded):
        return a
    if not a.pad:
        return a.rows
    out = np.empty(a.shape, a.dtype)
    stage(out, a, default_threads())
    return out


def _count_pad(arrays: tuple) -> None:
    pad = max((a.pad for a in arrays if isinstance(a, Padded)), default=0)
    if pad:
        METRICS.add("transfer.padded_items")
        METRICS.add("transfer.pad_rows", pad)


def prefetch_to_device(
    items: Iterable[tuple["np.ndarray | Padded", ...]], device: "str | torch.device"
) -> Iterator[tuple[torch.Tensor, ...]]:
    """Yield each item (a tuple of arrays, plain or :class:`Padded`, the
    same shapes and dtypes for every item) as a tuple of tensors on
    ``device``, in order."""
    device = torch.device(device)
    if device.type == "cpu":
        for arrays in items:
            _count_pad(arrays)
            yield tuple(ingest.host_tensor(whole(a)) for a in arrays)
        return
    if device.type != "cuda":
        raise ValueError(f"prefetch_to_device runs on cpu or cuda, got {device}")
    yield from _prefetch_cuda(iter(items), device)


class _Slot:
    """One staging buffer set: pinned host tensors, device tensors, the
    event of the last upload out of them, and the event that releases
    the device tensors after the consumer's work."""

    def __init__(self, first: tuple, device: torch.device) -> None:
        self.pinned = tuple(
            torch.empty(a.shape, dtype=ingest.host_tensor(np.empty(0, a.dtype)).dtype, pin_memory=True)
            for a in first
        )
        self.host = tuple(p.numpy() for p in self.pinned)
        self.dev = tuple(torch.empty(p.shape, dtype=p.dtype, device=device) for p in self.pinned)
        self.copied: "torch.cuda.Event | None" = None
        self.released = torch.cuda.Event()


def _prefetch_cuda(it: Iterator, device: torch.device) -> Iterator[tuple[torch.Tensor, ...]]:
    first = next(it, None)
    if first is None:
        return
    compute = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(compute):  # device buffers belong to the compute stream
        slots = [_Slot(first, device) for _ in range(_DEPTH)]
    it = itertools.chain([first], it)
    uploads: list = []  # (start event, end event, bytes) per item
    threads = default_threads()

    def produce(i: int) -> "int | None":
        arrays = next(it, None)
        if arrays is None:
            return None
        slot = slots[i % _DEPTH]
        if slot.copied is not None:
            slot.copied.synchronize()  # its last upload has left the pinned buffer
        with profiling.annotate("transfer.stage", counter="transfer.stage"):
            for dst, src in zip(slot.host, arrays, strict=True):
                stage(dst, src, threads)
        _count_pad(arrays)
        with torch.cuda.stream(side):
            side.wait_event(slot.released)  # the consumer is done with the device buffer
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(side)
            for dst, src in zip(slot.dev, slot.pinned):
                dst.copy_(src, non_blocking=True)
            end.record(side)
        slot.copied = end
        uploads.append((start, end, sum(p.numel() * p.element_size() for p in slot.pinned)))
        return i % _DEPTH

    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            queue = collections.deque(pool.submit(produce, i) for i in range(_DEPTH))
            i = 0
            while queue:
                with profiling.annotate("transfer.wait", counter="transfer.wait", wait=True):
                    s = queue.popleft().result()
                if s is None:
                    break
                slot = slots[s]
                compute.wait_event(slot.copied)
                yield slot.dev
                slot.released.record(compute)
                queue.append(pool.submit(produce, i + _DEPTH))
                i += 1
    finally:
        # an upload still queued (early exit, a failed item) must land
        # before its device buffer goes back to the allocator
        side.synchronize()

    METRICS.add("transfer.h2d_bytes", float(sum(b for _, _, b in uploads)))
    METRICS.add("transfer.h2d_seconds", sum(s.elapsed_time(e) for s, e, _ in uploads) / 1e3)
