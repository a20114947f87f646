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
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

_SERVING_MESH: "Mesh | None | str" = "unset"


class Mesh:
    """A ``(data, model)`` grid of devices; ``devices`` is the flattened
    shard order."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]) -> None:
        self.grid = [[torch.device(d) for d in row] for row in grid]
        self.devices = [d for row in self.grid for d in row]
        self.size = len(self.devices)
        self.shape = {DATA_AXIS: len(self.grid), MODEL_AXIS: len(self.grid[0])}
        self._pool: "ThreadPoolExecutor | None" = None
        self._pool_lock = threading.Lock()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]})"

    @property
    def concurrent(self) -> bool:
        """Whether the shards sit on distinct CUDA devices, so that their
        work may be enqueued from one thread each."""
        return (
            self.size > 1
            and all(d.type == "cuda" for d in self.devices)
            and len({d.index for d in self.devices}) == self.size
        )

    def map(self, fn: Callable[[int], object]) -> list:
        """``[fn(s) for s in shards]``. On distinct cards each shard runs on
        its own thread with its card current: a host read in one shard's
        work (a selection's ``nonzero``) then waits for that card alone,
        and the other cards' work is already enqueued. On one device (or
        the CPU) the shards run in turn."""
        if not self.concurrent:
            return [fn(s) for s in range(self.size)]
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.size, thread_name_prefix="fenix-shard")

        def run(s: int):
            if self.devices[s].type != "cuda":
                return fn(s)
            with torch.cuda.device(self.devices[s]):
                return fn(s)

        return list(self._pool.map(run, range(self.size)))


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
