"""The host rescore's scoring pass: exact fp32 scores of per-query
candidate windows over the host's fp32 column, in one threaded pass
(``csrc/host_rescore.cpp``).

:func:`window_scores` gives ``[Q, W]`` f32 ``dot(host[id], q) * mul[id] +
add[id]``, ``-inf`` where the id lies outside ``[0, rows)`` or the row is
masked off. Each candidate row is read once from the column, on as many
threads as the process may run on (``os.sched_getaffinity``), and sums in
one fixed order, so a (row, query) pair scores bit for bit alike whatever
the thread count or its slot. The ctypes call releases the interpreter
lock for the pass.

Build: ``g++ -O3 -march=native`` on the machine that runs it, the first
time a pass runs (never at import), into ``kernels.build_dir()`` under the
kernels' file lock. The library is named by a hash of its source, its
flags and the target ``-march=native`` resolves to, so a build directory
copied to another host builds anew. A failed build raises; no path falls
back to another way of scoring.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from fenix_tpu_torch.ops import kernels

_SOURCE = kernels._CSRC / "host_rescore.cpp"
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread")

_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host rescore builds its scoring pass with it")
    return found


def library_path() -> Path:
    """The library of this source, these flags and this host's target."""
    target = subprocess.run(
        [_gxx(), "-march=native", "-Q", "--help=target"], capture_output=True, text=True, check=True
    ).stdout
    digest = hashlib.sha256()
    for part in (_SOURCE.read_bytes(), " ".join(_FLAGS).encode(), target.encode()):
        digest.update(part)
    return kernels.build_dir() / f"libfenix_host_rescore-{digest.hexdigest()[:16]}.so"


def _compile(tmp: Path) -> None:
    done = subprocess.run([_gxx(), *_FLAGS, "-o", str(tmp), str(_SOURCE)], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"g++ {_SOURCE.name} failed ({done.returncode}):\n{done.stderr}")


def _library() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(kernels.locked_build(library_path(), _compile)))
            fn = lib.fenix_window_scores
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # host, rows, d
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # ids, q, w
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # queries, mul, add
                ctypes.c_void_p, ctypes.c_void_p,  # mask (or null), out
                ctypes.c_int64,  # threads
            ]
            _LIB = lib
        return _LIB


def default_threads() -> int:
    """The CPUs this process may run on."""
    return len(os.sched_getaffinity(0))


def window_scores(
    host: np.ndarray,  # [N, D] f32, C-contiguous
    ids: np.ndarray,  # [Q, W] candidate row ids (may be invalid)
    queries: np.ndarray,  # [Q, D] prepared queries
    aux_mul: np.ndarray,  # [N] f32
    aux_add: np.ndarray,  # [N] f32
    mask: "np.ndarray | None",  # [N] bool or None
    rows: int,
    threads: "int | None" = None,
) -> np.ndarray:  # [Q, W] f32
    """Scores of every window slot in one pass (see the module's
    docstring); ids outside ``[0, rows)`` and masked rows give ``-inf``."""
    if host.dtype != np.float32 or host.ndim != 2 or not host.flags.c_contiguous:
        raise ValueError(f"host must be a C-contiguous 2-D float32 array, got {host.dtype} {host.shape}")
    n, d = host.shape
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    aux_mul = np.ascontiguousarray(aux_mul, dtype=np.float32)
    aux_add = np.ascontiguousarray(aux_add, dtype=np.float32)
    if ids.ndim != 2 or queries.shape != (ids.shape[0], d):
        raise ValueError(f"ids {ids.shape} and queries {queries.shape} do not fit rows of width {d}")
    if not 0 <= rows <= n:
        raise ValueError(f"rows={rows} outside the host column's {n}")
    if aux_mul.shape[0] < rows or aux_add.shape[0] < rows:
        raise ValueError(f"aux {aux_mul.shape}/{aux_add.shape} shorter than rows={rows}")
    if mask is not None:
        mask = np.ascontiguousarray(mask, dtype=np.bool_)
        if mask.shape[0] < rows:
            raise ValueError(f"mask {mask.shape} shorter than rows={rows}")
    threads = default_threads() if threads is None else int(threads)
    if threads < 1:
        raise ValueError(f"threads must be at least 1, got {threads}")
    q, w = ids.shape
    out = np.empty((q, w), np.float32)
    err = _library().fenix_window_scores(
        host.ctypes.data, rows, d,
        ids.ctypes.data, q, w,
        queries.ctypes.data, aux_mul.ctypes.data, aux_add.ctypes.data,
        mask.ctypes.data if mask is not None else None, out.ctypes.data,
        threads,
    )
    if err != 0:
        raise RuntimeError("host rescore: a scoring thread could not be started")
    return out
