"""ctypes bindings for the native host runtime (native/fenix_host.cpp).

Copied from ``fenix_tpu/native.py`` (it is JAX-free) and bound to the
same ``native/libfenix_host.so`` of the checkout; the one change is that
``row_score`` checks its contract with ``ValueError`` instead of
``assert`` (asserts vanish under ``python -O``).

Role parity: the reference leans on Arrow C++ take/filter and libtorch
DataLoader workers for its host hot loops (SURVEY.md §2.3); here they
are first-party C++ with a transparent numpy fallback, so the engine
works in environments where the .so has not been built.

Build: ``make -C native`` (g++ only; no external deps).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "native", "libfenix_host.so")

_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None:
        return _lib
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.fenix_pack_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32,
    ]
    lib.fenix_gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.fenix_hash_partition.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.fenix_partition_scatter.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ]
    for score_fn in ("fenix_row_score_f32", "fenix_row_score_int8"):
        getattr(lib, score_fn).argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ]
    lib.fenix_version.restype = ctypes.c_int32
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def pack_rows(src: np.ndarray, rows_pad: int, fill_byte: int = 0) -> np.ndarray:
    """[N, ...] contiguous array → [rows_pad, ...] padded copy.

    ``fill_byte`` is a byte pattern for the tail: 0 → zeros, 0xFF → −1
    for integer dtypes (the coded-id padding sentinel).
    """
    src = np.ascontiguousarray(src)
    rows = src.shape[0]
    assert rows_pad >= rows
    out = np.empty((rows_pad, *src.shape[1:]), dtype=src.dtype)
    lib = _load()
    if lib is None:
        out[:rows] = src
        out[rows:] = np.frombuffer(
            bytes([fill_byte & 0xFF]) * src.itemsize, dtype=src.dtype
        )[0]
        return out
    width = src.strides[0] if src.ndim > 1 else src.itemsize
    lib.fenix_pack_rows(
        src.ctypes.data, out.ctypes.data, rows, rows_pad, width, fill_byte & 0xFF
    )
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray, out: "np.ndarray | None" = None) -> np.ndarray:
    """Threaded ``src[idx]`` for row-major 2-D arrays, into ``out`` when
    given (C-contiguous, ``src``'s dtype, ``len(idx)`` rows)."""
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    shape = (idx.shape[0], *src.shape[1:])
    if out is None:
        out = np.empty(shape, dtype=src.dtype)
    elif out.shape != shape or out.dtype != src.dtype or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous {src.dtype} array of shape {shape}")
    lib = _load()
    if lib is None:
        return np.take(src, idx, axis=0, out=out)
    lib.fenix_gather_rows(
        src.ctypes.data, idx.ctypes.data, out.ctypes.data, idx.shape[0], src.strides[0]
    )
    return out


def row_score(
    rows: np.ndarray,
    pos: np.ndarray,
    query: np.ndarray,
    mul: np.ndarray,
    add: np.ndarray,
) -> np.ndarray:
    """Fused ``dot(rows[pos], query) * mul[pos] + add[pos]`` in one
    threaded pass — the residency host paths' scoring primitive.

    ``rows`` is ``[N, D]`` float32 or int8 and is NEVER copied or
    materialized as fp32 (it is typically a multi-GB mmap'd mirror;
    the gather-then-BLAS form this replaces paid 3-4× the memory
    traffic, and for int8 an fp32 materialize of the whole probed
    set). Accumulation is scalar-ordered f32 — within the engine's
    documented 1e-5 distance tolerance of the matmul paths."""
    if rows.ndim != 2 or not rows.flags["C_CONTIGUOUS"]:
        raise ValueError("row_score takes a C-contiguous [N, D] matrix")
    if rows.dtype not in (np.float32, np.int8):
        raise ValueError(f"row_score takes float32 or int8 rows, got {rows.dtype}")
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    query = np.ascontiguousarray(query, dtype=np.float32)
    mul = np.ascontiguousarray(mul, dtype=np.float32)
    add = np.ascontiguousarray(add, dtype=np.float32)
    lib = _load()
    if lib is None:
        sub = rows[pos].astype(np.float32, copy=False)
        return (sub @ query) * mul[pos] + add[pos]
    out = np.empty(pos.shape[0], np.float32)
    fn = (
        lib.fenix_row_score_f32
        if rows.dtype == np.float32
        else lib.fenix_row_score_int8
    )
    fn(
        rows.ctypes.data, pos.ctypes.data, query.ctypes.data,
        mul.ctypes.data, add.ctypes.data, out.ctypes.data,
        pos.shape[0], rows.shape[1],
    )
    return out


def hash_partition(keys: np.ndarray, num_partitions: int) -> tuple[np.ndarray, np.ndarray]:
    """(partition id per key, per-partition counts). Hash matches
    fenix_tpu.ops.relational.hash_partition exactly."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _load()
    if lib is None:
        x = keys.astype(np.uint32)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
        parts = (x % np.uint32(num_partitions)).astype(np.int32)
        return parts, np.bincount(parts, minlength=num_partitions).astype(np.int64)
    parts = np.empty(keys.shape[0], dtype=np.int32)
    counts = np.zeros(num_partitions, dtype=np.int64)
    lib.fenix_hash_partition(
        keys.ctypes.data, parts.ctypes.data, keys.shape[0], num_partitions,
        counts.ctypes.data,
    )
    return parts, counts


def partition_scatter(
    src: np.ndarray, parts: np.ndarray, counts: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Stable scatter of rows into partition-contiguous order.

    Returns (scattered rows, offsets[num_partitions+1]); partition p's
    rows are ``out[offsets[p]:offsets[p+1]]`` in original relative order
    — the host half of the distributed shuffle.
    """
    src = np.ascontiguousarray(src)
    parts = np.ascontiguousarray(parts, dtype=np.int32)
    offsets = np.zeros(counts.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    lib = _load()
    if lib is None:
        order = np.argsort(parts, kind="stable")
        return src[order], offsets
    out = np.empty_like(src)
    lib.fenix_partition_scatter(
        src.ctypes.data, parts.ctypes.data, offsets.ctypes.data, out.ctypes.data,
        src.shape[0], src.strides[0] if src.ndim > 1 else src.itemsize,
        counts.shape[0],
    )
    return out, offsets
