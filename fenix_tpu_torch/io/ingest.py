"""Arrow ⇄ device-tensor bridge — port of ``fenix_tpu/io/ingest.py``.

Arrow FixedSizeList columns are viewed as dense ``[rows, list_size]``
numpy arrays without copying on the host, then copied into a padded
device tensor (a block multiple of rows, with the valid row count kept
alongside so kernels can mask the tail). ``vector_type``,
``fixed_size_list_to_numpy``, ``numpy_to_fixed_size_list``,
``to_device_vector`` and ``round_up`` are the reference's.

Typed columns (``fenix_tpu_torch.types``) are first-class search inputs,
recognised by extension name in the registered and the unregistered form
(``types.logical_vector``): tensor columns and projected nested leaves
are read through their FixedSizeList storage; a quint8 column reads as
its dequantized fp32 values, ``(codes − shift) · scale`` in float32, and
reports ``list<float32>`` of its storage size. ``to_device_matrix``
dequantizes a quint8 column on the device after uploading its uint8
codes (a quarter of the fp32 bytes), with the same bits as the host
dequantization every host path reads.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import pyarrow as pa
import torch

from fenix_tpu_torch import types
from fenix_tpu_torch.types import quint8
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

_UPLOAD_ROWS = 1 << 18  # rows per host→device copy (bounds host-side casts)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def vector_type(field_type: pa.DataType) -> pa.FixedSizeListType:
    """The logical FixedSizeList type of a vector column's type, unwrapping
    extension types; a quint8 column reports float32 values (the engine
    searches its dequantized form, so ``__DISTANCE__`` is float)."""
    return _logical_type(types.logical_vector(field_type))


def vector_field_type(field: pa.Field) -> pa.FixedSizeListType:
    """:func:`vector_type` of a schema field, which also reads an extension
    column stored without its type registered (Arrow then shows the
    storage type and keeps the name in the field metadata)."""
    return _logical_type(types.logical_vector(field))


def _logical_type(lv: types.LogicalVector) -> pa.FixedSizeListType:
    storage = lv.storage
    assert pa.types.is_fixed_size_list(storage), storage
    if lv.kind == "quint8":
        return pa.list_(pa.float32(), storage.list_size)
    return storage


def vector_matrix(data: pa.Table, column: str) -> np.ndarray:
    """The logical ``[rows, D]`` matrix of ``data``'s vector ``column``,
    read through its schema field (``types.typed_column``)."""
    return fixed_size_list_to_numpy(types.typed_column(data, column))


def storage_view(array: pa.Array) -> np.ndarray:
    """Zero-copy ``[rows, list_size]`` view of a FixedSizeList array, or
    of an extension array's FixedSizeList storage (a quint8 column's raw
    codes)."""
    if isinstance(array, pa.ExtensionArray):
        array = array.storage
    assert pa.types.is_fixed_size_list(array.type), array.type
    size = array.type.list_size
    values = array.values
    # Respect any slicing offset on the parent array.
    values = values.slice(array.offset * size, len(array) * size)
    flat = values.to_numpy(zero_copy_only=True)
    return flat.reshape(-1, size)


def fixed_size_list_to_numpy(array: pa.Array | pa.ChunkedArray) -> np.ndarray:
    """Zero-copy view of a FixedSizeList array as ``[rows, list_size]``
    (a per-chunk copy into one matrix when the column has several
    chunks). Extension columns view their storage; a quint8 column
    dequantizes (a new fp32 matrix). Requires a null-free array."""
    if isinstance(array, pa.ChunkedArray):
        if array.num_chunks == 0:
            array = array.combine_chunks()
        elif array.num_chunks == 1:
            array = array.chunk(0)
        else:
            # combine_chunks would cap the flat values at 2^31 elements —
            # copy per chunk into a preallocated matrix instead
            views = [fixed_size_list_to_numpy(c) for c in array.chunks]
            out = np.empty(
                (sum(v.shape[0] for v in views), views[0].shape[1]),
                views[0].dtype,
            )
            off = 0
            for v in views:
                out[off : off + v.shape[0]] = v
                off += v.shape[0]
            return out
    affine = types.logical_vector(array).affine
    out = storage_view(array)
    return out if affine is None else quint8.dequantize_np(out, affine[0], affine[1])


def scalar_column_to_numpy(array: pa.Array | pa.ChunkedArray) -> np.ndarray:
    """Dense numpy view of a primitive column (zero-copy when possible)."""
    if isinstance(array, pa.ChunkedArray):
        array = array.combine_chunks()
    return array.to_numpy(zero_copy_only=array.null_count == 0)


class DeviceColumn(NamedTuple):
    """A device-resident dense column padded to a block multiple."""

    data: torch.Tensor  # [rows_padded, dim] or [rows_padded]
    rows: int  # valid rows (<= rows_padded)

    @property
    def rows_padded(self) -> int:
        return self.data.shape[0]


def host_tensor(array: np.ndarray) -> torch.Tensor:
    """Zero-copy CPU tensor over a numpy array. Arrow and memory-mapped
    buffers are read-only; the tensor is only read."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(array)


def upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """Copy the host array ``src`` into the device tensor ``dst`` of its
    shape; a CUDA destination counts the bytes in ``transfer.h2d_bytes``
    (the device cache's uploads: matrices, grow deltas, shrink indices,
    int8 copies, scalar columns)."""
    dst.copy_(host_tensor(src))
    if dst.device.type == "cuda":
        METRICS.add("transfer.h2d_bytes", float(dst.numel() * dst.element_size()))


def to_device_matrix(
    array: pa.Array | pa.ChunkedArray | np.ndarray,
    *,
    block: int = 1024,
    device: str | torch.device,
) -> DeviceColumn:
    """Pad a ``[N, D]`` host matrix to ``N_pad`` rows as f32 on ``device``.

    Allocates ``[N_pad, D]`` on the device, copies the rows in and zeroes
    the padding tail there — no padded host copy. An Arrow quint8 column
    uploads its uint8 codes, chunk by chunk from zero-copy views, and
    dequantizes them on the device (``quint8.dequantize_torch``)."""
    affine = None
    parts = [array]
    if not isinstance(array, np.ndarray):
        affine = types.logical_vector(array).affine
        if affine is None:
            parts = [fixed_size_list_to_numpy(array)]
        elif isinstance(array, pa.ChunkedArray) and array.num_chunks:
            parts = [storage_view(c) for c in array.chunks]
        else:
            parts = [storage_view(array.combine_chunks() if isinstance(array, pa.ChunkedArray) else array)]
    rows, dim = sum(p.shape[0] for p in parts), parts[0].shape[1]
    rows_padded = max(round_up(rows, block), block)
    data = torch.empty((rows_padded, dim), dtype=torch.float32, device=device)
    codes = None if affine is None else torch.empty((min(rows, _UPLOAD_ROWS), dim), dtype=torch.uint8, device=device)
    start = 0
    for part in parts:
        for offset in range(0, part.shape[0], _UPLOAD_ROWS):
            piece = part[offset : offset + _UPLOAD_ROWS]
            dst = data[start : start + piece.shape[0]]
            if codes is None:
                upload(dst, piece)
            else:
                upload(codes[: piece.shape[0]], piece)
                quint8.dequantize_torch(codes[: piece.shape[0]], affine[0], affine[1], out=dst)
            start += piece.shape[0]
    data[rows:].zero_()
    return DeviceColumn(data=data, rows=rows)


def to_device_vector(
    array: pa.Array | pa.ChunkedArray | np.ndarray,
    *,
    block: int = 1024,
    device: str | torch.device,
) -> DeviceColumn:
    """Pad a 1-D host column to a block multiple of rows on ``device``
    (the filter columns), zeros in the tail. A float64 column becomes
    float32, as the JAX package's arrays do with 64-bit types off."""
    if not isinstance(array, np.ndarray):
        array = scalar_column_to_numpy(array)
    rows = array.shape[0]
    rows_padded = max(round_up(rows, block), block)
    array = np.ascontiguousarray(array)
    dtype = torch.float32 if array.dtype == np.float64 else host_tensor(array).dtype
    data = torch.zeros((rows_padded,), dtype=dtype, device=device)
    upload(data[:rows], array)
    return DeviceColumn(data=data, rows=rows)


def numpy_to_fixed_size_list(matrix: np.ndarray, value_type: pa.DataType) -> pa.Array:
    """Dense ``[N, D]`` host matrix → Arrow FixedSizeList array."""
    n, d = matrix.shape
    flat = pa.array(matrix.reshape(-1), type=value_type)
    return pa.FixedSizeListArray.from_arrays(flat, list_size=d)
