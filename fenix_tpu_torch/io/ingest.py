"""Arrow ⇄ device-tensor bridge — port of ``fenix_tpu/io/ingest.py``.

Arrow FixedSizeList columns are viewed as dense ``[rows, list_size]``
numpy arrays without copying on the host, then copied into a padded
device tensor (a block multiple of rows, with the valid row count kept
alongside so kernels can mask the tail). ``vector_type``,
``fixed_size_list_to_numpy``, ``numpy_to_fixed_size_list``,
``to_device_vector`` and ``round_up`` are the reference's, minus the extension types
(``fenix_tpu/types``), which are not ported yet and raise.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import pyarrow as pa
import torch

from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

_EXTENSION_TODO = "extension-typed vector columns (ROADMAP queue 1: port types/)"
_UPLOAD_ROWS = 1 << 18  # rows per host→device copy (bounds host-side casts)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def vector_type(field_type: pa.DataType) -> pa.FixedSizeListType:
    """The FixedSizeList type of a vector column."""
    if isinstance(field_type, pa.ExtensionType):
        raise NotImplementedError(_EXTENSION_TODO)
    assert pa.types.is_fixed_size_list(field_type), field_type
    return field_type


def vector_field_type(field: pa.Field) -> pa.FixedSizeListType:
    """:func:`vector_type` of a schema field. Also refuses an extension
    column that was read without its type registered (Arrow then shows
    the storage type and keeps the name in the field metadata): its raw
    storage codes are not the vectors the column holds."""
    if field.metadata and b"ARROW:extension:name" in field.metadata:
        raise NotImplementedError(_EXTENSION_TODO)
    return vector_type(field.type)


def fixed_size_list_to_numpy(array: pa.Array | pa.ChunkedArray) -> np.ndarray:
    """Zero-copy view of a FixedSizeList array as ``[rows, list_size]``
    (a per-chunk copy into one matrix when the column has several
    chunks). Requires a null-free array."""
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
    if isinstance(array, pa.ExtensionArray):
        raise NotImplementedError(_EXTENSION_TODO)

    assert pa.types.is_fixed_size_list(array.type), array.type
    size = array.type.list_size
    values = array.values
    # Respect any slicing offset on the parent array.
    values = values.slice(array.offset * size, len(array) * size)
    flat = values.to_numpy(zero_copy_only=True)
    return flat.reshape(-1, size)


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
    the padding tail there — no padded host copy."""
    if not isinstance(array, np.ndarray):
        array = fixed_size_list_to_numpy(array)
    rows, dim = array.shape
    rows_padded = max(round_up(rows, block), block)
    data = torch.empty((rows_padded, dim), dtype=torch.float32, device=device)
    for start in range(0, rows, _UPLOAD_ROWS):
        part = array[start : start + _UPLOAD_ROWS]
        upload(data[start : start + part.shape[0]], part)
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
