"""uint8 affine-quantized tensor columns — port of ``fenix_tpu/types/quint8.py``.

Per-column (scale, zero point) affine quantization over uint8
FixedSizeList storage, extension name ``fenix_tpu.quint8`` with the JAX
package's JSON metadata (shape, scale, shift, qmax). Dynamic
quantization follows torch's ``quantize_per_tensor_dynamic(reduce_range=
True)`` (codes 0..127) and gives the JAX package's ``(q, scale, shift)``.

A quint8 column is a corpus stored at rest at a quarter of its fp32
bytes; the engine searches its dequantized fp32 values,
``(codes − shift) · scale`` in float32. ``dequantize_np`` and
``dequantize_torch`` compute that with the same two IEEE float32
roundings (a subtraction, then a product), so the host and the card give
the same bits.
"""

from __future__ import annotations

import json
from typing import Sequence, Type

import numpy as np
import pyarrow as pa
import torch

NAME = "fenix_tpu.quint8"


def dynamic_quantize(x: np.ndarray, reduce_range: bool = True) -> tuple[np.ndarray, float, int]:
    """Affine-quantize to uint8: returns ``(q, scale, zero_point)`` with
    ``x ≈ scale · (q − zero_point)``."""
    x = np.asarray(x, dtype=np.float32)
    qmax = 127 if reduce_range else 255
    lo = min(float(x.min()), 0.0)
    hi = max(float(x.max()), 0.0)
    scale = (hi - lo) / qmax if hi > lo else 1.0
    zero_point = int(round(-lo / scale)) if scale else 0
    zero_point = max(0, min(qmax, zero_point))
    q = np.clip(np.round(x / scale) + zero_point, 0, qmax).astype(np.uint8)
    return q, scale, zero_point


def dequantize_np(codes: np.ndarray, scale: float, shift: float) -> np.ndarray:
    """float32 ``(codes − shift) · scale`` of a uint8 array."""
    return (codes.astype(np.float32) - np.float32(shift)) * np.float32(scale)


def dequantize_torch(
    codes: torch.Tensor, scale: float, shift: float, out: "torch.Tensor | None" = None
) -> torch.Tensor:
    """:func:`dequantize_np` on ``codes``' device (into ``out``, a float32
    tensor of their shape, when given): the same bits."""
    out = codes.to(torch.float32) if out is None else out.copy_(codes)
    # float32-exact scalars: each op rounds once in float32
    return out.sub_(float(np.float32(shift))).mul_(float(np.float32(scale)))


class QUInt8NDArray(np.ndarray):
    """uint8 ndarray carrying its (scale, shift) affine parameters."""

    scale: float
    shift: int

    def __new__(cls, array: np.ndarray, scale: float, shift: int) -> "QUInt8NDArray":
        q = np.asarray(array, dtype=np.uint8).view(cls)
        q.scale = scale
        q.shift = shift
        return q

    def __array_finalize__(self, obj) -> None:
        # slices and views skip __new__: carry the parameters along
        if obj is not None:
            self.scale = getattr(obj, "scale", 1.0)
            self.shift = getattr(obj, "shift", 0)

    @staticmethod
    def quantize(array: np.ndarray) -> "QUInt8NDArray":
        q, scale, shift = dynamic_quantize(array)
        return QUInt8NDArray(q, scale, shift)

    def dequantize(self) -> np.ndarray:
        return dequantize_np(self.view(np.ndarray), self.scale, self.shift)


class QUInt8TensorType(pa.ExtensionType):
    def __init__(self, shape: Sequence[int], scale: float, shift: int, qmax: int = 127) -> None:
        self.shape = tuple(int(s) for s in shape)
        self.scale = float(scale)
        self.shift = int(shift)
        # the code range the column was quantized into: appends clip to it
        self.qmax = int(qmax)
        size = int(np.prod(self.shape))
        super().__init__(pa.list_(pa.uint8(), size), NAME)

    def __arrow_ext_serialize__(self) -> bytes:
        return json.dumps({"shape": self.shape, "scale": self.scale, "shift": self.shift, "qmax": self.qmax}).encode()

    @classmethod
    def __arrow_ext_deserialize__(cls, storage_type: pa.DataType, serialized: bytes) -> "QUInt8TensorType":
        return QUInt8TensorType(**json.loads(serialized.decode()))

    def __arrow_ext_class__(self) -> Type["QUInt8TensorArray"]:
        return QUInt8TensorArray

    def __arrow_ext_scalar_class__(self) -> Type["QUInt8TensorScalar"]:
        return QUInt8TensorScalar


def _codes_array(q: np.ndarray) -> pa.FixedSizeListArray:
    flat = np.ascontiguousarray(q).reshape(q.shape[0], -1)
    return pa.FixedSizeListArray.from_arrays(pa.array(flat.reshape(-1)), list_size=flat.shape[-1])


class QUInt8TensorArray(pa.ExtensionArray):
    @staticmethod
    def from_numpy(tensor: np.ndarray, like: "pa.ExtensionType | None" = None) -> "QUInt8TensorArray":
        """Quantize ``tensor`` to a quint8 column. Pass ``like=`` an
        existing column's quint8 type (either package's) to reuse its
        affine parameters and clip to its code range, as an append or
        upsert into a quint8 table must: dynamic quantization would mint
        new parameters and the schemas would not match. The result has
        the type ``like`` itself."""
        if like is not None:
            x = np.asarray(tensor, dtype=np.float32)
            qmax = getattr(like, "qmax", 127)
            q = np.clip(np.round(x / like.scale) + like.shift, 0, qmax).astype(np.uint8)
            return pa.ExtensionArray.from_storage(like, _codes_array(q))
        if isinstance(tensor, QUInt8NDArray):
            q, scale, shift = tensor.view(np.ndarray), tensor.scale, tensor.shift
        else:
            q, scale, shift = dynamic_quantize(tensor)
        _, *shape = q.shape
        return pa.ExtensionArray.from_storage(QUInt8TensorType(shape, scale, shift), _codes_array(q))

    def to_numpy(self) -> QUInt8NDArray:
        flat = self.storage.flatten().to_numpy(zero_copy_only=False)
        return QUInt8NDArray(flat.reshape(-1, *self.type.shape), self.type.scale, self.type.shift)

    def dequantize(self) -> np.ndarray:
        return self.to_numpy().dequantize()

    def to_torch_quantized(self) -> tuple[torch.Tensor, float, int]:
        """(uint8 tensor, scale, shift)."""
        return torch.tensor(self.to_numpy().view(np.ndarray)), self.type.scale, self.type.shift


class QUInt8TensorScalar(pa.ExtensionScalar):
    def to_numpy(self) -> QUInt8NDArray:
        return QUInt8NDArray(np.asarray(self.value.values).reshape(*self.type.shape), self.type.scale, self.type.shift)

    def dequantize(self) -> np.ndarray:
        return self.to_numpy().dequantize()


def from_numpy(tensor: np.ndarray) -> QUInt8TensorArray:
    return QUInt8TensorArray.from_numpy(tensor)


def register() -> None:
    try:
        pa.register_extension_type(QUInt8TensorType((1,), 1.0, 0))
    except pa.ArrowKeyError:
        pass
