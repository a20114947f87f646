"""Dense tensor-valued Arrow columns — port of ``fenix_tpu/types/tensor.py``.

``TensorType`` is an extension type over FixedSizeList storage with the
logical per-row shape in JSON metadata. The extension name
(``fenix_tpu.tensor``) and the serialized metadata are the JAX
package's, so a column built by either package has the same IPC bytes
and either package reads the other's files. The array bridges target
numpy and ``torch.Tensor``.
"""

from __future__ import annotations

import json
from typing import Sequence, Type

import numpy as np
import pyarrow as pa
import torch

NAME = "fenix_tpu.tensor"


class TensorType(pa.ExtensionType):
    """Fixed-shape tensor per row, stored as FixedSizeList."""

    def __init__(self, storage_type: pa.DataType, shape: Sequence[int]) -> None:
        self.shape = tuple(int(s) for s in shape)
        super().__init__(storage_type, NAME)

    def __arrow_ext_serialize__(self) -> bytes:
        return json.dumps({"shape": self.shape}).encode()

    @classmethod
    def __arrow_ext_deserialize__(cls, storage_type: pa.DataType, serialized: bytes) -> "TensorType":
        meta = json.loads(serialized.decode())
        return TensorType(storage_type, meta["shape"])

    def __arrow_ext_class__(self) -> Type["TensorArray"]:
        return TensorArray

    def __arrow_ext_scalar_class__(self) -> Type["TensorScalar"]:
        return TensorScalar


class TensorArray(pa.ExtensionArray):
    @staticmethod
    def from_numpy(tensor: np.ndarray) -> "TensorArray":
        tensor = np.ascontiguousarray(tensor)
        dtype = pa.from_numpy_dtype(tensor.dtype)
        num_rows, *shape = tensor.shape
        flat = tensor.reshape(num_rows, -1)
        storage_type = pa.list_(dtype, flat.shape[-1])
        storage = pa.FixedSizeListArray.from_arrays(pa.array(flat.reshape(-1)), list_size=flat.shape[-1])
        return pa.ExtensionArray.from_storage(TensorType(storage_type, shape), storage)

    @staticmethod
    def from_torch(tensor: torch.Tensor) -> "TensorArray":
        return TensorArray.from_numpy(tensor.detach().cpu().numpy())

    def to_numpy(self) -> np.ndarray:
        flat = self.storage.flatten().to_numpy(zero_copy_only=False)
        return flat.reshape(-1, *self.type.shape)

    def to_torch(self) -> torch.Tensor:
        return torch.tensor(self.to_numpy())


class TensorScalar(pa.ExtensionScalar):
    @staticmethod
    def from_numpy(tensor: np.ndarray) -> "TensorScalar":
        tensor = np.ascontiguousarray(tensor)
        dtype = pa.from_numpy_dtype(tensor.dtype)
        shape = tuple(tensor.shape)
        flat = tensor.reshape(-1)
        scalar = pa.scalar(flat, pa.list_(dtype, flat.shape[-1]))
        return pa.ExtensionScalar.from_storage(TensorType(scalar.type, shape), scalar)

    def to_numpy(self) -> np.ndarray:
        return self.value.values.to_numpy(zero_copy_only=False).reshape(*self.type.shape)

    def to_torch(self) -> torch.Tensor:
        return torch.tensor(self.to_numpy())


def from_numpy(tensor: np.ndarray) -> TensorArray:
    return TensorArray.from_numpy(tensor)


def from_torch(tensor: torch.Tensor) -> TensorArray:
    return TensorArray.from_torch(tensor)


def register() -> None:
    try:
        pa.register_extension_type(TensorType(pa.list_(pa.float32(), 1), (1,)))
    except pa.ArrowKeyError:
        pass
