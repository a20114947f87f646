"""Nested (dict-of-tensor) Arrow columns — port of ``fenix_tpu/types/nested.py``.

StructArray storage with one FixedSizeList child per leaf and the
recursive shape tree in JSON metadata (extension name
``fenix_tpu.nested``, the JAX package's bytes); ``to_field`` projects a
sub-tree, a leaf as a ``TensorArray``. The bridges target numpy and
``torch.Tensor``.
"""

from __future__ import annotations

import json
from typing import Any, Type, Union

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from fenix_tpu_torch.types.tensor import TensorScalar, TensorType

NAME = "fenix_tpu.nested"

NestedShape = dict[str, Union[tuple, "NestedShape"]]
NumpyNested = dict[str, Union[np.ndarray, "NumpyNested"]]


def _shape_tree(nested: NumpyNested) -> NestedShape:
    return {k: _shape_tree(v) if isinstance(v, dict) else tuple(v.shape[1:]) for k, v in nested.items()}


def _walk(shape: NestedShape, keys: tuple[str, ...]) -> Any:
    node: Any = shape
    for k in keys:
        node = node[k]
    return node


class NestedTensorType(pa.ExtensionType):
    def __init__(self, storage_type: pa.DataType, shape: NestedShape) -> None:
        self.shape = shape
        super().__init__(storage_type, NAME)

    def __arrow_ext_serialize__(self) -> bytes:
        return json.dumps({"shape": self.shape}).encode()

    @classmethod
    def __arrow_ext_deserialize__(cls, storage_type: pa.DataType, serialized: bytes) -> "NestedTensorType":
        meta = json.loads(serialized.decode())

        def tuplify(node: Any) -> Any:
            if isinstance(node, dict):
                return {k: tuplify(v) for k, v in node.items()}
            return tuple(node)

        return NestedTensorType(storage_type, tuplify(meta["shape"]))

    def __arrow_ext_class__(self) -> Type["NestedTensorArray"]:
        return NestedTensorArray

    def __arrow_ext_scalar_class__(self) -> Type["NestedTensorScalar"]:
        return NestedTensorScalar


class NestedTensorArray(pa.ExtensionArray):
    @staticmethod
    def from_numpy(nested: NumpyNested) -> "NestedTensorArray":
        def to_struct(node: NumpyNested) -> pa.StructArray:
            children = []
            for v in node.values():
                if isinstance(v, dict):
                    children.append(to_struct(v))
                else:
                    v = np.ascontiguousarray(v)
                    flat = v.reshape(v.shape[0], -1)
                    children.append(
                        pa.FixedSizeListArray.from_arrays(pa.array(flat.reshape(-1)), list_size=flat.shape[-1])
                    )
            return pa.StructArray.from_arrays(children, names=list(node))

        struct = to_struct(nested)
        return pa.ExtensionArray.from_storage(NestedTensorType(struct.type, _shape_tree(nested)), struct)

    @staticmethod
    def from_torch(nested) -> "NestedTensorArray":
        def to_numpy(node) -> NumpyNested:
            return {
                k: to_numpy(v) if isinstance(v, dict) else v.detach().cpu().numpy() for k, v in node.items()
            }

        return NestedTensorArray.from_numpy(to_numpy(nested))

    def to_numpy(self) -> NumpyNested:
        def unpack(array: Any, shape: Any) -> Any:
            if isinstance(shape, dict):
                return {k: unpack(pc.struct_field(array, [k]), s) for k, s in shape.items()}
            flat = array.flatten().to_numpy(zero_copy_only=False)
            return flat.reshape(-1, *shape)

        return unpack(self.storage, self.type.shape)

    def to_torch(self):
        def conv(node: Any) -> Any:
            if isinstance(node, dict):
                return {k: conv(v) for k, v in node.items()}
            return torch.tensor(node)

        return conv(self.to_numpy())

    def to_field(self, *keys: str) -> "pa.ExtensionArray":
        array = pc.struct_field(self.storage, list(keys))
        shape = _walk(self.type.shape, keys)
        if isinstance(shape, dict):
            return pa.ExtensionArray.from_storage(NestedTensorType(array.type, shape), array)
        return pa.ExtensionArray.from_storage(TensorType(array.type, list(shape)), array)


class NestedTensorScalar(pa.ExtensionScalar):
    def to_numpy(self) -> NumpyNested:
        def unpack(value: Any, shape: Any) -> Any:
            if isinstance(shape, dict):
                return {k: unpack(value[k], s) for k, s in shape.items()}
            return np.asarray(value.values).reshape(*shape)

        return unpack(self.value, self.type.shape)

    def to_field(self, *keys: str) -> "NestedTensorScalar | TensorScalar":
        value = self.value
        for k in keys:
            value = value[k]
        shape = _walk(self.type.shape, keys)
        if isinstance(shape, dict):
            return pa.ExtensionScalar.from_storage(NestedTensorType(value.type, shape), value)
        return pa.ExtensionScalar.from_storage(TensorType(value.type, list(shape)), value)


def from_numpy(nested: NumpyNested) -> NestedTensorArray:
    return NestedTensorArray.from_numpy(nested)


def register() -> None:
    try:
        pa.register_extension_type(NestedTensorType(pa.struct({"x": pa.list_(pa.float32(), 1)}), {"x": (1,)}))
    except pa.ArrowKeyError:
        pass
