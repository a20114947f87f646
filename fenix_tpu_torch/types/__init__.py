"""Columnar type system: tensor / nested / quantized Arrow columns — port
of ``fenix_tpu/types``.

The three extension types keep the JAX package's names
(``fenix_tpu.tensor``, ``fenix_tpu.nested``, ``fenix_tpu.quint8``) and
serialized JSON, so either package reads the other's files.

**This package registers nothing on import.** pyarrow keeps one class
per extension name in a process, and the JAX package registers its own
classes when it is imported and recognises a quint8 column by
``isinstance`` on them. Were the port's classes registered first in a
process that imports the JAX package afterwards, the JAX package would
silently search raw uint8 codes. ``register_all`` exists for a process
that never imports the JAX package; nothing in this package calls it.

So the port recognises a typed column by its extension name and
serialized parameters (:func:`logical_vector`), in either form it can
arrive in: a registered ``pa.ExtensionType`` (whichever package's class
it is), or an unregistered column, which Arrow shows as its storage type
with ``ARROW:extension:name`` / ``ARROW:extension:metadata`` in the
field metadata. :func:`typed_column` puts the port's extension type
back on such a column.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import pyarrow as pa

from fenix_tpu_torch.types import nested, quint8, tensor
from fenix_tpu_torch.types.nested import NestedTensorArray, NestedTensorType
from fenix_tpu_torch.types.quint8 import QUInt8NDArray, QUInt8TensorArray, QUInt8TensorType
from fenix_tpu_torch.types.tensor import TensorArray, TensorType

NAME_KEY = b"ARROW:extension:name"
METADATA_KEY = b"ARROW:extension:metadata"

# extension name -> (kind, the port's class)
_KINDS = {
    tensor.NAME: ("tensor", TensorType),
    nested.NAME: ("nested", NestedTensorType),
    quint8.NAME: ("quint8", QUInt8TensorType),
}


class LogicalVector(NamedTuple):
    """How the engine reads a column: ``kind`` is ``"tensor"``,
    ``"nested"``, ``"quint8"``, ``"extension"`` (another extension name:
    its storage is read as it is, as the JAX package reads it) or None (a
    plain column); ``storage`` is the Arrow storage type; ``params`` the
    serialized parameters (``{}`` for a plain column)."""

    kind: "str | None"
    storage: pa.DataType
    params: dict

    @property
    def affine(self) -> "tuple[np.float32, np.float32] | None":
        """``(scale, shift)`` as float32 of a quint8 column, else None."""
        if self.kind != "quint8":
            return None
        return np.float32(self.params["scale"]), np.float32(self.params["shift"])


def _extension(obj) -> "tuple[str, bytes, pa.DataType] | None":
    """``(name, serialized parameters, storage type)`` of an extension
    column, registered or not; None for a plain one."""
    field = obj if isinstance(obj, pa.Field) else None
    typ = obj if isinstance(obj, pa.DataType) else (field.type if field is not None else obj.type)
    if isinstance(typ, pa.ExtensionType):
        return typ.extension_name, typ.__arrow_ext_serialize__(), typ.storage_type
    meta = field.metadata if field is not None else None
    if meta and NAME_KEY in meta:
        return meta[NAME_KEY].decode(), meta.get(METADATA_KEY, b""), typ
    return None


def logical_vector(obj: "pa.Field | pa.DataType | pa.Array | pa.ChunkedArray") -> LogicalVector:
    """The kind, storage type and parameters of a column, from a field
    (either form), a type or an array (the registered form only: an
    unregistered array carries no extension metadata)."""
    ext = _extension(obj)
    if ext is None:
        typ = obj.type if isinstance(obj, (pa.Field, pa.Array, pa.ChunkedArray)) else obj
        return LogicalVector(None, typ, {})
    name, serialized, storage = ext
    kind = _KINDS.get(name, ("extension", None))[0]
    params = json.loads(serialized.decode()) if kind != "extension" and serialized else {}
    return LogicalVector(kind, storage, params)


def extension_metadata(field: pa.Field) -> "dict[bytes, bytes] | None":
    """The ``ARROW:extension:*`` entries of an unregistered extension
    field (what makes its IPC form typed), else None."""
    if not field.metadata or NAME_KEY not in field.metadata:
        return None
    return {k: v for k, v in field.metadata.items() if k in (NAME_KEY, METADATA_KEY)}


def storage_schema(schema: pa.Schema) -> pa.Schema:
    """``schema`` as an unregistered reader sees it: each extension field
    as its storage type with the ``ARROW:extension:*`` field metadata
    (whichever package's class, or none, it came with), the IPC form two
    schemas must share to append one to the other."""
    fields = []
    for f in schema:
        if isinstance(f.type, pa.ExtensionType):
            meta = {**(f.metadata or {}), NAME_KEY: f.type.extension_name.encode(),
                    METADATA_KEY: f.type.__arrow_ext_serialize__()}
            f = pa.field(f.name, f.type.storage_type, f.nullable, meta)
        fields.append(f)
    return pa.schema(fields, metadata=schema.metadata)


def typed_column(table: pa.Table, name: str) -> pa.ChunkedArray:
    """Column ``name`` of ``table``, with the port's extension type put
    back (zero-copy) when its field shows one of the three types in the
    unregistered form; otherwise the column as it is."""
    column = table.column(name)
    ext = _extension(table.schema.field(name))
    if ext is None or isinstance(column.type, pa.ExtensionType) or ext[0] not in _KINDS:
        return column
    ext_name, serialized, storage = ext
    typ = _KINDS[ext_name][1].__arrow_ext_deserialize__(storage, serialized)
    return pa.chunked_array([pa.ExtensionArray.from_storage(typ, c) for c in column.chunks], type=typ)


def register_all() -> None:
    """Register the port's classes under the three names, for a process
    that never imports the JAX package (see the module docstring)."""
    tensor.register()
    nested.register()
    quint8.register()


__all__ = [
    "tensor",
    "nested",
    "quint8",
    "TensorArray",
    "TensorType",
    "NestedTensorArray",
    "NestedTensorType",
    "QUInt8NDArray",
    "QUInt8TensorArray",
    "QUInt8TensorType",
    "LogicalVector",
    "logical_vector",
    "extension_metadata",
    "storage_schema",
    "typed_column",
    "register_all",
]
