"""Repartitioned (sharded) tables — the host half of
``fenix_tpu/parallel/distributed.py`` (``:66-136``, ``:183-233``).

``repartition`` hash-partitions a catalog table into ``<t>@<shard>``
tables, writes ``<t>.manifest.json`` beside them and retires the
original name; from then on every entry point resolves the name to its
shard list (:func:`resolve_source`), which the engine serves as a
multi-source request. The files are the JAX package's, so either
package serves a root the other repartitioned.

Ported: ``ShardManifest``, ``manifest_path``, ``load_manifest``,
``resolve_source``, ``drop_repartition`` and ``repartition`` through the
host hash (``native.hash_partition``, the engine's hash, so the
placement is the JAX package's whatever route it took). The device
shuffle (``_device_shuffle_ids``, all_to_all over a mesh of as many
devices as shards) raises ``NotImplementedError`` (ROADMAP queue 1 item
10 (c)); multi-host bootstrap is its own later item.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pyarrow as pa

from fenix_tpu_torch import index as index_mod
from fenix_tpu_torch import native
from fenix_tpu_torch.io import table as table_mod
from fenix_tpu_torch.io.locks import catalog_lock


@dataclasses.dataclass(frozen=True)
class ShardManifest:
    """Which shard tables make up a repartitioned table (shard files are
    plain catalog tables named ``<table>@<shard>``)."""

    table: str
    num_shards: int

    def shard_name(self, shard: int) -> str:
        return f"{self.table}@{shard}"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(text: str) -> "ShardManifest":
        return ShardManifest(**json.loads(text))


def manifest_path(root: str, table_name: str) -> str:
    return os.path.join(root, table_mod.LOCATION, table_name + ".manifest.json")


def load_manifest(root: str, table_name: str) -> "ShardManifest | None":
    path = manifest_path(root, table_name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return ShardManifest.from_json(f.read())


def resolve_source(root: str, source):
    """Expand repartitioned table names into their shard lists; other
    names pass through untouched."""
    if isinstance(source, str):
        manifest = load_manifest(root, source)
        if manifest is None:
            return source
        return [manifest.shard_name(s) for s in range(manifest.num_shards)]
    out: list[str] = []
    for name in source:
        resolved = resolve_source(root, name)
        out.extend([resolved] if isinstance(resolved, str) else resolved)
    return out


def drop_repartition(root: str, table_name: str) -> bool:
    """Remove a table's manifest and its shard tables with their indexes
    (an overwrite or drop of a repartitioned name). Returns whether one
    existed."""
    manifest = load_manifest(root, table_name)
    if manifest is None:
        return False
    for s in range(manifest.num_shards):
        name = manifest.shard_name(s)
        index_mod.drop_for_source(root, name)
        table_mod.drop(root, name)
    os.unlink(manifest_path(root, table_name))
    return True


def repartition(
    root: str, table_name: str, num_shards: int, key_column: str = "id", mesh=None
) -> ShardManifest:
    """Hash-partition a catalog table on ``key_column`` into
    ``<t>@<shard>`` tables (rows keep their order within a shard), write
    the manifest, and retire the original name and its indexes. With a
    ``mesh`` of ``num_shards`` devices the JAX package shuffles on the
    devices; that route is not ported and raises."""
    if mesh is not None and mesh.size == num_shards:
        raise NotImplementedError(
            "repartition's device shuffle over a mesh is not ported (ROADMAP queue 1 item 10 (c))"
        )
    with catalog_lock(root):
        data = table_mod.load(root, table_name)
        keys = np.asarray(data.column(key_column)).astype(np.int64)
        parts, _ = native.hash_partition(keys, num_shards)

        manifest = ShardManifest(table=table_name, num_shards=num_shards)
        for shard in range(num_shards):
            piece = data.take(pa.array(np.flatnonzero(parts == shard)))
            table_mod.make(root, manifest.shard_name(shard), piece.to_reader())

        path = manifest_path(root, table_name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(manifest.to_json())
        os.replace(tmp, path)

        index_mod.drop_for_source(root, table_name)
        table_mod.drop(root, table_name)
    return manifest
