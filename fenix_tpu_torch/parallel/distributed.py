"""Repartitioned (sharded) tables and the cluster bootstrap — port of
``fenix_tpu/parallel/distributed.py``.

``repartition`` hash-partitions a catalog table into ``<t>@<shard>``
tables, writes ``<t>.manifest.json`` beside them and retires the
original name; from then on every entry point resolves the name to its
shard list (:func:`resolve_source`), which the engine serves as a
multi-source request. The files are the JAX package's, so either
package serves a root the other repartitioned.

Two routes place the rows, with the same hash and so the same placement.
With a mesh of exactly ``num_shards`` devices, (key, row id) pairs go
through the device shuffle (``parallel/shuffle.py``) and each shard's
received ids drive the host-side table gather; row payloads never reach
the device, so any Arrow schema repartitions. Otherwise, and for an
empty table, ``native.hash_partition`` places them on the host.

``ClusterConfig`` / ``initialize`` bring up the mesh: with a coordinator
and more than one process, one mesh over every process's devices on
``torch.distributed`` (the JAX package's ``jax.distributed.initialize``
and global mesh); otherwise this process's ``make_mesh``. The mesh
routes of ``parallel/`` then cross the process boundary through the
mesh's collectives (``parallel/mesh.py``); the engine (``DeviceCache``,
the Flight server) stays one process, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os

import numpy as np
import pyarrow as pa
import torch
import torch.distributed as dist

from fenix_tpu_torch import index as index_mod
from fenix_tpu_torch import native
from fenix_tpu_torch.io import table as table_mod
from fenix_tpu_torch.io.locks import catalog_lock
from fenix_tpu_torch.parallel import mesh as mesh_mod
from fenix_tpu_torch.parallel import shuffle as pshuffle
from fenix_tpu_torch.parallel.search import put_rows


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Typed cluster/topology config (serialized as JSON)."""

    coordinator_address: str | None = None  # "host:port"; None = single host
    num_processes: int = 1
    process_id: int = 0
    model_parallel: int = 1

    @staticmethod
    def from_env() -> "ClusterConfig":
        return ClusterConfig(
            coordinator_address=os.environ.get("FENIX_COORDINATOR"),
            num_processes=int(os.environ.get("FENIX_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("FENIX_PROCESS_ID", "0")),
            model_parallel=int(os.environ.get("FENIX_MODEL_PARALLEL", "1")),
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def initialize(config: "ClusterConfig | None" = None, devices=None, timeout: float = 300.0) -> "mesh_mod.Mesh":
    """The engine mesh (the config from the environment when None).

    Without a coordinator, or with one process, this process's
    ``make_mesh`` over ``devices`` (default: every visible card) with the
    config's ``model_parallel``, as the JAX package does. With a
    coordinator and ``num_processes > 1``: every process meets at the
    coordinator's TCP store (process 0 hosts it), publishes its local
    devices, and ``torch.distributed`` comes up on the backend their layout
    decides (:func:`choose_backend`); the mesh spans every process's
    devices in process order (process 0's shards first), each process
    holding its own. ``devices`` may repeat a device (the tests' shards on
    ``cpu``). Every process must bring as many. A peer that does not
    arrive, or a collective one process never enters, fails after
    ``timeout`` seconds."""
    config = config or ClusterConfig.from_env()
    if not (config.coordinator_address and config.num_processes > 1):
        return mesh_mod.make_mesh(model_parallel=config.model_parallel, devices=devices)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devices]
    if not local:
        raise ValueError("no local devices for the mesh")
    rank, world = config.process_id, config.num_processes
    wait = datetime.timedelta(seconds=timeout)
    host, port = config.coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, rank == 0, timeout=wait)
    layout = {"devices": [str(d) for d in local], "uuids": [_card_uuid(d) for d in local]}
    store.set(f"fenix/layout/{rank}", json.dumps(layout))
    layouts = [json.loads(store.get(f"fenix/layout/{p}")) for p in range(world)]
    counts = [len(lay["devices"]) for lay in layouts]
    if len(set(counts)) != 1:
        raise ValueError(f"every process must bring as many devices; they bring {counts}")
    backend = choose_backend([u for lay in layouts for u in lay["uuids"]])
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    dist.init_process_group(backend, store=dist.PrefixStore("fenix/pg", store), rank=rank, world_size=world,
                            timeout=wait)
    flat = mesh_mod.make_mesh(devices=[d for lay in layouts for d in lay["devices"]],
                              model_parallel=config.model_parallel)
    owners = [p for p in range(world) for _ in range(counts[0])]
    return mesh_mod.Mesh(flat.grid, owners=owners, process_index=rank, backend=backend)


def _card_uuid(device: torch.device) -> "str | None":
    if device.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(device.index if device.index is not None else 0).uuid)


def choose_backend(uuids) -> str:
    """The backend for a world whose shards sit on these cards (a card's
    UUID, None for the CPU), in shard order: NCCL when every shard has a
    card of its own, else gloo (the CPU, or shards that share a card,
    which NCCL refuses as a duplicate GPU)."""
    uuids = list(uuids)
    return "nccl" if all(u is not None for u in uuids) and len(set(uuids)) == len(uuids) else "gloo"


@dataclasses.dataclass(frozen=True)
class ShardManifest:
    """Which shard tables make up a repartitioned table (shard files are
    plain catalog tables named ``<table>@<shard>``)."""

    table: str
    num_shards: int

    def shard_name(self, shard: int) -> str:
        return f"{self.table}@{shard}"

    def local_shards(self, process_id: int, num_processes: int) -> list[int]:
        return [s for s in range(self.num_shards) if s % num_processes == process_id]

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


def _device_shuffle_ids(mesh: "mesh_mod.Mesh", keys: np.ndarray, num_shards: int) -> list[np.ndarray]:
    """Each shard's row ids (sorted) by the device shuffle: (key, row id)
    pairs go through ``build_shuffle`` with ``row_shape=()``, keys cut to
    int32 (the low 32 bits, which both hash paths use), ids padded with
    −1 to a multiple of the shard count. The capacity is estimated at
    ``safety=2.0``; on any overflow the exchange runs once more at the
    provable bound ``n_pad // S``. Over several processes ``keys`` is the
    whole key column on every process, the overflow flags are gathered so
    that every process takes the same retry, and the ids of the other
    processes' shards are None."""
    n = keys.size
    n_pad = -(-n // num_shards) * num_shards
    ids = np.full(n_pad, -1, np.int32)
    ids[:n] = np.arange(n, dtype=np.int32)
    keys_pad = np.zeros(n_pad, np.int32)
    keys_pad[:n] = keys.astype(np.int32)
    rows_dev = put_rows(mesh, ids, n_pad)
    keys_dev = put_rows(mesh, keys_pad, n_pad)

    capacity = pshuffle.estimate_capacity(keys, num_shards, n_pad // num_shards, safety=2.0)
    for cap in (capacity, n_pad // num_shards):
        # large exchanges double-buffer (4 chunks); small ones keep one
        chunks = 4 if cap >= 4096 else 1
        cap = -(-cap // chunks) * chunks
        recv_ids, _, valid, overflow = pshuffle.build_shuffle(mesh, cap, (), chunks=chunks)(rows_dev, keys_dev)
        if not bool(overflow.gather().any()):
            break
    out = []
    for got, ok in zip(recv_ids.shards, valid.shards):
        sel = None if got is None else got[ok]
        out.append(None if sel is None else torch.sort(sel[sel >= 0]).values.cpu().numpy())
    return out


def repartition(
    root: str, table_name: str, num_shards: int, key_column: str = "id", mesh=None
) -> ShardManifest:
    """Hash-partition a catalog table on ``key_column`` into
    ``<t>@<shard>`` tables (rows keep their order within a shard), write
    the manifest, and retire the original name and its indexes. With a
    ``mesh`` of ``num_shards`` devices and a nonempty table the rows are
    routed by the device shuffle (:func:`_device_shuffle_ids`), else by
    ``native.hash_partition``: the same hash, so the same placement. It
    runs in one process."""
    if mesh is not None and mesh.process_count > 1:
        raise ValueError("repartition runs in one process; its mesh spans several")
    with catalog_lock(root):
        data = table_mod.load(root, table_name)
        keys = np.asarray(data.column(key_column)).astype(np.int64)
        if mesh is not None and mesh.size == num_shards and keys.size:
            shard_ids = _device_shuffle_ids(mesh, keys, num_shards)
        else:
            parts, _ = native.hash_partition(keys, num_shards)
            shard_ids = [np.flatnonzero(parts == s) for s in range(num_shards)]

        manifest = ShardManifest(table=table_name, num_shards=num_shards)
        for shard, ids in enumerate(shard_ids):
            piece = data.take(pa.array(ids.astype(np.int64)))
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


def shard_table(root: str, table_name: str, num_shards: int, key_column: str = "id") -> ShardManifest:
    """Split a catalog table into hash-partitioned shard tables: the host
    route of :func:`repartition`."""
    return repartition(root, table_name, num_shards, key_column=key_column)
