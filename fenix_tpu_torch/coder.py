"""Coder (multi-codebook k-means quantizer) lifecycle — port of
``fenix_tpu/coder.py``.

``Config`` (metric, codebook_size, num_codebooks, batch_size,
num_epochs, and optionally ``stream_precision``); ``make`` trains on the
device (``ops/kmeans.train``), or, when the corpus's fp32 form passes 0.9
× the device budget, streams it from the host (``kmeans.train_streaming``
in the transport ``stream_precision`` or ``FENIX_TRAIN_STREAM_PRECISION``
names, fp32 by default; int8 reuses the serving cache's int8 mirror) and
persists; ``load`` / ``list`` / ``drop`` manage the artifacts; ``call``
ranks composite cells for targets (``ops/cells``). Artifacts are the JAX
package's ``codings/<name>.npz`` (codebooks + JSON config), so one root
serves both packages whichever trained the coder; a coder this package
trains is the JAX package's coder of the same seed, up to fp32 summation
order (the same draws, ``ops/kmeans.py``).

Over a mesh (``mesh``: ``"auto"`` is the serving mesh of a CUDA
``device``) a corpus that fits the device trains row-sharded with
``kmeans.train_sharded``, the JAX package's coder of the same seed and
shard count.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator, Sequence, TypedDict

import numpy as np
import pyarrow as pa
import torch

from fenix_tpu_torch import types
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.ops import cells as cells_ops
from fenix_tpu_torch.ops import distance as distance_ops
from fenix_tpu_torch.ops import kmeans
from fenix_tpu_torch.parallel import mesh as mesh_mod
from fenix_tpu_torch.parallel import search as psearch
from fenix_tpu_torch.utils import hbm

LOCATION: str = "codings"


class Config(TypedDict):
    metric: str
    codebook_size: int
    num_codebooks: int
    batch_size: int
    num_epochs: int


class Coding(TypedDict):
    tensor: np.ndarray  # [num_codebooks, codebook_size, dim] fp32
    column: pa.DataType  # fixed_size_list value type of the coded column
    config: Config


def distance(u, v, metric: str, device: "str | torch.device" = "cuda") -> np.ndarray:
    """Pairwise ``[Q, N]`` distance of host arrays, computed on ``device``."""
    def put(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    return distance_ops.pairwise_distance(put(u), put(v), metric).cpu().numpy()


def path_of(root: str, name: str) -> str:
    return table.safe_join(root, LOCATION, name + ".npz")


def make(
    root: str,
    name: str,
    source: str | Sequence[str],
    column: str,
    config: Config,
    seed: int | None = None,
    device: "str | torch.device" = "cuda",
    mesh="auto",
) -> Coding:
    """Train a coder over ``<source>.<column>`` on ``device`` and persist
    it: init from a random row subset, then ``num_epochs`` passes of
    permuted ``num_codebooks·batch_size`` batches, one Lloyd step each.
    With a ``mesh`` (``parallel/mesh.py``; ``"auto"`` resolves as the
    device cache does) the rows shard over it and ``kmeans.train_sharded``
    trains, sampling each shard's rows."""
    data = table.load(root, source)
    column_type = ingest.vector_field_type(data.schema.field(column))
    matrix = ingest.vector_matrix(data, column)
    n, k = config["num_codebooks"], config["codebook_size"]
    num_rows, dim = matrix.shape
    cells_ops.check_cell_space(k, n)

    if seed is None:
        seed = int(np.random.default_rng().integers(1 << 31))
    budget = hbm.budget_bytes(device)
    if budget is not None and 4 * num_rows * dim > 0.9 * budget:
        precision = str(config.get("stream_precision") or os.environ.get("FENIX_TRAIN_STREAM_PRECISION", "fp32"))
        mirror = None
        if precision == "int8" and isinstance(source, str):
            # the engine imports this module: imported here, at call time
            from fenix_tpu_torch.engine import executor

            mirror = executor.get_cache(root, device).host_int8(source, column)
        codebooks = kmeans.train_streaming(
            matrix.astype(np.float32, copy=False),
            seed,
            num_codebooks=n,
            codebook_size=k,
            batch_size=config["batch_size"],
            num_epochs=config["num_epochs"],
            metric=config["metric"],
            device=device,
            precision=precision,
            int8_mirror=mirror,
        )
        return _persist(root, name, config, column_type, codebooks.cpu().numpy())
    if isinstance(mesh, str):
        mesh = mesh_mod.serving_mesh() if torch.device(device).type == "cuda" else None
    if mesh is not None:
        corpus, _ = psearch.shard_corpus(mesh, matrix.astype(np.float32, copy=False))
        codebooks = kmeans.train_sharded(
            mesh,
            corpus,
            num_rows,
            seed,
            num_codebooks=n,
            codebook_size=k,
            batch_size=config["batch_size"],
            num_epochs=config["num_epochs"],
            metric=config["metric"],
        )
        del corpus
        return _persist(root, name, config, column_type, codebooks.cpu().numpy())
    corpus = ingest.to_device_matrix(matrix, block=1, device=device).data
    codebooks = kmeans.train(
        corpus,
        seed,
        num_codebooks=n,
        codebook_size=k,
        batch_size=config["batch_size"],
        num_epochs=config["num_epochs"],
        metric=config["metric"],
    )
    del corpus
    return _persist(root, name, config, column_type, codebooks.cpu().numpy())


def _persist(root: str, name: str, config: Config, column_type, codebooks: np.ndarray) -> Coding:
    path = path_of(root, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        codebooks=np.asarray(codebooks, dtype=np.float32),
        config=json.dumps(dict(config)),
        value_type=str(column_type.value_type),
        list_size=np.int64(column_type.list_size),
    )
    os.replace(tmp, path)
    return load(root, name)


def load(root: str, name: str) -> Coding:
    with np.load(path_of(root, name), allow_pickle=False) as blob:
        config: Config = json.loads(str(blob["config"]))
        value_type = pa.type_for_alias(str(blob["value_type"]))
        list_size = int(blob["list_size"])
        tensor = blob["codebooks"]
    return Coding(tensor=tensor, column=pa.list_(value_type, list_size), config=config)


def list(root: str) -> Iterator[str]:
    base = os.path.join(root, LOCATION)
    for path in sorted(glob.glob(os.path.join(base, "**", "*.npz"), recursive=True)):
        yield os.path.relpath(path, base).removesuffix(".npz")


def drop(root: str, name: str) -> None:
    path = path_of(root, name)
    if os.path.exists(path):
        os.unlink(path)


def call(
    target,
    coding: Coding | tuple[str, str],
    maxval: int | None = None,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Rank composite cells for target vector(s) on ``device``: ``[Q,
    maxval]`` (all ``k^n`` when maxval is None) int64 cell ids, ascending
    by summed per-codebook distance, earliest id on ties. A 1-D target
    is one query and returns ``[maxval]``."""
    if isinstance(coding, tuple):
        coding = load(*coding)
    metric = coding["config"]["metric"]
    n, k, _ = coding["tensor"].shape
    codebooks = torch.tensor(coding["tensor"], device=device)

    if isinstance(target, pa.Table):
        target = types.typed_column(target, "target")
    if isinstance(target, (pa.Array, pa.ChunkedArray)):
        target = ingest.fixed_size_list_to_numpy(target)
    target = np.asarray(target, dtype=np.float32)
    squeeze = target.ndim == 1
    targets = torch.tensor(target[None, :] if squeeze else target, device=device)

    if maxval is None:
        out = cells_ops.all_cell_ranks(targets, codebooks, metric)
    elif k**n > cells_ops.DENSE_CELL_LIMIT:
        out = cells_ops.topk_cells_bounded(targets, codebooks, metric, min(maxval, k**n))
    else:
        out = cells_ops.topk_cells(targets, codebooks, metric, min(maxval, k**n))
    out = out.cpu().numpy().astype(np.int64)
    return out[0] if squeeze else out
