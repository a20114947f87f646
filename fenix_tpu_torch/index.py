"""Materialized cell-assignment index and the search entry point — port
of ``fenix_tpu/index.py``.

``make`` assigns every source row to its nearest composite cell and
writes ``<root>/indexes/<source>/<column>/<name>.arrow`` with a single
``__CODED_ID__: int64`` column, as the JAX package writes it (one root
serves both packages, a table overwrite drops the indexes over it
whichever package built them); ``load`` joins it onto the source table;
``call`` is the query engine (``engine/executor.py``).

Assignment runs on the device in blocks of ``ASSIGN_BLOCK`` rows fed by
``io/batch.prefetch_to_device`` (block i+1's upload under block i's
argmin), or on the host through ``ops/cells.assign_cells_np`` when the
table's fp32 form does not fit the device budget, or as ``FENIX_ASSIGN``
(``auto`` | ``host`` | ``device``) says.

Table mutations keep every index over the table row-aligned:
``extend_for_source`` assigns only appended rows, ``delete_rows``
filters the table and its indexes by one keep-mask and records it as the
revision's lineage (``io/table.record_lineage``: device caches then
compact on the card), and ``upsert_rows`` is the two in one catalog-lock
scope.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Iterator, Sequence

import numpy as np
import pyarrow as pa
import torch

from fenix_tpu_torch import coder as coder_mod
from fenix_tpu_torch import expr as expr_mod
from fenix_tpu_torch.io import arrow, ingest, table
from fenix_tpu_torch.io import batch as batch_io
from fenix_tpu_torch.io.locks import catalog_lock
from fenix_tpu_torch.ops import cells as cells_ops
from fenix_tpu_torch.utils import hbm
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

LOCATION: str = "indexes"
CODE_COL: str = "__CODED_ID__"
DIST_COL: str = "__DISTANCE__"  # the result's distance column
QUERY_COL: str = "__QUERY_ID__"  # the result's query column of a batch
ASSIGN_BLOCK: int = 1 << 16  # rows per device assignment block


def path_of(root: str, name: str, source: str, column: str) -> str:
    return table.safe_join(root, LOCATION, source, column, name + ".arrow")


def load(root: str, name: str, source: str | Sequence[str], column: str) -> pa.Table:
    """The source table(s) with the index's ``__CODED_ID__`` column."""
    if isinstance(source, str):
        return table.join(
            table.load(root, source), arrow.load(path_of(root, name, source, column)), axis=1
        )
    return table.join(*[load(root, name, s, column) for s in source])


def make(
    root: str,
    name: str,
    source: str | Sequence[str],
    column: str,
    device: "str | torch.device" = "cuda",
) -> pa.Table:
    """Assign every row of ``source`` to a cell of coder ``name`` (on
    ``device``) and write the index; returns :func:`load`'s table."""
    if not isinstance(source, str):
        return table.join(*[make(root, name, s, column, device) for s in source])
    with catalog_lock(root):
        data = table.load(root, source)
        codes = _assign_codes(root, name, ingest.vector_matrix(data, column), device)
        _write_codes(path_of(root, name, source, column), codes)
        return load(root, name, source, column)


def _assign_codes(root: str, name: str, matrix: np.ndarray, device: "str | torch.device") -> np.ndarray:
    """Nearest composite cell per row (int64) of the vector ``matrix``, on
    the device or on the host (see the module docstring for the route)."""
    coding = coder_mod.load(root, name)
    metric = coding["config"]["metric"]
    num_rows, dim = matrix.shape

    route = os.environ.get("FENIX_ASSIGN", "auto").lower()
    if route not in ("auto", "host", "device"):
        raise ValueError(f"FENIX_ASSIGN must be auto|host|device, got {route!r}")
    if route == "auto":
        budget = hbm.budget_bytes(device)
        # about the router's dual-residency test (fp32 + 16 B/row aux)
        route = "host" if budget is not None and num_rows * (4 * dim + 16) > 0.9 * budget else "device"

    codes = np.empty(num_rows, dtype=np.int64)
    if route == "host":
        METRICS.add("index.host_assigns")
        chunk = max(1, (256 << 20) // max(4 * dim, 1))
        for start in range(0, num_rows, chunk):
            stop = min(start + chunk, num_rows)
            codes[start:stop] = cells_ops.assign_cells_np(
                np.asarray(matrix[start:stop], dtype=np.float32), coding["tensor"], metric
            )
        return codes

    codebooks = torch.tensor(coding["tensor"], device=device)
    block = min(ASSIGN_BLOCK, max(num_rows, 1))

    def blocks() -> Iterator[tuple[np.ndarray]]:
        # fixed-shape items: the ragged tail is padded with zero rows
        for start in range(0, num_rows, block):
            part = np.asarray(matrix[start : start + block], dtype=np.float32)
            if part.shape[0] < block:
                part = np.concatenate([part, np.zeros((block - part.shape[0], dim), np.float32)])
            yield (part,)

    for i, (rows,) in enumerate(batch_io.prefetch_to_device(blocks(), device)):
        start = i * block
        stop = min(start + block, num_rows)
        assigned = cells_ops.assign_cells(rows, codebooks, metric)
        codes[start:stop] = assigned[: stop - start].cpu().numpy()
    return codes


def _write_codes(path: str, codes: np.ndarray) -> None:
    schema = pa.schema({CODE_COL: pa.int64()})
    arrow.make(
        path,
        pa.RecordBatchReader.from_batches(
            schema, iter([pa.record_batch([pa.array(codes)], names=[CODE_COL])])
        ),
    )


def list(root: str) -> Iterator[str]:
    base = os.path.join(root, LOCATION)
    for path in sorted(glob.glob(os.path.join(base, "**", "*.arrow"), recursive=True)):
        yield os.path.relpath(path, base).removesuffix(".arrow")


def drop(root: str, name: str, source: str, column: str) -> None:
    path = path_of(root, name, source, column)
    if os.path.exists(path):
        os.unlink(path)


def drop_all(root: str, name: str) -> None:
    """Drop every index built from coder ``name``: the name must match a
    whole path suffix at a ``/`` boundary, so a coder whose name merely
    ends with the same string keeps its indexes."""
    base = os.path.join(root, LOCATION)
    suffix = os.sep + name + ".arrow"
    for path in glob.glob(os.path.join(base, "**", "*.arrow"), recursive=True):
        if path.endswith(suffix):
            os.unlink(path)


def indexes_for_source(root: str, source: str) -> Iterator[tuple[str, str]]:
    """Yield ``(name, column)`` for every index built over ``source``.

    Under ``indexes/<source>/`` the first path component is the column
    and the rest is the coder name. Sources nest (``a`` and ``a/b`` can
    both exist), so an entry is attributed to ``source`` only if its
    column is in the source's schema AND its name has a coder artifact."""
    base = table.safe_join(root, LOCATION, source)
    try:
        columns = set(table.load(root, source).schema.names)
    except FileNotFoundError:
        return
    for path in sorted(glob.glob(os.path.join(base, "**", "*.arrow"), recursive=True)):
        rel = os.path.relpath(path, base)
        column, _, name = rel.partition(os.sep)
        name = name.removesuffix(".arrow")
        if column in columns and os.path.exists(coder_mod.path_of(root, name)):
            yield name, column


def drop_for_source(root: str, source: str) -> None:
    """Drop every index file over ``source`` (its assignments are no
    longer row-aligned once the table is overwritten). Broader than
    :func:`indexes_for_source` on purpose — a column the overwrite removed
    must not strand its files — but files of a nested sibling source
    (``a/b`` when ``a`` is dropped) stay."""
    base = table.safe_join(root, LOCATION, source)
    siblings = [
        other[len(source) + 1 :] + "/"
        for other in table.list(root)
        if other != source and other.startswith(source + "/")
    ]
    for path in glob.glob(os.path.join(glob.escape(base), "**", "*.arrow"), recursive=True):
        rel = os.path.relpath(path, base).replace(os.sep, "/")
        if any(rel.startswith(prefix) for prefix in siblings):
            continue
        os.unlink(path)


def extend_for_source(
    root: str, source: str, new_rows: pa.Table, device: "str | torch.device" = "cuda"
) -> None:
    """Append the cell ids of freshly appended ``new_rows`` to every index
    over ``source``: only the new rows are assigned (on ``device`` or on
    the host, :func:`_assign_codes`' route), so an append costs O(rows
    appended). Serializes on the catalog lock."""
    with catalog_lock(root):
        for name, column in [*indexes_for_source(root, source)]:
            path = path_of(root, name, source, column)
            old = ingest.scalar_column_to_numpy(arrow.load(path).column(CODE_COL))
            new = _assign_codes(root, name, ingest.vector_matrix(new_rows, column), device)
            _write_codes(path, np.concatenate([old.astype(np.int64), new]))


def delete_rows(root: str, source: str, filter: expr_mod.Expr) -> int:
    """Delete the rows of ``source`` matching ``filter``; returns their
    count. Every index over the table is filtered by the same keep-mask
    (assignments of kept rows are reused, nothing is assigned again), and
    the mask is recorded as the revision's lineage. Raises ``RuntimeError``
    when an index's row count differs from the table's. Both rewrites
    publish atomically under the catalog lock; a reader between them sees
    a row-count mismatch, which the device cache resyncs."""
    with catalog_lock(root):
        data = table.load(root, source)
        delete = np.asarray(filter.mask(data), dtype=bool)
        keep = pa.array(~delete)
        indexes = [*indexes_for_source(root, source)]
        for name, column in indexes:
            rows = arrow.load(path_of(root, name, source, column)).num_rows
            if rows != data.num_rows:
                raise RuntimeError(
                    f"index {name!r} over {source!r}/{column!r} has {rows} rows but the table has "
                    f"{data.num_rows}; re-run sync_index before deleting"
                )
        old_stamp = table.stamp(root, source)
        table.rewrite(root, source, data.filter(keep).to_reader())
        for name, column in indexes:
            idx_path = path_of(root, name, source, column)
            arrow.make(idx_path, arrow.load(idx_path).filter(keep).to_reader())
        table.record_lineage(root, source, old_stamp, table.stamp(root, source), ~delete)
        return int(delete.sum())


def upsert_rows(
    root: str, source: str, data: pa.Table, key: str = "id", device: "str | torch.device" = "cuda"
) -> tuple[int, int]:
    """Replace or insert by ``key``: delete the rows whose key appears in
    ``data``, then append ``data``, in one catalog-lock scope (a reader
    sees the old or the new revision of every key; the indexes follow
    both steps). Returns ``(replaced, inserted)``. Rows duplicated within
    ``data`` are appended as they are. A table that does not exist is
    created, and index files left from a dropped one go."""
    with catalog_lock(root):
        replaced = 0
        if os.path.exists(table.path_of(root, source)):
            replaced = delete_rows(root, source, expr_mod.field(key).isin(data.column(key).to_pylist()))
            table.append(root, source, data)
            extend_for_source(root, source, data, device)
        else:
            table.append(root, source, data)
            drop_for_source(root, source)
        return replaced, data.num_rows - replaced


def call(
    root: str,
    coding: str | None,
    source: str | Sequence[str],
    column: str,
    target: Any,
    metric: str | None = None,
    select: Sequence[str] | None = None,
    filter: expr_mod.Expr | None = None,
    maxval: int | None = None,
    probes: int | None = None,
    device: "str | torch.device" = "cuda",
) -> pa.Table:
    """Filtered exact or probed (IVF) k-NN search on ``device``."""
    from fenix_tpu_torch.engine import executor  # the engine imports this module

    req = executor.SearchRequest(
        source=source,
        column=column,
        target=target,
        metric=metric,
        coding=coding,
        select=select,
        filter=filter,
        maxval=maxval,
        probes=probes,
    )
    return executor.execute_search(executor.get_cache(root, device), req)
