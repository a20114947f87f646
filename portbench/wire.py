"""The client's side of the port's Flight wire, with ``pyarrow.flight``
alone.

Frozen copy of ``fenix_tpu_torch/flight.py:548-611`` (``Flight.search``:
the JSON command and the ``target`` column; ``_encode_target``) and of
``fenix_tpu_torch/io/ingest.py:209-213`` (``numpy_to_fixed_size_list``),
plus the two control-plane actions set-up sends (``make-coder``,
``make-index``). The client processes import this and no torch: the
port's own client imports the whole engine. A change to the port's wire
is a change this copy does not follow.
"""

from __future__ import annotations

import json
from typing import Any, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.flight as fl


def _dumps(obj: Any) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def search_command(
    source: str,
    column: str,
    metric: "str | None",
    select: "Sequence[str] | None",
    filter: "dict | None",
    maxval: "int | None",
    probes: "int | None" = None,
    coding: "str | None" = None,
    precision: str = "fp32",
    residency: str = "auto",
) -> bytes:
    """The ``do_exchange`` descriptor's command; ``filter`` is the wire
    form of a ``fenix_tpu_torch.expr`` tree."""
    return _dumps(
        {
            "coding": coding,
            "source": source,
            "column": column,
            "metric": metric,
            "select": [*select] if select is not None else None,
            "filter": filter,
            "maxval": maxval,
            "probes": probes,
            "join": None,
            "aggregate": None,
            "precision": precision,
            "residency": residency,
            "extra": None,
        }
    )


def encode_target(target: np.ndarray) -> pa.Table:
    """One query → a flat float column (the reference wire shape); a
    ``[Q, D]`` batch → a FixedSizeList column."""
    target = np.ascontiguousarray(target, dtype=np.float32)
    if target.ndim == 2:
        flat = pa.array(target.reshape(-1), type=pa.float32())
        return pa.table({"target": pa.FixedSizeListArray.from_arrays(flat, list_size=target.shape[1])})
    return pa.table({"target": pa.array(target)})


def search(conn: fl.FlightClient, command: bytes, target: pa.Table) -> pa.Table:
    writer, reader = conn.do_exchange(fl.FlightDescriptor.for_command(command))
    with writer:
        writer.begin(target.schema)
        writer.write_table(target)
        writer.done_writing()
        return reader.read_all()


def action(conn: fl.FlightClient, verb: str, body: Any) -> list[bytes]:
    return [r.body.to_pybytes() for r in conn.do_action(fl.Action(verb, _dumps(body)))]


def make_index(conn: fl.FlightClient, name: str, source: str, column: str, config: dict, seed: int) -> None:
    """Train coder ``name`` on the server's card from ``seed``, then assign
    the rows to its cells (``Flight.make_index``, with the seed the port's
    client leaves to chance)."""
    action(conn, "make-coder", {"name": name, "source": source, "column": column, "config": config, "seed": seed})
    action(conn, "make-index", {"name": name, "source": source, "column": column})


def split_result(result: pa.Table, q: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """``[q, k]`` ids and distances from a result table, padded with
    (-1, +inf) where a query returned fewer than k rows. Rows come in
    query order (``__QUERY_ID__`` for a batch), each query's by rank."""
    ids = np.asarray(result.column("id").to_numpy(zero_copy_only=False), dtype=np.int64)
    dist = np.asarray(result.column("__DISTANCE__").to_numpy(zero_copy_only=False), dtype=np.float64)
    if "__QUERY_ID__" in result.column_names:
        qid = np.asarray(result.column("__QUERY_ID__").to_numpy(zero_copy_only=False), dtype=np.int64)
    else:
        qid = np.zeros(len(ids), np.int64)
    out_ids = np.full((q, k), -1, np.int64)
    out_d = np.full((q, k), np.inf, np.float64)
    if len(ids) == 0:
        return out_ids, out_d
    if (np.diff(qid) < 0).any() or qid.min() < 0 or qid.max() >= q:
        out_ids[:] = -2  # not in query order: every row is wrong
        return out_ids, out_d
    counts = np.bincount(qid, minlength=q)
    slot = np.arange(len(ids)) - np.repeat(np.cumsum(counts) - counts, counts)
    keep = slot < k
    extra = ~keep
    out_ids[qid[keep], slot[keep]] = ids[keep]
    out_d[qid[keep], slot[keep]] = dist[keep]
    if extra.any():
        out_ids[qid[extra]] = -2  # more than k rows: the query's answer is wrong
    return out_ids, out_d
