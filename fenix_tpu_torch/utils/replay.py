"""Deterministic query logging and replay — port of
``fenix_tpu/utils/replay.py``.

Every search descriptor is stateless JSON, so a query log is a complete
record of the serving workload. ``record`` appends one line per query
(its config, its target as Arrow IPC, its result's digest) to
``$FENIX_QUERY_LOG``; ``replay`` runs a log again against a storage root
and compares the result digests: after a restart, or on a rebuilt
replica, equal digests show the engine came back to the same state. The
log format is the JAX package's, so each package replays the other's
logs; digests compare within one package (their float32 distances may
differ in the last bits).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
from typing import Any, Iterator

import pyarrow as pa

from fenix_tpu_torch import types
from fenix_tpu_torch.engine import executor, service

_LOCK = threading.Lock()

LOG_ENV = "FENIX_QUERY_LOG"


def digest(table: pa.Table) -> str:
    """Order-sensitive content digest of a result table."""
    h = hashlib.sha256()
    h.update(",".join(table.column_names).encode())
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    h.update(sink.getvalue().to_pybytes())
    return h.hexdigest()[:32]


def record(config: dict[str, Any], target: pa.Table, result: pa.Table) -> None:
    """Append one query and its result digest to ``$FENIX_QUERY_LOG``."""
    path = os.environ.get(LOG_ENV)
    if not path:
        return
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, target.schema) as w:
        w.write_table(target)
    line = json.dumps(
        {
            "config": config,
            "target_ipc": base64.b64encode(sink.getvalue().to_pybytes()).decode(),
            "digest": digest(result),
        },
        separators=(",", ":"),
    )
    with _LOCK:
        with open(path, "a") as f:
            f.write(line + "\n")


def load(path: str) -> Iterator[dict[str, Any]]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def target_of(entry: dict[str, Any]) -> pa.Array:
    """The logged target column of one entry, as the server read it."""
    table = pa.ipc.open_stream(pa.py_buffer(base64.b64decode(entry["target_ipc"]))).read_all()
    return types.typed_column(table, "target").combine_chunks()


def replay(path: str, root: str, device: str = "cuda") -> dict[str, int]:
    """Run a query log again against ``root`` on ``device``; returns match
    counts. Dispatches through ``engine.service``, so every recorded
    config (joins, aggregates, precision) replays on the code path that
    produced its digest."""
    cache = executor.get_cache(root, device)
    stats = {"total": 0, "matched": 0, "mismatched": 0}
    for entry in load(path):
        result = service.run_search_config(cache, entry["config"], target_of(entry))
        stats["total"] += 1
        if digest(result) == entry["digest"]:
            stats["matched"] += 1
        else:
            stats["mismatched"] += 1
    return stats
