"""Arrow IPC stream file storage.

Copied from ``fenix_tpu/io/arrow.py`` (it is JAX-free); only the package
paths in imports and the logger name differ, so both packages share
one on-disk format.

Role parity: upstream fenix/io/arrow/arrow.py:6-21 (load via
memory-map, make via streaming writer then mmap reopen). Same on-disk
format: Arrow IPC *stream* files with an ``.arrow`` suffix, so artifacts
written by either framework are mutually readable.
"""

from __future__ import annotations

import os

import pyarrow as pa


def load(path: str) -> pa.Table:
    """Zero-copy load of an IPC stream file via memory map."""
    with pa.memory_map(path, "rb") as source:
        return pa.ipc.open_stream(source).read_all()


def make(path: str, data: pa.RecordBatchReader) -> pa.Table:
    """Stream batches to ``path`` then reopen memory-mapped."""
    assert path.endswith((".arrow", ".part"))  # .part: table delta files

    os.makedirs(os.path.dirname(path), exist_ok=True)

    tmp = path + ".tmp"
    with pa.OSFile(tmp, "wb") as sink:
        with pa.ipc.new_stream(sink, data.schema) as writer:
            for batch in data:
                writer.write_batch(batch)
    # Atomic publish: a crashed ingest never leaves a torn table behind
    # (the reference writes in place; see SURVEY.md §5 checkpoint notes).
    os.replace(tmp, path)

    return load(path)
