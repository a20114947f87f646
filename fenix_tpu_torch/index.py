"""Index file catalog — the file-level part of ``fenix_tpu/index.py``
(``path_of``, ``list``, ``indexes_for_source``, ``drop_for_source``,
copied).

Index files live at ``<root>/indexes/<source>/<column>/<name>.arrow``
as the JAX package writes them. This package does not build or probe
indexes yet (ROADMAP queue 1); it keeps the catalog consistent: a table
overwrite drops the indexes over it, whichever package built them.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator

from fenix_tpu_torch import coder as coder_mod
from fenix_tpu_torch.io import table

LOCATION: str = "indexes"


def path_of(root: str, name: str, source: str, column: str) -> str:
    return table.safe_join(root, LOCATION, source, column, name + ".arrow")


def list(root: str) -> Iterator[str]:
    base = os.path.join(root, LOCATION)
    for path in sorted(glob.glob(os.path.join(base, "**", "*.arrow"), recursive=True)):
        yield os.path.relpath(path, base).removesuffix(".arrow")


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
