"""Per-root write lock for catalog mutations.

Copied from ``fenix_tpu/io/locks.py`` (it is JAX-free); only the package
paths in imports and the logger name differ, so both packages share
one on-disk format.

The Flight server dispatches handlers from a thread pool, so the
mutation paths (append, delete-rows, index extend/rebuild) are
read-modify-write sequences that must serialize within the process —
two concurrent appends would otherwise each rewrite the table from the
same base revision and the last writer's ``os.replace`` would silently
drop the other's rows.

Scope: in-process only. Like the reference (one server process owns a
root, upstream fenix/launch.py), multi-writer deployments
point servers at distinct roots; cross-process locking is out of scope.
Readers never take this lock — the hot search path stays lock-free and
relies on atomic publishes plus the cache's mtime stamps (and the
length-mismatch resync in engine/session) for consistency.
"""

from __future__ import annotations

import os
import threading

_GUARD = threading.Lock()
_LOCKS: dict[str, threading.RLock] = {}


def catalog_lock(root: str) -> threading.RLock:
    """The (reentrant) mutation lock for ``root``."""
    root = os.path.abspath(root)
    with _GUARD:
        return _LOCKS.setdefault(root, threading.RLock())


def read_stable(stamp_fn, read_fn, what: str, attempts: int = 5):
    """Lock-free consistent read: retry ``read_fn`` until ``stamp_fn``
    (a cheap revision token) is identical before and after the read.
    The shared idiom behind every multi-file read that must not mix
    catalog revisions (table base+parts, snapshot table+matrix, join
    attribute entries). Returns ``(value, stamp)``."""
    for _ in range(attempts):
        token = stamp_fn()
        try:
            value = read_fn()
        except FileNotFoundError:
            # A compaction/delete can unlink a part between the reader's
            # listing and its open. If the stamp moved, that is just a
            # concurrent mutation — retry like a stamp mismatch. If the
            # stamp is unchanged the file is gone in THIS revision too:
            # genuinely missing, propagate.
            if stamp_fn() != token:
                continue
            raise
        if stamp_fn() == token:
            return value, token
    raise RuntimeError(f"{what} kept changing during read")
