"""Structured per-query metrics and counters.

Copied from ``fenix_tpu/utils/metrics.py`` (it is JAX-free); the package
paths in imports and the logger name differ, and ``timed`` builds its log
line only when INFO is enabled (it runs on every search), so both
packages share one on-disk format.

The reference has no observability beyond a startup log line
(upstream fenix/launch.py:7-15; SURVEY.md §5). Here every
query records rows scanned, candidates returned, and wall time; totals
are exposed through the server's ``stats`` action.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Iterator

LOGGER = logging.getLogger("fenix_tpu_torch")


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    @contextmanager
    def timed(self, name: str, **fields: Any) -> Iterator[dict[str, Any]]:
        """Time a block; bumps ``<name>.count`` / ``<name>.seconds`` and,
        with INFO enabled, emits one structured log line."""
        record: dict[str, Any] = dict(fields)
        start = time.perf_counter()
        try:
            yield record
        finally:
            elapsed = time.perf_counter() - start
            self.add(f"{name}.count")
            self.add(f"{name}.seconds", elapsed)
            if LOGGER.isEnabledFor(logging.INFO):
                record["op"] = name
                record["seconds"] = round(elapsed, 6)
                LOGGER.info(json.dumps(record, default=str))


GLOBAL = Metrics()
