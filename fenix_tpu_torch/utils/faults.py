"""Fault injection points for resilience testing.

Copied from ``fenix_tpu/utils/faults.py`` (it is JAX-free); only the package
paths in imports and the logger name differ, so both packages share
one on-disk format.

SURVEY.md §5: the reference has no failure-handling story at all; the
plan calls for "fault injection at the exchange boundary". Failure
points are armed via environment or programmatically:

    FENIX_FAULT_INJECT="search:2,put:1"   # fail the Nth call per verb

Deterministic (counter-based, not probabilistic) so tests and replay
runs reproduce exactly. Injected failures raise ``InjectedFault``,
which the Flight server lets propagate — clients exercise their retry
path against it.
"""

from __future__ import annotations

import os
import threading


class InjectedFault(RuntimeError):
    pass


class FaultPlan:
    def __init__(self, spec: str | None = None) -> None:
        self._lock = threading.Lock()
        self._arm: dict[str, int] = {}
        self._count: dict[str, int] = {}
        if spec:
            self.configure(spec)

    def configure(self, spec: str) -> None:
        """``"verb:N,verb2:M"`` — fail the N-th call of ``verb`` (1-based)."""
        with self._lock:
            self._arm.clear()
            self._count.clear()
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                verb, _, nth = part.partition(":")
                self._arm[verb] = int(nth or 1)

    def reset(self) -> None:
        with self._lock:
            self._arm.clear()
            self._count.clear()

    def check(self, point: str) -> None:
        """Raise InjectedFault when ``point`` hits its armed call count."""
        with self._lock:
            if point not in self._arm:
                return
            self._count[point] = self._count.get(point, 0) + 1
            if self._count[point] == self._arm[point]:
                raise InjectedFault(f"injected fault at {point!r} (call {self._count[point]})")


GLOBAL = FaultPlan(os.environ.get("FENIX_FAULT_INJECT"))
