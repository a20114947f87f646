"""Usable device-memory budget, shared by every consumer — port of
``fenix_tpu/utils/hbm.py``.

One parser, one fallback: ``FENIX_HBM_BUDGET`` (bytes; plain ints and
float notation such as ``9e9``, anything else raises) wins; otherwise
the card's total memory as ``torch.cuda.mem_get_info`` reports it,
scaled by ``FENIX_HBM_FRACTION`` (default 0.9: the CUDA context, the
caching allocator's slack and per-request temporaries live in the rest);
``None`` = unknown (a CPU device), and callers keep their no-budget
behavior. Which source resolved the budget is surfaced once per process
as a stats counter (``hbm.budget_from_env`` /
``hbm.budget_from_device_scaled``).

The device total is memoized per device: the residency router consults
the budget on every search request.
"""

from __future__ import annotations

import os

import torch

from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

_ENV = "FENIX_HBM_BUDGET"
_FRACTION_ENV = "FENIX_HBM_FRACTION"
DEFAULT_DEVICE_FRACTION = 0.9
_DEVICE_TOTAL: dict = {}  # device -> total bytes
_SOURCES_EMITTED: set = set()  # one stats counter per source per process


def parse_budget(env: str) -> "int | None":
    """Byte count from the env-var string; ``None`` for <= 0 (off)."""
    try:
        b = int(float(env))
    except ValueError:
        raise ValueError(
            f"{_ENV} must be a byte count (e.g. 9000000000 or 9e9), got {env!r}"
        ) from None
    return b if b > 0 else None


def _device_fraction() -> float:
    env = os.environ.get(_FRACTION_ENV, "")
    if not env:
        return DEFAULT_DEVICE_FRACTION
    try:
        f = float(env)
    except ValueError:
        raise ValueError(f"{_FRACTION_ENV} must be a fraction in (0, 1], got {env!r}") from None
    if not 0.0 < f <= 1.0:
        raise ValueError(f"{_FRACTION_ENV} must be in (0, 1], got {env!r}")
    return f


def _emit_source(source: str) -> None:
    if source in _SOURCES_EMITTED:
        return
    _SOURCES_EMITTED.add(source)
    METRICS.add(f"hbm.budget_from_{source}")


def budget_bytes(device: "str | torch.device") -> "int | None":
    """Usable device memory in bytes on ``device``: env override, else
    the card's total scaled by the usable fraction, else ``None``."""
    env = os.environ.get(_ENV, "")
    if env:
        b = parse_budget(env)
        if b is not None:
            _emit_source("env")
            return b
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device not in _DEVICE_TOTAL:
        _DEVICE_TOTAL[device] = torch.cuda.mem_get_info(device)[1]
    _emit_source("device_scaled")
    return int(_DEVICE_TOTAL[device] * _device_fraction())
