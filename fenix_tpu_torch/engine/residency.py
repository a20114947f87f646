"""Residency planning — port of ``plan`` from ``fenix_tpu/engine/residency.py``.

``dual`` keeps the fp32 corpus (plus the optional bf16/int8 scan copy)
resident on the device; it is the only mode this package serves. The
JAX package's host-corpus modes — ``int8`` (only the int8 copy resident,
exact rescore on the host) and ``stream`` (corpora larger than device
memory, streamed in chunks) — are not ported yet: a request that forces
one, or whose table does not fit the budget in ``dual``, raises
``NotImplementedError`` instead of answering from another route.
"""

from __future__ import annotations

from fenix_tpu_torch.io import ingest
from fenix_tpu_torch.utils import hbm

DUAL = "dual"
INT8 = "int8"
STREAM = "stream"
_MODES = ("auto", DUAL, INT8, STREAM)
_TODO = "ROADMAP queue 1: int8-resident and streaming residency"

# fraction of the budget the router plans into (headroom for queries,
# results and transient staging)
_SAFETY = 0.9


def plan(cache, req) -> str:
    """Pick the residency mode for a request from host metadata only
    (no device tensors are built to decide)."""
    forced = getattr(req, "residency", "auto") or "auto"
    if forced not in _MODES:
        raise ValueError(f"unknown residency {forced!r}; one of {_MODES}")
    if forced == DUAL:
        return DUAL
    if forced in (INT8, STREAM):
        raise NotImplementedError(f"residency={forced!r} ({_TODO})")

    budget = hbm.budget_bytes(cache.device)
    if budget is None:
        return DUAL

    data = cache.host_table(req.source)
    dim = ingest.vector_field_type(data.schema.field(req.column)).list_size
    n_pad = max(ingest.round_up(data.num_rows, cache.block), cache.block)
    fp32 = 4 * n_pad * dim
    scan_extra = {"fp32": 0, "bf16": 2 * n_pad * dim, "int8": n_pad * dim}[req.precision]
    need = fp32 + scan_extra + 16 * n_pad
    if need <= _SAFETY * budget:
        return DUAL
    mode = INT8 if req.maxval is not None and n_pad * dim + 16 * n_pad <= _SAFETY * budget else STREAM
    raise NotImplementedError(
        f"table {req.source!r} needs {need} device bytes for dual residency, over the "
        f"budget of {budget}; the JAX package would serve it as {mode!r} ({_TODO})"
    )
