"""Published peaks of one NVIDIA H100 and the least time a scan needs.

The peaks and the arithmetic are a frozen copy of ``chip_smoke.py:495-497``
(``PEAK_READ``, ``PEAK_OPS``, ``ESIZE``) and ``chip_smoke.py:811-826``
(``bound``), counted here from the work a search asks for rather than
from a kernel's buckets: each input byte read once (the corpus, the two
float32 per-row factors a scan applies, the queries), each output byte
written once (each query's k ids and distances), and 2·Q·N·D operations.
NVIDIA's data sheet (SXM part, dense, 700 W): 3.35 TB/s of HBM; 67
TFLOP/s float32 outside the tensor cores, 989 bf16, 1,979 int8.
"""

from __future__ import annotations

PEAK_READ = 3.35e12  # bytes/s
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}  # operations/s
ESIZE = {"f32": 4, "bf16": 2, "int8": 1}


def bound(route: str, q: int | float, n: int, d: int, k: int) -> dict:
    """The least time one scan of ``n`` rows of width ``d`` for ``q``
    queries could take: the larger of its bytes over the read rate and
    its operations over the peak rate of their type."""
    nbytes = (n + q) * d * ESIZE[route] + 8 * n + 8 * q * k
    ops = 2 * q * n * d
    read_s = nbytes / PEAK_READ
    ops_s = ops / PEAK_OPS[route]
    if read_s >= ops_s:
        return {"bound_s": read_s, "bound_by": "read", "bytes": nbytes, "ops": ops}
    return {"bound_s": ops_s, "bound_by": route, "bytes": nbytes, "ops": ops}
