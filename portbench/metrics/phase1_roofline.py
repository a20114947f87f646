"""phase1_roofline (layer ``ops.kernels`` + ``csrc``): the share of the
phase-1 scan's roofline that the card reached over the window, in %.

Numerator: the least time the window's scans need, per dispatch the
larger of its bytes at the peak read rate and its 2·Q·N·D operations at
the peak rate of the scan's type (``portbench/roofline.py``), with Q the
mean queries per dispatch from the ``batch.*`` counters (exact while
every dispatch is bound by the same resource, as at Q <= 32 on D = 768,
read-bound, and at one Q per dispatch) and N, D the configuration's.
Denominator: the device time of the phase-1 kernels in the trace, the
kernels of ``fenix_tpu_torch/csrc/bucket_scores_*.cu`` named below, by
their whole demangled symbol (``void fenix::(anonymous
namespace)::tiled_kernel<float, 8, true>(...)``): a library kernel whose
name merely holds one of theirs, as PyTorch's
``at::native::tensor_kernel_scan_innermost_dim``, is not counted.
"""

import re

from portbench import roofline

KERNELS = ("stream_kernel", "outer_kernel", "tiled_kernel", "tensor_kernel")
SYMBOL = re.compile(r"void fenix::(?:\(anonymous namespace\)::)?(?:%s)[<(]" % "|".join(KERNELS))
ROUTES = {"fp32": "f32", "bf16": "bf16", "int8": "int8"}


def read(run):
    if not run.device_events:
        return None
    kernel_s = sum(dur for name, cat, _, dur in run.device_events
                   if cat == "kernel" and SYMBOL.match(name)) / 1e6
    dispatches = run.counters.get("batch.dispatches", 0.0)
    if kernel_s <= 0 or not dispatches:
        return None
    q = run.counters["batch.queries"] / dispatches
    cfg = run.config
    least = roofline.bound(ROUTES[cfg["precision"]], q, cfg["rows"], cfg["dim"], run.k)["bound_s"]
    return 100.0 * dispatches * least / kernel_s
