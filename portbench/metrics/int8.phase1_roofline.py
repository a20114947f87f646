"""int8.phase1_roofline (layer ``ops.kernels and csrc``): the share of
the int8 phase-1 scan's roofline (K2, ``tensor_int8`` or
``generic_int8``) that the card reached over the window, in %.

Numerator: the least time the window's int8 scans need, per dispatch
``roofline.bound("int8", Q, N, D, k)``: the larger of their bytes at the
peak read rate and their 2·Q·N·D operations at the int8 peak, with Q the
mean queries per dispatch from the ``batch.*`` counters and N, D the
configuration's. Denominator: the device time of the kernels of
``fenix_tpu_torch/csrc/bucket_scores_tensor.cu``, ``tensor_kernel``,
by their whole demangled symbol (``void fenix::(anonymous
namespace)::tensor_kernel<...>(...)``), as ``phase1_roofline`` matches
its own: a library kernel whose name merely holds it, as PyTorch's
``at::native::tensor_kernel_scan_innermost_dim``, is not counted.
"""

import re

from portbench import roofline

SYMBOL = re.compile(r"void fenix::(?:\(anonymous namespace\)::)?tensor_kernel[<(]")


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
    least = roofline.bound("int8", q, cfg["rows"], cfg["dim"], run.k)["bound_s"]
    return 100.0 * dispatches * least / kernel_s
