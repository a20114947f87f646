"""stream.phase1_roofline (layer ``ops.kernels and csrc``): the share of
the fp32 phase-1 scan's roofline that the card reached over the window
on the streamed chunks, in %.

Numerator: the least time the window's scans need, per dispatch
``roofline.bound("f32", Q, N, D, k)``: the larger of their bytes at the
peak read rate and their 2·Q·N·D operations at the float32 peak, with Q
the mean queries per dispatch from the ``batch.*`` counters and N, D the
configuration's (the table's rows, not the chunks' padded ones).
Denominator: the device time of the fp32 kernels of
``fenix_tpu_torch/csrc/bucket_scores_stream.cu`` and
``bucket_scores_tiled.cu``, ``stream_kernel`` and ``tiled_kernel``, by
their whole demangled symbol (``void fenix::(anonymous
namespace)::tiled_kernel<float, 8, true>(...)``), as ``phase1_roofline``
matches its own: a library kernel whose name merely holds one of them is
not counted.
"""

import re

from portbench import roofline

SYMBOL = re.compile(r"void fenix::(?:\(anonymous namespace\)::)?(?:stream_kernel|tiled_kernel)[<(]")


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
    least = roofline.bound("f32", q, cfg["rows"], cfg["dim"], run.k)["bound_s"]
    return 100.0 * dispatches * least / kernel_s
