"""device.idle_share (layer: the device): 1 - (the union of the card's
kernel, copy and memset intervals) / the traced window."""

from portbench import devtrace


def read(run):
    if not run.device_events or run.trace_window_s <= 0:
        return None
    return 1.0 - devtrace.summary(run.device_events)["busy_s"] / run.trace_window_s
