"""device.idle_dispatching_share (layer: the device): the share of the
card's idle time, between its first and last operation in the traced
window, during which the port's dispatcher was inside ``batch.dispatch``
(or its completer inside ``batch.finish``): the card waiting for the
host's search path rather than for requests. The device events and the
port's spans are joined on one clock (``portbench/spans.py``). None when
the program records no spans, when any span was dropped in the window,
or when the clocks disagree (a ``fenix.fetch`` span ending before the
copy it waits for, by over 1 ms)."""

from portbench import spans


def read(run):
    if not run.device_events or run.counters.get("spans.dropped"):
        return None
    from fenix_tpu_torch.utils import profiling

    recorded = getattr(profiling, "spans", None)  # absent from a program without the span recorder
    if recorded is None:
        return None
    base = spans.trace_base_ns()
    first = min(s for s, _ in spans.intervals(run.device_events, base))
    # from the card's first operation on: the last batch's fetch may start
    # after the card's last operation has ended
    return spans.idle_dispatching_share(run.device_events, recorded(first, None), base)
