"""residency.phase_a_device_ms_per_dispatch (layer ``ops.topk2``): the
card's time in the int8-resident phase A (the K2 bucket maxima, the
bucket selection, the narrowing rescore) per dispatch, from a pair of
CUDA events around ``topk2.topk_window_int8`` that the port reads once
the window's copy to the host has synchronised
(``residency.phase_a_device_seconds`` / ``batch.dispatches`` over the
window; on a card, while a capture is active)."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "residency.phase_a_device_seconds" not in c:
        return None
    return c["residency.phase_a_device_seconds"] / dispatches * 1e3
