"""phase2.device_ms_per_dispatch (layer ``ops.topk2``): the card's time in
phase 2 (the bucket selection, the gather and the exact rescore) per
dispatch, from a pair of CUDA events around it that the port reads once
its fetch has synchronised (``phase2.device_seconds`` /
``batch.dispatches`` over the window; on a card, while a capture is
active)."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "phase2.device_seconds" not in c:
        return None
    return c["phase2.device_seconds"] / dispatches * 1e3
