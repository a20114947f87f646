"""stream.stage_ms_per_dispatch (layer ``io.batch``): the host's memcpy of
the streamed chunks into their pinned staging buffers, on the prefetch
worker, per dispatch (``transfer.stage_seconds``, the ``transfer.stage``
sites, / ``batch.dispatches`` over the window). Only a card's path
stages: a CPU device takes the host rows as they are, so a run without a
card has nothing to read."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "transfer.stage_seconds" not in c:
        return None
    return c["transfer.stage_seconds"] / dispatches * 1e3
