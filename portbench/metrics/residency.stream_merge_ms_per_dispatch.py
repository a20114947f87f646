"""residency.stream_merge_ms_per_dispatch (layer ``engine.residency``):
the host merge of the streamed chunks' candidates into each query's
top-k by (score, id) per dispatch (``residency.stream_merge_seconds``,
the ``residency.stream_merge`` site, / ``batch.dispatches`` over the
window)."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "residency.stream_merge_seconds" not in c:
        return None
    return c["residency.stream_merge_seconds"] / dispatches * 1e3
