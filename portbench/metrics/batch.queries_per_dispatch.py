"""batch.queries_per_dispatch (layer ``engine.batching``): queries per
coalesced device search, ``batch.queries`` / ``batch.dispatches`` over
the window."""


def read(run):
    dispatches = run.counters.get("batch.dispatches", 0.0)
    return run.counters.get("batch.queries", 0.0) / dispatches if dispatches else None
