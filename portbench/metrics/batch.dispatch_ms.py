"""batch.dispatch_ms (layer ``engine.batching``): the dispatcher's wall
time per dispatch, from its group's snapshot to its members' result
tables (``batch.dispatch_seconds``, the port's ``batch.dispatch`` site,
/ ``batch.dispatches`` over the window)."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "batch.dispatch_seconds" not in c:
        return None
    return c["batch.dispatch_seconds"] / dispatches * 1e3
