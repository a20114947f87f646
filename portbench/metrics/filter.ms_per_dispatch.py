"""filter.ms_per_dispatch (layer ``engine.executor``, filter route): the
host side of a filter (``filter.seconds``) per dispatch, over the
window."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "filter.seconds" not in c:
        return None
    return c["filter.seconds"] / dispatches * 1e3
