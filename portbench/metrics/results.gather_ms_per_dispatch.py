"""results.gather_ms_per_dispatch (layer ``engine.executor``): the host's
result rows per dispatch, gathering each member's winning rows from the
host table into its Arrow result (``results.gather_seconds``, the
``fenix.result_gather`` sites, / ``batch.dispatches`` over the window)."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "results.gather_seconds" not in c:
        return None
    return c["results.gather_seconds"] / dispatches * 1e3
