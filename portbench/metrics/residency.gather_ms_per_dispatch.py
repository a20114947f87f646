"""residency.gather_ms_per_dispatch (layer ``engine.residency``): the
host rescore's row gathers per dispatch, the candidate rows of each
query's window read from the host's fp32 column
(``residency.rescore_gather_seconds``, the ``residency.gather`` sites,
/ ``batch.dispatches`` over the window)."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "residency.rescore_gather_seconds" not in c:
        return None
    return c["residency.rescore_gather_seconds"] / dispatches * 1e3
