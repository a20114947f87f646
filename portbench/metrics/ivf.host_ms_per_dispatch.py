"""ivf.host_ms_per_dispatch (layer ``engine.executor``, IVF route): the
host's cell ranking, clustered layouts' metadata and route decision
(``ivf.rank_seconds`` + ``ivf.route_seconds``) per dispatch, over the
window."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "ivf.rank_seconds" not in c:
        return None
    return (c["ivf.rank_seconds"] + c.get("ivf.route_seconds", 0.0)) / dispatches * 1e3
