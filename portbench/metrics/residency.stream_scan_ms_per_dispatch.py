"""residency.stream_scan_ms_per_dispatch (layer ``engine.residency``): the
host's wall time of the streamed chunks' searches per dispatch, each
from its chunk on the card to its candidates on the host (the chunk's
aux, the exact two-phase search and the copy back;
``residency.stream_scan_seconds``, the ``residency.stream_scan`` sites,
/ ``batch.dispatches`` over the window). The wait for a chunk's upload
is ``transfer.wait``'s, outside it."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "residency.stream_scan_seconds" not in c:
        return None
    return c["residency.stream_scan_seconds"] / dispatches * 1e3
