"""residency.phase_a_ms_per_dispatch (layer ``engine.residency``): the
host's wall time of the int8-resident phase A per dispatch, from the
queries' upload to the window's copy to the host
(``residency.phase_a_seconds`` / ``batch.dispatches`` over the
window)."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "residency.phase_a_seconds" not in c:
        return None
    return c["residency.phase_a_seconds"] / dispatches * 1e3
