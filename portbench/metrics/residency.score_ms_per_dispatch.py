"""residency.score_ms_per_dispatch (layer ``engine.residency``): the
host rescore's work past its gathers per dispatch: the exact fp32 scores
of the gathered rows, their (distance, id) order and the distances
(``residency.rescore_score_seconds``: ``residency.rescore_seconds`` less
the gathers, / ``batch.dispatches`` over the window)."""


def read(run):
    c = run.counters
    dispatches = c.get("batch.dispatches", 0.0)
    if not dispatches or "residency.rescore_score_seconds" not in c:
        return None
    return c["residency.rescore_score_seconds"] / dispatches * 1e3
