"""batch.queue_wait_ms (layer ``engine.batching``): a request's mean wait
in the batch queue, from its enqueue until a drain takes it
(``batch.queue_wait_seconds`` / ``batch.requests`` over the window)."""


def read(run):
    c = run.counters
    requests = c.get("batch.requests", 0.0)
    if not requests or "batch.queue_wait_seconds" not in c:
        return None
    return c["batch.queue_wait_seconds"] / requests * 1e3
