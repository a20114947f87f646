"""dispatcher.on_cpu_share (layer ``engine.batching``): the dispatcher
thread's own CPU seconds over its wall seconds within dispatches, both
less its ``fenix.fetch`` waits for the card
(``batch.dispatch_cpu_seconds`` / ``batch.dispatch_host_seconds`` over
the window). Below 1 the thread was off the CPU while it had host work:
waiting for the interpreter lock, a lock of its own or the scheduler.
The BLAS pool's threads are not counted."""


def read(run):
    c = run.counters
    host = c.get("batch.dispatch_host_seconds", 0.0)
    if host <= 0 or "batch.dispatch_cpu_seconds" not in c:
        return None
    return c["batch.dispatch_cpu_seconds"] / host
