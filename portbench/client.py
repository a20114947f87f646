"""One client process: closed-loop threads that search over the Flight
wire.

Started with ``spawn`` by the harness, it imports ``pyarrow.flight``,
numpy and :mod:`portbench.wire`, never torch. A thread waiting on gRPC
releases the interpreter lock, so a few processes carry several client
threads each. Each thread sends its next request when the last one has
returned, and times each on this host's monotonic clock
(``time.perf_counter``, the same clock in every process of the host).

Protocol over the pipe (every message a tuple, the tag first):

1. harness → ``("setup", {...})``: port, command, query pool, queries per
   request, k, warm-up seconds, window seconds, seed;
2. ← ``("warm", requests, failures)`` once every thread has warmed up;
3. harness → ``("go",)``: the window starts now, for ``seconds``;
4. ← ``("done", records)``: one row per request sent in the window;
5. harness → ``("fetch", [(thread, seq), ...])`` ← ``("results", [(ids, dists), ...])``;
6. harness → ``("bye",)``.

Which queries a request sends is drawn from ``(seed, client, thread)``
alone, with warm-up on a stream of its own: the same seed sends the
same window requests whatever the warm-up took.

The mix's ``loop`` says when a request is sent. ``closed``: each thread
sends its next request when the last one has returned. ``open``: the
process's threads take turns on one schedule of arrivals drawn from
``(seed, client)``, a Poisson process at ``rate`` requests/s shared
evenly by the processes, ``rate · burst.factor`` during the first
``burst.on_s`` seconds of every ``burst.period_s`` where the mix has a
``burst``; a request is timed from when it was due, so a late send
counts in its latency, and ``t_send`` is that due time.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any

import numpy as np

WINDOW, WARMUP, ARRIVALS = 0, 1, 2  # the request streams of a thread, and a process's arrivals
ROW_DTYPE = [("client", "i4"), ("thread", "i4"), ("seq", "i8"), ("offset", "i8"), ("t_send", "f8"),
             ("t_done", "f8"), ("ok", "?"), ("lag", "f8")]  # one window request; lag: sent after due


def offsets(seed: int, client: int, thread: int, stream: int, pool: int, q: int) -> np.random.Generator:
    """The generator of a thread's query offsets into the pool."""
    return np.random.default_rng([seed, client, thread, stream, pool, q])


def arrivals(seed: int, client: int, stream: int, mix: dict, processes: int, seconds: float) -> np.ndarray:
    """An open loop's due times (seconds from the start of the phase) for
    one client process: a Poisson process at the burst rate, thinned to
    the base rate outside the bursts."""
    rng = np.random.default_rng([seed, client, ARRIVALS, stream])
    burst = mix.get("burst")
    factor = float(burst["factor"]) if burst else 1.0
    if factor < 1.0:
        raise ValueError(f"a burst multiplies the rate by a factor of 1 or more, got {factor}")
    gap = processes / (mix["rate"] * factor)
    times = np.cumsum(rng.exponential(gap, int(seconds / gap * 1.5) + 64))
    while times[-1] < seconds:
        times = np.concatenate([times, times[-1] + np.cumsum(rng.exponential(gap, times.shape[0]))])
    times = times[times < seconds]
    if burst:
        inside = times % burst["period_s"] < burst["on_s"]
        times = times[inside | (rng.random(times.shape[0]) < 1.0 / factor)]
    return times


class _Schedule:
    """The arrivals of one phase, taken in turn by a process's threads."""

    def __init__(self, due: np.ndarray) -> None:
        self.due, self.next, self.base = due, 0, 0.0
        self.lock = threading.Lock()

    def take(self) -> "float | None":
        with self.lock:
            if self.next >= self.due.shape[0]:
                return None
            self.next += 1
            return self.base + float(self.due[self.next - 1])


class _Thread:
    def __init__(self, client: int, tid: int, setup: dict, go: threading.Event, warm: threading.Barrier,
                 schedules: "dict | None" = None):
        import pyarrow.flight as fl

        self.client, self.tid, self.setup = client, tid, setup
        self.conn = fl.connect(f"grpc://127.0.0.1:{setup['port']}")
        self.go, self.warm = go, warm
        self.schedules = schedules
        self.t_start = 0.0
        self.rows: list[tuple] = []  # (seq, offset, t_send, t_done, ok, lag)
        self.results: list[Any] = []  # the result table of each window request (None: failed)
        self.errors: list[str] = []
        self.warm_requests = 0
        self.warm_failures = 0
        self.thread = threading.Thread(target=self._run, name=f"portbench-client-{client}-{tid}", daemon=True)

    def _request(self, rng: np.random.Generator, due: "float | None" = None):
        from portbench import wire

        s = self.setup
        q, pool = s["q"], s["pool"]
        offset = int(rng.integers(0, pool.shape[0] - q + 1))
        target = wire.encode_target(pool[offset] if q == 1 else pool[offset : offset + q])
        if due is not None:
            time.sleep(max(0.0, due - time.perf_counter()))
        sent = time.perf_counter()
        t_send = sent if due is None else due
        try:
            result = wire.search(self.conn, s["command"], target)
            ok = True
        except Exception as exc:  # noqa: BLE001 — a failed request is counted, not fatal
            result, ok = None, False
            if len(self.errors) < 3:
                self.errors.append(f"{type(exc).__name__}: {exc}")
        return offset, t_send, time.perf_counter(), ok, result, sent - t_send

    def _run(self) -> None:
        s = self.setup
        pool_n, q = s["pool"].shape[0], s["q"]
        rng = offsets(s["seed"], self.client, self.tid, WARMUP, pool_n, q)
        if self.schedules is not None:
            while (due := self.schedules[WARMUP].take()) is not None:
                ok = self._request(rng, due)[3]
                self.warm_requests += 1
                self.warm_failures += not ok
        else:
            warm_end = time.perf_counter() + s["warmup_s"]
            while self.warm_requests < s["warmup_min"] or time.perf_counter() < warm_end:
                ok = self._request(rng)[3]
                self.warm_requests += 1
                self.warm_failures += not ok
        self.warm.wait()
        self.go.wait()
        rng = offsets(s["seed"], self.client, self.tid, WINDOW, pool_n, q)
        end = self.t_start + s["seconds"]
        seq = 0
        while True:
            if self.schedules is not None:
                due = self.schedules[WINDOW].take()
                if due is None:
                    break
            elif time.perf_counter() >= end:
                break
            else:
                due = None
            offset, t_send, t_done, ok, result, lag = self._request(rng, due)
            self.rows.append((seq, offset, t_send, t_done, ok, lag))
            self.results.append(result)
            seq += 1


def _expect(conn, tag: str):
    msg = conn.recv()
    if msg[0] != tag:
        raise RuntimeError(f"the harness sent {msg[0]!r}, expected {tag!r}")
    return msg[1] if len(msg) > 1 else None


def main(conn, client: int, threads: int, processes: int = 1) -> None:
    """Entry of a client process (``multiprocessing`` ``spawn`` target)."""
    try:
        setup = _expect(conn, "setup")
        mix = setup["mix"]
        schedules = None
        if mix["loop"] == "open":
            schedules = {
                WARMUP: _Schedule(arrivals(setup["seed"], client, WARMUP, mix, processes, setup["warmup_s"])),
                WINDOW: _Schedule(arrivals(setup["seed"], client, WINDOW, mix, processes, setup["seconds"])),
            }
        elif mix["loop"] != "closed":
            raise ValueError(f"unknown loop {mix['loop']!r}: closed or open")
        go = threading.Event()
        warm = threading.Barrier(threads + 1)
        workers = [_Thread(client, t, setup, go, warm, schedules) for t in range(threads)]
        if schedules is not None:
            schedules[WARMUP].base = time.perf_counter()
        for w in workers:
            w.thread.start()
        warm.wait()
        conn.send(("warm", sum(w.warm_requests for w in workers), sum(w.warm_failures for w in workers)))
        _expect(conn, "go")
        t_start = time.perf_counter()
        if schedules is not None:
            schedules[WINDOW].base = t_start
        for w in workers:
            w.t_start = t_start
        go.set()
        for w in workers:
            w.thread.join()
        records = {
            "client": client,
            "t_start": t_start,
            "errors": [e for w in workers for e in w.errors][:3],
            "rows": np.array(
                [(client, w.tid, *row) for w in workers for row in w.rows],
                dtype=ROW_DTYPE,
            ),
        }
        conn.send(("done", records))
        wanted = _expect(conn, "fetch")
        from portbench import wire

        out = []
        for tid, seq in wanted:
            out.append(wire.split_result(workers[tid].results[seq], setup["q"], setup["k"]))
        conn.send(("results", out))
        _expect(conn, "bye")
        for w in workers:
            w.conn.close()
    except EOFError:  # the harness went away: nothing to report to
        return
    except Exception:  # noqa: BLE001 — reported to the harness, which fails the run
        conn.send(("error", traceback.format_exc()))
