"""One run of one cell: set-up, the measured window, the check, the line.

1. Make the cell's corpus and query pool on the device from the seed,
   and write the corpus once into a catalog root under ``TMPDIR`` with
   the port's catalog writer (``fenix_tpu_torch.io.table.make``): one
   table, ``id`` (int64), ``vector`` (fixed-size list of float32) and
   ``tag`` (int32).
2. Start the port's Flight ``Server`` in this process on a free port of
   127.0.0.1, with its default device budget; build the cell's index over
   the wire (``make-coder`` from the seed, ``make-index``) where the
   configuration has one; send one cold request.
3. Warm up: the clients (``spawn``-ed processes, ``portbench/client.py``)
   run the cell's own traffic for the mix's warm-up seconds.
4. Measure for ``--seconds``: closed-loop clients on the Flight wire,
   the server's counters read as deltas over the window; with
   ``--trace 1`` one ``torch.profiler`` capture of the device over the
   same window.
5. Judge a sample of the window's answers, drawn from the seed, against
   the float64 reference (``portbench/reference.py``), once the server is
   down and its device state freed.
6. Print the bytes written, the numbers compared beside their limits
   (the last lines of standard error), and the result line (the last
   line of standard output).

``setup_s`` runs from the start of this process to the first timed
request. ``qps`` counts the queries of the requests sent in the window
over the time from its start to the last answer; ``p95_ms`` is the tail
of every request sent in it.
"""

from __future__ import annotations

import gc
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, TextIO

import numpy as np

from portbench import client as client_mod
from portbench import spec as spec_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "fenix_tpu")  # top-level module names, compared whole
TABLE = "bench/items"
COLUMN = "vector"
INDEX = "bench/ivf"
CLIENT_GRACE_S = 180  # longest wait for the clients past the window
SLICE_S = 5.0  # seconds a diagnostic slice of the window spans
COUNTERS_BY_SLICE = ("batch.dispatches", "batch.queries", "search.ivf_clustered", "search.ivf_scan",
                     "ivf.rank_seconds", "ivf.route_seconds", "search.seconds")
BATCH_ROWS = 1 << 16  # rows per record batch of the written table


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])  # field 22, starttime
    since_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
    now = time.perf_counter()
    return now - (since_boot - start_ticks / os.sysconf("SC_CLK_TCK"))


def io_counters() -> dict[str, int]:
    """This process's bytes written, as ``/proc/self/io`` counts them."""
    out = {}
    with open("/proc/self/io") as fh:
        for line in fh:
            key, _, value = line.partition(":")
            out[key.strip()] = int(value)
    return {"write_bytes": out.get("write_bytes", 0), "wchar": out.get("wchar", 0)}


def forbidden_modules() -> list[str]:
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Clients:
    """The client processes and their pipes."""

    def __init__(self, processes: int, threads: int, cpus: "list[int] | None" = None) -> None:
        ctx = multiprocessing.get_context("spawn")
        self.pipes, self.procs = [], []
        for c in range(processes):
            mine, theirs = ctx.Pipe()
            proc = ctx.Process(target=client_mod.main, args=(theirs, c, threads, processes),
                               name=f"portbench-client-{c}")
            proc.start()
            if cpus:
                os.sched_setaffinity(proc.pid, cpus)
            theirs.close()
            self.pipes.append(mine)
            self.procs.append(proc)

    def send(self, msgs: list) -> None:
        for pipe, msg in zip(self.pipes, msgs):
            pipe.send(msg)

    def send_all(self, msg) -> None:
        self.send([msg] * len(self.pipes))

    def recv_all(self, tag: str, timeout: float) -> list:
        out = []
        deadline = time.monotonic() + timeout
        for pipe in self.pipes:
            if not pipe.poll(max(0.0, deadline - time.monotonic())):
                raise TimeoutError(f"a client sent no {tag!r} in {timeout:.0f} s")
            got = pipe.recv()
            if got[0] == "error":
                raise RuntimeError(f"a client failed:\n{got[1]}")
            if got[0] != tag:
                raise RuntimeError(f"a client sent {got[0]!r}, expected {tag!r}")
            out.append(got[1:])
        return out

    def close(self) -> None:
        for pipe in self.pipes:
            try:
                pipe.send(("bye",))
            except (BrokenPipeError, OSError):
                pass
        for proc in self.procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
        for pipe in self.pipes:
            pipe.close()


def power_limit_w() -> "float | None":
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def write_table(root: str, vectors, tags) -> None:
    """The corpus into the catalog: one table, in record batches of
    ``BATCH_ROWS`` rows (a bulk load's batches), with the port's writer."""
    import pyarrow as pa

    from fenix_tpu_torch.io import table as table_mod

    n, d = vectors.shape
    host_v = vectors.cpu().numpy()
    host_t = tags.cpu().numpy()
    ids = np.arange(n, dtype=np.int64)
    schema = pa.schema({"id": pa.int64(), COLUMN: pa.list_(pa.float32(), d), "tag": pa.int32()})

    def batches():
        for s in range(0, n, BATCH_ROWS):
            flat = pa.array(host_v[s : s + BATCH_ROWS].reshape(-1), type=pa.float32())
            yield pa.record_batch(
                [pa.array(ids[s : s + BATCH_ROWS]), pa.FixedSizeListArray.from_arrays(flat, list_size=d),
                 pa.array(host_t[s : s + BATCH_ROWS])],
                schema=schema,
            )

    table_mod.make(root, TABLE, pa.RecordBatchReader.from_batches(schema, batches()))


def read_index(root: str) -> tuple[np.ndarray, np.ndarray]:
    """The port's coder's centroids ``[C, D]`` and its index's row cells
    ``[N]``, read from the catalog's files (set-up's outputs, which the
    check judges): ``codings/<name>.npz`` and ``indexes/<table>/<column>/<name>.arrow``."""
    import pyarrow as pa

    with np.load(os.path.join(root, "codings", INDEX + ".npz"), allow_pickle=False) as blob:
        codebooks = blob["codebooks"]
    if codebooks.shape[0] != 1:
        raise ValueError("the reference judges single-codebook coders")
    with pa.memory_map(os.path.join(root, "indexes", TABLE, COLUMN, INDEX + ".arrow"), "rb") as src:
        cells = pa.ipc.open_stream(src).read_all().column("__CODED_ID__").to_numpy()
    return codebooks[0], cells


def _cpu_s(pid: int) -> float:
    """CPU seconds (user and system, every thread) of process ``pid``."""
    with open(f"/proc/{pid}/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")  # fields 14 and 15


class Slices:
    """Diagnostics of the window in ``SLICE_S``-second slices, for the
    run's line: the server's counter deltas (dispatches, queries, each IVF
    route, IVF host seconds), the CPU seconds of this process and of the
    client processes, and this process's seconds in the garbage collector.
    A thread takes a snapshot at each slice's end."""

    def __init__(self, metrics, client_pids: list[int]) -> None:
        self.metrics, self.pids = metrics, client_pids
        self.points: list[tuple] = []
        self.gc_s, self._gc_start = 0.0, None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="portbench-slices", daemon=True)

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.perf_counter()
        elif self._gc_start is not None:
            self.gc_s += time.perf_counter() - self._gc_start
            self._gc_start = None

    def _point(self) -> None:
        self.points.append((time.perf_counter(), self.metrics.snapshot(), time.process_time(),
                            sum(_cpu_s(p) for p in self.pids), self.gc_s))

    def _loop(self) -> None:
        while not self._stop.wait(SLICE_S):
            self._point()

    def __enter__(self) -> "Slices":
        gc.callbacks.append(self._gc)
        self._point()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self._point()
        gc.callbacks.remove(self._gc)

    def table(self) -> list[dict]:
        out = []
        for (t0, c0, cpu0, cl0, gc0), (t1, c1, cpu1, cl1, gc1) in zip(self.points, self.points[1:]):
            d = {n: c1.get(n, 0.0) - c0.get(n, 0.0) for n in COUNTERS_BY_SLICE}
            out.append({"s": t1 - t0, **d, "server_cpu_s": cpu1 - cpu0, "clients_cpu_s": cl1 - cl0,
                        "gc_s": gc1 - gc0})
        return out


def sample(rows: np.ndarray, seed: int, q: int, check_queries: int) -> np.ndarray:
    """Positions of the answered window requests the check reads: drawn
    from the seed, the slowest among them, ``check_queries`` queries in
    all (or every request)."""
    ok = np.flatnonzero(rows["ok"])
    want = min(len(ok), max(1, math.ceil(check_queries / q)))
    if want == 0:
        return ok
    slowest = ok[np.argmax(rows["t_done"][ok] - rows["t_send"][ok])]
    rest = np.random.default_rng([seed, 0x5EED]).permutation(ok[ok != slowest])[: want - 1]
    return np.sort(np.concatenate([[slowest], rest]))


def run(
    workload: str,
    seed: int,
    seconds: float,
    trace: bool,
    root: "str | Path" = spec_mod.ROOT,
    device: "str | None" = None,
    out: TextIO = sys.stdout,
    err: TextIO = sys.stderr,
    client_cpus: "list[int] | None" = None,
) -> int:
    """Run ``workload`` once; returns the exit code. ``device=None`` asks
    for the cards the cell names (and fails without them); a test passes
    ``"cpu"`` to drive the rest of a run through the kernels' plain twins.
    ``client_cpus``: the CPUs the client processes run on (``run.py``
    keeps this process off them)."""
    t_proc = process_start()
    spec = spec_mod.Spec(root)
    cell = spec.workload(workload)

    import torch

    import fenix_tpu_torch  # the system under test

    if not Path(fenix_tpu_torch.__file__).resolve().is_relative_to(Path(root).resolve()) and device is None:
        print(f"portbench: fenix_tpu_torch comes from {fenix_tpu_torch.__file__}, not from this checkout", file=err)
        return 5
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"portbench: {workload} needs {cell['chips']} CUDA card(s), this machine has {have}", file=err)
            return 3
        device = "cuda"
    traffic = spec.traffic(cell["traffic"])
    clients = Clients(traffic["processes"], traffic["threads"], client_cpus)  # their start overlaps set-up
    catalog = tempfile.mkdtemp(prefix="portbench-")  # under TMPDIR
    try:
        bench = _Run(spec, cell, traffic, seed, seconds, trace, device, catalog)
        bench.serve(clients)
        bench.check()
        found = forbidden_modules()
        if found:
            print(f"portbench: {', '.join(found)} loaded in the process that measured", file=err)
            return 4
        bench.report(t_proc, out, err)
        return 0
    finally:
        clients.close()
        shutil.rmtree(catalog, ignore_errors=True)


class _Run:
    """The state of one run, step by step."""

    def __init__(self, spec, cell, traffic, seed, seconds, trace, device, catalog) -> None:
        import torch

        self.spec, self.cell, self.traffic = spec, cell, traffic
        self.cfg = spec.config(cell["config"])
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.catalog = device, catalog
        self.on_card = torch.device(device).type == "cuda"
        self.q, self.k = traffic["queries_per_request"], traffic["k"]
        self.probes = traffic.get("probes")
        self.metric = traffic.get("metric") or self.cfg["metric"]

    # -- steps 1-4 --------------------------------------------------------

    def serve(self, clients: Clients) -> None:
        import pyarrow.flight as fl
        import torch

        from portbench import data, wire

        cfg, traffic, q = self.cfg, self.traffic, self.q
        marks = [("start", time.perf_counter())]
        vectors, tags = data.corpus(cfg, self.seed, self.device)
        self.pool = data.queries(cfg, traffic["pool_queries"], self.seed, self.device)
        marks.append(("data", time.perf_counter()))
        write_table(self.catalog, vectors, tags)
        del vectors, tags
        if self.on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        marks.append(("write", time.perf_counter()))

        from fenix_tpu_torch.engine import executor
        from fenix_tpu_torch.flight import Server
        from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

        server = Server(self.catalog, host="127.0.0.1", port=0, device=self.device)
        try:
            conn = fl.connect(f"grpc://127.0.0.1:{server.port}")
            if cfg.get("index"):
                wire.make_index(conn, INDEX, TABLE, COLUMN, cfg["index"], self.seed)
            marks.append(("server_index", time.perf_counter()))
            command = wire.search_command(
                TABLE, COLUMN, traffic.get("metric"), traffic["select"], traffic.get("filter"), self.k,
                self.probes, INDEX if self.probes else None, cfg["precision"], cfg["residency"],
            )
            wire.search(conn, command, wire.encode_target(self.pool[0] if q == 1 else self.pool[:q]))  # cold
            conn.close()
            marks.append(("cold_request", time.perf_counter()))

            clients.send_all(("setup", {
                "port": server.port, "command": command, "pool": self.pool, "q": q, "k": self.k,
                "seed": self.seed, "mix": traffic, "warmup_s": traffic["warmup_seconds"],
                "warmup_min": traffic["warmup_min_requests"], "seconds": self.seconds,
            }))
            self.warm = clients.recv_all("warm", CLIENT_GRACE_S + traffic["warmup_seconds"])
            marks.append(("warmup", time.perf_counter()))
            self.setup_phases = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
            self.t_setup = marks[0][1]  # set-up's own steps start here

            before = METRICS.snapshot()
            prof = None
            if self.trace and self.on_card:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t_trace = time.perf_counter()
            with Slices(METRICS, [p.pid for p in clients.procs]) as slices:
                clients.send_all(("go",))
                done = [d[0] for d in clients.recv_all("done", self.seconds + CLIENT_GRACE_S)]
            self.slices = slices.table()
            if prof is not None:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
            self.trace_window_s = time.perf_counter() - t_trace
            after = METRICS.snapshot()
            self.counters = {n: after.get(n, 0.0) - before.get(n, 0.0) for n in set(after) | set(before)}
            self.peak = int(torch.cuda.max_memory_allocated()) if self.on_card else 0
            self.events = None
            if prof is not None:
                from portbench import devtrace

                path = os.path.join(self.catalog, "window.pt.trace.json")
                prof.export_chrome_trace(path)
                self.events = devtrace.device_events(path)
                os.unlink(path)

            self.rows = np.concatenate([d["rows"] for d in done])
            self.errors = [e for d in done for e in d["errors"]]
            self.t0 = min(d["t_start"] for d in done)
            self.picked = sample(self.rows, self.seed, q, traffic["check_queries"])
            wanted = [[] for _ in done]
            for i in self.picked:
                wanted[self.rows["client"][i]].append((int(self.rows["thread"][i]), int(self.rows["seq"][i])))
            clients.send([("fetch", w) for w in wanted])
            fetched = [r[0] for r in clients.recv_all("results", CLIENT_GRACE_S)]
            got = {(c, *key): value for c, (w, res) in enumerate(zip(wanted, fetched)) for key, value in zip(w, res)}
            answers = [got[(int(r["client"]), int(r["thread"]), int(r["seq"]))] for r in self.rows[self.picked]]
            self.ids = np.concatenate([a[0] for a in answers]) if answers else np.zeros((0, self.k), np.int64)
            self.dists = np.concatenate([a[1] for a in answers]) if answers else np.zeros((0, self.k))
            self.sample_queries = np.concatenate(
                [self.pool[o : o + q] for o in self.rows["offset"][self.picked]]
            ) if answers else np.zeros((0, cfg["dim"]), np.float32)
        finally:
            server.shutdown()
        executor.get_cache(self.catalog, self.device).invalidate()  # its device state, freed for the reference
        if self.on_card:
            torch.cuda.empty_cache()

    # -- step 5 -----------------------------------------------------------

    def check(self) -> None:
        import torch

        from portbench import data, reference

        numbers: dict[str, float] = {"failed": int((~self.rows["ok"]).sum())}
        vectors, tags = data.corpus(self.cfg, self.seed, self.device)
        oracle = reference.Oracle(vectors, self.device)
        del vectors
        keep = reference.filter_mask(self.traffic.get("filter"), {"tag": tags})
        strict = loose = keep
        if self.probes:
            index = self.cfg["index"]
            ivf = reference.ReferenceIVF(oracle, index["codebook_size"], index["metric"], self.seed,
                                         self.sample_queries, self.metric, self.k, self.probes, keep)
            centroids, cells = read_index(self.catalog)
            centroids = torch.from_numpy(centroids).to(self.device)
            cells = torch.from_numpy(np.array(cells)).to(self.device)
            numbers.update(ivf.judge(centroids, cells, self.ids))
            sure, maybe = reference.probe_sets(self.sample_queries, centroids, self.metric, self.probes)
            cells = cells.clamp(0, centroids.shape[0] - 1)  # an index out of range has failed assign_gap
            strict, loose = reference.probed_rows(sure, cells, keep), reference.probed_rows(maybe, cells, keep)
        numbers.update(reference.judge(oracle, self.sample_queries, self.ids, self.dists, self.metric, strict, loose))
        self.numbers = numbers
        self.limits = self.cfg["limits"]
        self.correct = len(self.picked) > 0 and reference.verdict(numbers, self.limits)

    # -- step 6 -----------------------------------------------------------

    def report(self, t_proc: float, out: TextIO, err: TextIO) -> None:
        import torch

        rows = self.rows
        ok = rows["ok"]
        view = SimpleNamespace(
            cell=self.cell, config=self.cfg, traffic=self.traffic, q=self.q, k=self.k,
            setup_s=self.t0 - t_proc,
            window_s=float(rows["t_done"].max() - self.t0) if len(rows) else float(self.seconds),
            attempted=int(len(rows)), failed=int((~ok).sum()),
            latencies_s=rows["t_done"] - rows["t_send"],  # every request sent in the window
            lags_s=rows["lag"],  # open loop: how late each request was sent
            queries_answered=int(ok.sum()) * self.q,
            counters=self.counters, device_events=self.events, trace_window_s=self.trace_window_s,
        )
        metrics = {}
        for m in self.spec.metrics(self.cell["name"], self.trace):
            value = self.spec.reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line: dict[str, Any] = {
            "correct": self.correct,
            "attempted": view.attempted,
            "failed": view.failed,
            "metrics": metrics,
            "device": {
                "platform": "gpu" if self.on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if self.on_card else "cpu",
                "count": self.cell["chips"],
                "memory_peak_bytes": self.peak,
            },
        }
        if self.events is not None:
            from portbench import devtrace

            summary = devtrace.summary(self.events)
            line["device"]["busy_s"] = summary["busy_s"]
            line["device"]["window_s"] = self.trace_window_s
            line["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
        written = io_counters()
        line["run"] = {
            "seed": self.seed, "seconds": self.seconds, "trace": int(self.trace),
            "server_cpus": len(os.sched_getaffinity(0)), "client_cpus": self.traffic.get("client_cpus", 0),
            "power_limit_w": power_limit_w() if self.on_card else None,
            "warm_requests": int(sum(w[0] for w in self.warm)), "warm_failed": int(sum(w[1] for w in self.warm)),
            "checked_queries": int(self.sample_queries.shape[0]), "bytes_written": written,
            "setup_phases_s": {"start": self.t_setup - t_proc, **self.setup_phases},
            "slices_5s": self.slices,
            "counters": {n: v for n, v in sorted(self.counters.items()) if v},
            "errors": self.errors[:3],
        }
        line["run"]["readings"] = {n: v for n, v in self.numbers.items() if n not in self.limits}
        line["checks"] = {n: {"value": self.numbers[n], "limit": lim} for n, lim in self.limits.items()}
        print(json.dumps({"bytes_written": written}), file=out, flush=True)
        for n, lim in self.limits.items():
            print(f"check {n} = {self.numbers[n]!r} (limit {lim!r})", file=err)
        print(f"correct = {self.correct}", file=err, flush=True)
        print(json.dumps(line), file=out, flush=True)
