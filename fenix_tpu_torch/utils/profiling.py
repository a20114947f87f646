"""Profiling hooks: ``torch.profiler`` traces and the port's span
recorder — port of ``fenix_tpu/utils/profiling.py``.

``trace`` captures the enclosed block into a Chrome trace (viewable in
Perfetto or ``chrome://tracing``) when a directory is given or
``$FENIX_TRACE_DIR`` is set, else does nothing, so call sites wrap hot
paths unconditionally.

``annotate`` marks a stage of the search path. It records a span on any
thread while a ``torch.profiler`` capture is active anywhere in the
process (this module's ``trace``, or any other, such as a benchmark's
window): torch's own profiler records the CPU spans of the thread that
started it alone, and a search crosses the Flight handler, the batch
dispatcher and the completer. On the thread that holds the capture it
is a ``record_function`` as well. With no capture active a site is one
attribute read and a shared no-op context, unless it has a counter or
is a wait: those few sites (the Flight decode and encode, a dispatch,
the fetch, the result gather) are timed always, and their counters
count like ``filter.seconds``.

A span holds its name, the native thread id and name, its id and its
parent's id (the innermost recorded span open on its thread), its start
and end on ``time.time_ns()`` (the clock of a Chrome trace's
``baseTimeNanoseconds + ts``, so spans line up with the card's kernels
and copies), the thread's CPU ns over it (``time.thread_time_ns()``),
the ns and CPU ns of the ``wait`` spans nested in it, and its links (the
request ids it serves). Spans are kept in memory, the newest
``MAX_SPANS``; one pushed out is counted as ``spans.dropped``.
:func:`spans` returns an interval's, and ``trace`` writes its capture's
spans of other threads into the file it exports.

The spans by layer: ``fenix.rpc.search`` (the Flight handler, with its
request id), ``flight.decode``, ``flight.encode``; ``batch.wait`` (a
handler waiting for its batch), ``batch.idle`` and ``batch.dispatch`` (the
dispatcher), ``batch.finish`` (the completer), ``search.solo`` (a search
run on its handler's thread); ``fenix.snapshot``, ``executor.prepare``,
``fenix.mask_build``, ``fenix.rank_cells``, ``ivf.route``,
``executor.launch``, ``fenix.fetch`` (the wait for the card) and
``fenix.result_gather``; past the device budget ``executor.host_corpus``
⊃ ``residency.int8`` ⊃ ``residency.phase_a``, ``residency.rescore`` ⊃
``residency.score`` and, for l2, ``residency.gather``, or
``residency.stream`` ⊃ ``transfer.wait``, ``residency.stream_scan`` and
``residency.stream_merge`` (``engine/residency.py``), with
``transfer.stage`` on the prefetch worker (``io/batch.py``).
:func:`device_timer` times a stretch of the card's work with a pair of
CUDA events (phase 2 of ``ops/topk2``, the int8-resident phase A, a
streamed chunk's search), read after the fetch has synchronised
(:func:`device_timings`, :func:`settle`).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Iterator

import torch
import torch.autograd.profiler as _torch_profiler

from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

TRACE_DIR_ENV = "FENIX_TRACE_DIR"
MAX_SPANS = 1 << 19  # spans kept in memory, the newest

# one trace at a time: the Flight server wraps every request handler in
# trace(), and handlers run on a thread pool. Non-blocking: a request that
# arrives during an active capture runs untraced (its kernels and spans
# still land in the active trace).
_TRACE_LOCK = threading.Lock()
_LOCAL = threading.local()
_SEQ = itertools.count()
_IDS = itertools.count(1)
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether the calling thread holds the active capture of ``trace``."""
    return getattr(_LOCAL, "active", False)


class Span:
    """One span site's entry: recorded while a capture is active, else
    only timed for its counters and waits (see the module docstring)."""

    __slots__ = ("name", "tid", "thread", "id", "parent", "start_ns", "end_ns", "cpu_ns", "wait_ns",
                 "wait_cpu_ns", "links", "in_torch", "_counter", "_cpu", "_wait", "_record", "_cpu0", "_rf")

    def __init__(self, name: str, counter: "str | None", cpu: bool, wait: bool, links: dict, record: bool) -> None:
        self.name, self.links, self._record = name, links, record
        self._counter, self._cpu, self._wait = counter, cpu, wait
        self.wait_ns = self.wait_cpu_ns = self.cpu_ns = 0
        self.in_torch, self._rf = False, None

    def __enter__(self) -> "Span":
        local = _LOCAL
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.tid, local.thread = threading.get_native_id(), threading.current_thread().name
        if self._record:
            self.tid, self.thread = local.tid, local.thread
            self.parent = next((s.id for s in reversed(stack) if s._record), None)
            self.id = next(_IDS)
            self.in_torch = torch.autograd._profiler_enabled()  # this thread holds the capture
            if self.in_torch:
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        stack.append(self)
        self._cpu0 = time.thread_time_ns() if self._record or self._cpu or self._wait else 0
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        if self._record or self._cpu or self._wait:
            self.cpu_ns = time.thread_time_ns() - self._cpu0
        stack = _LOCAL.stack
        stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self._wait:
            for outer in stack:
                outer.wait_ns += self.end_ns - self.start_ns
                outer.wait_cpu_ns += self.cpu_ns
        if self._counter is not None:
            METRICS.add(f"{self._counter}_seconds", self.seconds)
            if self._cpu:
                METRICS.add(f"{self._counter}_host_seconds", self.host_seconds)
                METRICS.add(f"{self._counter}_cpu_seconds", self.cpu_seconds)
        if self._record:
            _STORE.add(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def host_seconds(self) -> float:
        """Wall seconds less the ``wait`` spans nested in it."""
        return (self.end_ns - self.start_ns - self.wait_ns) / 1e9

    @property
    def cpu_seconds(self) -> float:
        """This thread's CPU seconds over the span, less its ``wait`` spans'."""
        return (self.cpu_ns - self.wait_cpu_ns) / 1e9


class _Store:
    """The newest ``MAX_SPANS`` spans; one pushed out moves ``spans.dropped``.
    No lock: a deque's ``append`` and ``list`` of it are atomic under the
    interpreter lock, and a lock taken at every span by every handler
    thread would queue them behind one another."""

    def __init__(self) -> None:
        self._spans: deque[Span] = deque(maxlen=MAX_SPANS)

    def add(self, span: Span) -> None:
        if len(self._spans) == self._spans.maxlen:
            METRICS.add("spans.dropped")
        self._spans.append(span)

    def between(self, t0_ns: "int | None", t1_ns: "int | None") -> list[Span]:
        kept = list(self._spans)
        lo = -1 if t0_ns is None else t0_ns
        hi = float("inf") if t1_ns is None else t1_ns
        return [s for s in kept if s.end_ns >= lo and s.start_ns <= hi]


_STORE = _Store()


def annotate(name: str, counter: "str | None" = None, cpu: bool = False, wait: bool = False, **links: Any):
    """A span named ``name``, recorded while a capture is active.
    ``counter``: the span adds its wall seconds to ``<counter>_seconds``
    of ``utils/metrics.GLOBAL`` and, with ``cpu``, its wall and its
    thread's CPU seconds less its waits to ``<counter>_host_seconds`` and
    ``<counter>_cpu_seconds``; ``wait``: the span waits (for the card), so
    the spans it nests in count it apart; ``links``: the request ids it
    serves (``requests=(id, ...)``). A site with a counter or a wait is
    timed with no capture too; any other is then a shared no-op."""
    if _torch_profiler._is_profiler_enabled:  # a capture is active somewhere in the process
        return Span(name, counter, cpu, wait, links, True)
    if counter is None and not wait:
        return _OFF
    return Span(name, counter, cpu, wait, links, False)


def spans(t0_ns: "int | None" = None, t1_ns: "int | None" = None) -> list[Span]:
    """The kept spans that overlap ``[t0_ns, t1_ns]`` (unix ns), oldest
    ended first."""
    return _STORE.between(t0_ns, t1_ns)


def _write_spans(path: str, kept: list[Span]) -> None:
    """Add ``kept`` (less those torch recorded itself) to the Chrome trace
    at ``path`` as ``X`` events on their own threads."""
    with open(path) as fh:
        doc = json.load(fh)
    base = doc["baseTimeNanoseconds"]
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    named = set()
    for s in kept:
        if s.in_torch:
            continue
        if s.tid not in named:
            named.add(s.tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": s.tid, "args": {"name": s.thread}})
        events.append({
            "ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid, "tid": s.tid,
            "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"span": s.id, "parent": s.parent, "cpu_us": s.cpu_ns / 1e3,
                     **{k: list(v) if isinstance(v, (tuple, list)) else v for k, v in s.links.items()}},
        })
    with open(path, "w") as fh:
        json.dump(doc, fh)


@contextlib.contextmanager
def trace(log_dir: str | None = None, cuda: bool | None = None) -> Iterator[None]:
    """Capture the enclosed block into
    ``<log_dir>/fenix-<pid>-<n>.pt.trace.json``: CPU activity, CUDA
    kernels and copies when ``cuda`` (default: when a card is present),
    and the spans every thread recorded meanwhile. A no-op without a
    directory, and while another capture of this function is active."""
    log_dir = log_dir or os.environ.get(TRACE_DIR_ENV)
    if not log_dir:
        yield
        return
    if not _TRACE_LOCK.acquire(blocking=False):
        yield
        return
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() if cuda is None else cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        t0 = time.time_ns()
        with torch.profiler.profile(activities=activities) as prof:
            _LOCAL.active = True
            try:
                yield
            finally:
                _LOCAL.active = False
        t1 = time.time_ns()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"fenix-{os.getpid()}-{next(_SEQ):06d}.pt.trace.json")
        prof.export_chrome_trace(path)
        _write_spans(path, spans(t0, t1))
    finally:
        _TRACE_LOCK.release()


@contextlib.contextmanager
def device_timer(counter: str, device: torch.device) -> Iterator[None]:
    """Time the card's work enqueued in the block, on the current
    stream, into ``counter`` (seconds): while a capture is active, on a
    CUDA device, and inside :func:`device_timings` on this thread; else a
    no-op. Adds no synchronisation: :func:`settle` reads the events."""
    pending = getattr(_LOCAL, "device", None)
    if pending is None or device.type != "cuda" or not _torch_profiler._is_profiler_enabled:
        yield
        return
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    pending.append((counter, start, end))


@contextlib.contextmanager
def device_timings() -> Iterator[list]:
    """Collect the :func:`device_timer` event pairs recorded on this
    thread in the block, for :func:`settle`."""
    outer = getattr(_LOCAL, "device", None)
    _LOCAL.device = pending = []
    try:
        yield pending
    finally:
        _LOCAL.device = outer


def settle(pending: list) -> None:
    """Add each collected pair's elapsed time to its counter, once the
    card has passed its end event (a wait for later work has
    synchronised); a pair it has not yet passed is left uncounted."""
    for counter, start, end in pending:
        if end.query():
            METRICS.add(counter, start.elapsed_time(end) / 1e3)
