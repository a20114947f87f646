"""Profiling hooks: ``torch.profiler`` traces and named spans — port of
``fenix_tpu/utils/profiling.py``.

``trace`` captures the enclosed block into a Chrome trace (viewable in
Perfetto or ``chrome://tracing``) when a directory is given or
``$FENIX_TRACE_DIR`` is set, else does nothing, so call sites wrap hot
paths unconditionally. ``annotate`` names an engine stage; the spans are
``fenix.rpc.search``, ``fenix.snapshot``, ``fenix.fetch``,
``fenix.rank_cells``, ``fenix.mask_build`` and ``fenix.result_gather``.

torch's profiler records the CPU spans of the thread that started it
(CUDA kernels and copies it records from every thread), so ``annotate``
is a ``record_function`` only on a thread that holds the active capture
(:func:`tracing`) and a no-op everywhere else: a server with tracing off
pays nothing for its spans.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
from typing import Iterator

import torch

TRACE_DIR_ENV = "FENIX_TRACE_DIR"

# one trace at a time: the Flight server wraps every request handler in
# trace(), and handlers run on a thread pool. Non-blocking: a request that
# arrives during an active capture runs untraced (its kernels still land
# in the active trace's device timeline).
_TRACE_LOCK = threading.Lock()
_LOCAL = threading.local()
_SEQ = itertools.count()


def tracing() -> bool:
    """Whether the calling thread holds the active capture."""
    return getattr(_LOCAL, "active", False)


@contextlib.contextmanager
def trace(log_dir: str | None = None, cuda: bool | None = None) -> Iterator[None]:
    """Capture the enclosed block into
    ``<log_dir>/fenix-<pid>-<n>.pt.trace.json``: CPU activity, and CUDA
    kernels and copies when ``cuda`` (default: when a card is present).
    A no-op without a directory, and while another capture is active."""
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
        with torch.profiler.profile(activities=activities) as prof:
            _LOCAL.active = True
            try:
                yield
            finally:
                _LOCAL.active = False
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"fenix-{os.getpid()}-{next(_SEQ):06d}.pt.trace.json"))
    finally:
        _TRACE_LOCK.release()


def annotate(name: str):
    """Named span in the active capture's timeline (a no-op off it)."""
    return torch.profiler.record_function(name) if tracing() else contextlib.nullcontext()
