"""Hand-written CUDA kernels: build, binding, wrappers, plain twins.

One kernel family lives here today, the phase-1 bucket-max scan, which
replaces ``fenix_tpu/ops/topk2.py:bucket_scores_pallas_bigq`` (its f32/bf16
and int8 bodies), the small-Q XLA dot beside it, and
``bucket_scores_pallas`` (K3). Six designs share one wrapper:

- ``stream`` (``csrc/bucket_scores_stream.cu``): f32 corpora at small
  query counts, bound by the read of V;
- ``tiled`` (``csrc/bucket_scores_tiled.cu``): f32 corpora at large
  query counts, bound by the fp32 FMA rate;
- ``tensor_bf16`` and ``tensor_int8`` (``csrc/bucket_scores_tensor.cu``,
  one frame for both types): the bf16 and the int8 corpus on the tensor
  cores (``wgmma`` fed by TMA), for rows of a multiple of 16 bytes;
- ``generic_bf16`` and ``generic_int8`` (the same frame and file): every
  other row width on the tensor cores, the rows copied by the producer
  warpgroup since TMA cannot address them.

:func:`kernel_for` picks one by dtype, query count and row width.

Build: ``nvcc`` compiles each source for ``sm_90a`` (all at once, one
process per source) and links them into a shared library with a plain C
interface, loaded with ``ctypes``. The library lands in
``build/fenix_tpu_torch/`` at the repository root when the package runs
from a source checkout, in ``$XDG_CACHE_HOME/fenix_tpu_torch`` (default
``~/.cache``) when it is installed, or in ``$FENIX_TORCH_BUILD_DIR``; it is
named by a hash of its sources and flags so a changed source rebuilds.
The build runs at most once per process (thread lock) and once per build
directory (file lock, :func:`locked_build`, which the host rescore's g++
build in ``ops/host_rescore.py`` shares), the first time a CUDA tensor
reaches a wrapper — never at import.

Dispatch: a wrapper given CPU tensors computes its plain PyTorch twin
(the CPU tests run that); given CUDA tensors it launches the kernel or
raises. No path falls back from a failed build or launch to the twin or
to another kernel.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("bucket_scores.cu", "bucket_scores_stream.cu", "bucket_scores_tiled.cu", "bucket_scores_tensor.cu")
_HEADERS = ("common.cuh",)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# Launches, counted where the wrapper launches a kernel and nowhere else
# (the plain twins do not count): once per call under its route (the
# scan type), and once under the kernel design that served it. An f32
# launch at bucket 128 also computes what the JAX package's round-1
# kernel (``bucket_scores_pallas``) did; those are counted again under
# their own name.
LAUNCHES: dict[str, int] = {
    "bucket_scores.f32": 0,
    "bucket_scores.bf16": 0,
    "bucket_scores.int8": 0,
    "bucket_scores.f32.bucket128": 0,
    "bucket_scores.kernel.stream": 0,
    "bucket_scores.kernel.tiled": 0,
    "bucket_scores.kernel.generic_int8": 0,
    "bucket_scores.kernel.tensor_int8": 0,
    "bucket_scores.kernel.tensor_bf16": 0,
    "bucket_scores.kernel.generic_bf16": 0,
}

# The same launches per card: "bucket_scores.kernel.<design>.cuda<index>",
# one entry per (design, card) that launched (a mesh launches on each).
DEVICE_LAUNCHES: dict[str, int] = {}

_DTYPE_CODES = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"), torch.int8: (2, "int8")}
_KERNEL_CODES = {"stream": 0, "tiled": 1, "generic_int8": 2, "tensor_int8": 3, "tensor_bf16": 4, "generic_bf16": 5}
# the designs that take each corpus dtype
_DESIGNS = {
    torch.float32: ("stream", "tiled"),
    torch.bfloat16: ("tensor_bf16", "generic_bf16"),
    torch.int8: ("tensor_int8", "generic_int8"),
}
# rows TMA can address: 16-byte strides (a shape rule of the tensor-core designs)
_TENSOR_ROW_MULTIPLE = {"tensor_int8": 16, "tensor_bf16": 8}
# the designs whose query batch comes zero-padded to 16-byte rows
_PADDED_QUERIES = ("generic_int8", "generic_bf16")
MAX_BUCKET = 128  # a bucket lies inside one row tile of every design

# Largest query count the stream kernel serves (f32); above it the tiled
# one. From chip_smoke.py phase 2's forced timings at 8,388,608 x 128 on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md): at Q=32 stream 2.009 ms vs
# tiled 4.386, at Q=64 (two groups of 32) 3.960 vs 4.430, at Q=128 8.098
# vs 7.418. No bf16 row reaches stream or tiled: on rows TMA cannot address
# (8,388,608 x 100) generic_bf16 beat both at every query count timed
# (PERF.md), so their bf16 instantiations are gone.
STREAM_MAX_Q = 64


def kernel_for(dtype: torch.dtype, qt: int, d: int) -> str:
    """The kernel design that serves a (corpus dtype, query count, row
    width) triple. int8 and bf16 rows go to the tensor cores at every
    width: by TMA where it can address them (16-byte row strides), else
    through the generic producer; that is a shape rule, not a fallback."""
    if dtype == torch.int8:
        return "tensor_int8" if d % 16 == 0 else "generic_int8"
    if dtype == torch.bfloat16:
        return "tensor_bf16" if d % 8 == 0 else "generic_bf16"
    return "stream" if qt <= STREAM_MAX_Q else "tiled"


_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()  # Flight handlers launch from a thread pool


def build_dir() -> Path:
    env = os.environ.get("FENIX_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / "pyproject.toml").exists():
        return checkout / "build" / "fenix_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "fenix_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in (*_SOURCES, *_HEADERS):
        digest.update(name.encode())
        digest.update((_CSRC / name).read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return build_dir() / f"libfenix_kernels-{digest.hexdigest()[:16]}.so"


def locked_build(lib: Path, make) -> Path:
    """``lib``, made at most once per build directory: under the
    directory's file lock, unless it exists, ``make(tmp)`` writes it to a
    path of this process that then replaces it (``make`` raises on a
    failed build)."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
            make(tmp)
            os.replace(tmp, lib)
    return lib


def build() -> Path:
    """Compile the kernel library if this source revision has none yet:
    one ``nvcc`` per source, all started together, then one link."""
    return locked_build(library_path(), _compile)


def _compile(tmp: Path) -> None:
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.stem}.{Path(s).stem}.o") for s in _SOURCES]
    logs = [obj.with_suffix(".log") for obj in objs]
    procs = []
    for src, obj, log in zip(_SOURCES, objs, logs):
        with open(log, "w") as fh:  # a file, not a pipe: no compile blocks on output
            procs.append(subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(_CSRC / src)],
                stdout=fh, stderr=subprocess.STDOUT,
            ))
    errors = []
    for src, proc, log in zip(_SOURCES, procs, logs):
        if proc.wait() != 0:
            errors.append(f"nvcc {src} failed ({proc.returncode}):\n{log.read_text()}")
    if not errors:
        done = subprocess.run(
            [nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if done.returncode != 0:
            errors.append(f"nvcc link failed ({done.returncode}):\n{done.stderr}")
    for path in (*objs, *logs):
        path.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("\n".join(errors))


def _library() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.fenix_bucket_scores
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_int,  # dtype code
                ctypes.c_int,  # kernel design code
                ctypes.c_void_p, ctypes.c_void_p,  # q, v
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # aux_mul, aux_add, inv_sq
                ctypes.c_void_p,  # out
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # qt, n, d
                ctypes.c_int,  # log2(bucket)
                ctypes.c_void_p,  # stream
            ]
            _LIB = lib
        return _LIB


def bucket_scores_plain(
    q: torch.Tensor,  # [QT, D] f32 / bf16 / int8
    v: torch.Tensor,  # [N, D] same dtype
    aux_mul: torch.Tensor,  # [N] f32
    aux_add: torch.Tensor,  # [N] f32
    bucket: int,
    inv_sq: torch.Tensor | None = None,  # [QT] f32, int8 only
) -> torch.Tensor:  # [QT, N // bucket] f32
    """Plain PyTorch version of the kernel: matmul, epilogue, bucket max.

    f32 and bf16 inputs are widened to f32 and multiplied with TF32 off.
    int8 codes multiply in f32 too, which is exact: every partial sum is
    an integer below 127²·D < 2²⁴ for D ≤ 1024 (f64 above that)."""
    qt, n = q.shape[0], v.shape[0]
    if q.dtype == torch.int8 and v.shape[1] > 1024:  # f64 stays exact past 2²⁴
        s = (q.to(torch.float64) @ v.to(torch.float64).T).to(torch.float32)
    else:
        s = q.to(torch.float32) @ v.to(torch.float32).T
    if inv_sq is not None:
        s = s * aux_mul[None, :] + aux_add[None, :] * inv_sq[:, None]
    else:
        s = s * aux_mul[None, :] + aux_add[None, :]
    return s.reshape(qt, n // bucket, bucket).amax(-1)


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must be 16-byte aligned")


def bucket_scores(
    q: torch.Tensor,
    v: torch.Tensor,
    aux_mul: torch.Tensor,
    aux_add: torch.Tensor,
    bucket: int,
    inv_sq: torch.Tensor | None = None,
    _kernel: str | None = None,
) -> torch.Tensor:  # [QT, N // bucket] f32
    """Phase-1 bucket maxima (see :func:`bucket_scores_plain` for the
    function). CPU tensors take the plain version; CUDA tensors launch the
    design :func:`kernel_for` picks, or raise. ``_kernel`` forces a design
    (``chip_smoke.py`` times each one at the same shapes)."""
    if v.device.type == "cpu":
        return bucket_scores_plain(q, v, aux_mul, aux_add, bucket, inv_sq)
    if v.device.type != "cuda":
        raise ValueError(f"bucket_scores runs on cpu or cuda tensors, got {v.device}")
    if v.dtype not in _DTYPE_CODES:
        raise ValueError(f"bucket_scores takes f32, bf16 or int8 inputs, got {v.dtype}")
    code, route = _DTYPE_CODES[v.dtype]
    device = v.device
    _check(v, "v", v.dtype, 2, device)
    _check(q, "q", v.dtype, 2, device)
    _check(aux_mul, "aux_mul", torch.float32, 1, device)
    _check(aux_add, "aux_add", torch.float32, 1, device)
    n, d = v.shape
    qt = q.shape[0]
    if q.shape[1] != d or aux_mul.shape[0] != n or aux_add.shape[0] != n:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, v {tuple(v.shape)}, "
            f"aux {tuple(aux_mul.shape)}/{tuple(aux_add.shape)}"
        )
    if bucket < 1 or bucket > MAX_BUCKET or bucket & (bucket - 1) or n % bucket:
        raise ValueError(f"bucket must be a power of two <= {MAX_BUCKET} dividing N={n}, got {bucket}")
    if (inv_sq is not None) != (v.dtype == torch.int8):
        raise ValueError("inv_sq is required for int8 inputs and only for them")
    if inv_sq is not None:
        _check(inv_sq, "inv_sq", torch.float32, 1, device)
        if inv_sq.shape[0] != qt:
            raise ValueError(f"inv_sq has {inv_sq.shape[0]} entries for {qt} queries")
    design = kernel_for(v.dtype, qt, d) if _kernel is None else _kernel
    if design not in _DESIGNS[v.dtype]:
        raise ValueError(f"no {design!r} kernel for {v.dtype} inputs")
    if d % _TENSOR_ROW_MULTIPLE.get(design, 1):
        raise ValueError(f"{design} needs rows of a multiple of 16 bytes, got D={d}")
    out = torch.empty((qt, n // bucket), dtype=torch.float32, device=device)
    if qt == 0 or n == 0:
        return out
    if design in _PADDED_QUERIES and (d * q.element_size()) % 16:
        # TMA brings the query tile: QT x D, small, zero-padded to 16-byte rows
        q = torch.nn.functional.pad(q, (0, -d % (16 // q.element_size())))
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fenix_bucket_scores(
            code,
            _KERNEL_CODES[design],
            ctypes.c_void_p(q.data_ptr()),
            ctypes.c_void_p(v.data_ptr()),
            ctypes.c_void_p(aux_mul.data_ptr()),
            ctypes.c_void_p(aux_add.data_ptr()),
            ctypes.c_void_p(inv_sq.data_ptr() if inv_sq is not None else None),
            ctypes.c_void_p(out.data_ptr()),
            qt, n, d, bucket.bit_length() - 1,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"bucket_scores {design} kernel launch failed: cudaError {err}")
    with _COUNT_LOCK:
        LAUNCHES[f"bucket_scores.{route}"] += 1
        LAUNCHES[f"bucket_scores.kernel.{design}"] += 1
        per_card = f"bucket_scores.kernel.{design}.cuda{device.index}"
        DEVICE_LAUNCHES[per_card] = DEVICE_LAUNCHES.get(per_card, 0) + 1
        if route == "f32" and bucket == 128:
            LAUNCHES["bucket_scores.f32.bucket128"] += 1
    return out
