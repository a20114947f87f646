#!/usr/bin/env python3
"""Drive the PyTorch port (fenix_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py               # needs one card; ~10 minutes at most

Phases, each printing one JSON line with its own timings:

1. device and build: the card's name and power limit; build the CUDA
   kernel library from fenix_tpu_torch/csrc/ into build/fenix_tpu_torch/.
2. kernel vs plain, on the card: the phase-1 kernel against its plain
   PyTorch version, (a) on 1,048,576 x 128 inputs over Q in {1, 8, 100,
   1024}, bucket in {128, 32} and f32/bf16/int8, (b) at the exact inputs
   the main path gives it in phase 3. Tolerances, per query j:
   f32 and bf16 (both sides widen the same inputs to f32):
   1e-5 * |q_j| * max_i |v_i| * aux_mul_i + 1e-6 * max_i |aux_add_i|;
   int8 (exact integer dot; FMA vs separate rounding in the epilogue):
   2e-6 * (127 * |q8_j|_1 * max_i aux_mul_i + max_i |aux_add_i| * inv_sq_j);
   -inf exactly where the plain version has -inf, no NaN.
3. the main path: a fenix_tpu_torch.launch server in a subprocess takes an
   8,388,608 x 128 fp32 table (int64 id, int32 tag; rows 4096..8191 copy
   rows 0..4095) over Flight in batches of 65,536 rows and answers five
   searches: one flat cosine query (maxval 10), Q=8 cosine top-10,
   Q=1024 l2 top-100 with tag < 50, Q=64 bf16 top-10, Q=256 int8 top-10.
   The server process starts with every kernel launch count at 0; its
   stats action reports them, and each search must raise its route's.
4. oracle: float64 exact ranking on the card, ordered by (distance, id),
   written independently of the port. fp32 ids must match it position by
   position, exact float64 ties (the duplicate rows) in id order; the
   only swaps allowed are between rows whose float64 distances differ by
   less than NEAR_TIE * max(1, d), which no fp32 engine can order.
   bf16/int8 recall@k >= 0.99; every returned distance within
   1e-4 * max(1, d) of float64.
5. warm per-search latency (client wall clock, median of 5).

Then one JSON line of the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero with no result.
The script takes no options: the card run at this size is its only path.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS = 8_388_608  # the table of phase 3
KERNEL_ROWS = 1 << 20  # the kernel-vs-plain inputs of phase 2 (a)
D = 128
DUP = 4096  # rows DUP..2*DUP-1 copy rows 0..DUP-1
BATCH_ROWS = 65_536
NEAR_TIE = 1e-5  # relative float64 distance gap below which fp32 order is free
TIMING_REPS = 3  # timed launches per kernel-vs-plain shape, after one warm-up
WARM_REPS = 5  # warm repetitions per search
SEARCHES = (
    # name, queries, metric, k, precision, filtered, flat
    ("flat_cosine_k10", 1, "cosine", 10, "fp32", False, True),
    ("q8_cosine_k10", 8, "cosine", 10, "fp32", False, False),
    ("q1024_l2_k100_filtered", 1024, "l2", 100, "fp32", True, False),
    ("q64_bf16_cosine_k10", 64, "cosine", 10, "bf16", False, False),
    ("q256_int8_l2_k10", 256, "l2", 10, "int8", False, False),
)
ROUTES = {"fp32": "f32", "bf16": "bf16", "int8": "int8"}
REPLACES = {
    "f32": "fenix_tpu/ops/topk2.py:453",  # kernel_f32 of bucket_scores_pallas_bigq (:492)
    "bf16": "fenix_tpu/ops/topk2.py:453",
    "int8": "fenix_tpu/ops/topk2.py:464",  # kernel_int8 of bucket_scores_pallas_bigq (:492)
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_data(rows: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((rows, D), dtype=np.float32)
    dup = min(DUP, rows // 2)
    vectors[dup : 2 * dup] = vectors[:dup]
    ids = np.arange(rows, dtype=np.int64)
    tags = rng.integers(0, 100, rows, dtype=np.int32)
    return vectors, ids, tags


def make_queries(vectors, q: int, seed: int):
    """Half of each batch are noisy copies of duplicated rows, so the
    exact duplicate pairs tie at the top of their results."""
    import numpy as np

    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((q, D), dtype=np.float32)
    near = q - q // 2
    dup = min(DUP, vectors.shape[0] // 2)
    src = rng.integers(0, dup, near)
    queries[:near] = vectors[src] + 0.05 * rng.standard_normal((near, D), dtype=np.float32)
    return queries


# -- phase 2: kernel vs plain -------------------------------------------------


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_chunked(kernels, q, v, mul, add, bucket, inv_sq, chunk: int = 128):
    """The plain version over query chunks (row-independent per query),
    so its [Q, N] score matrix fits the card at main-path sizes."""
    import torch

    parts = []
    for s in range(0, q.shape[0], chunk):
        isq = inv_sq[s : s + chunk] if inv_sq is not None else None
        parts.append(kernels.bucket_scores_plain(q[s : s + chunk], v, mul, add, bucket, isq))
    return torch.cat(parts)


def check_close(got, want, q, v, mul, add, inv_sq) -> float:
    """Hold the kernel's maxima ``got`` against the plain version's
    ``want`` with the tolerances of the module docstring; return the
    largest difference over finite buckets."""
    import torch

    finite_add = add[torch.isfinite(add)]
    add_max = float(finite_add.abs().max()) if finite_add.numel() else 0.0
    if inv_sq is None:
        row = float((v.float().norm(dim=1) * mul.abs()).max())
        tol = 1e-5 * q.float().norm(dim=1) * row + 1e-6 * add_max
    else:
        l1 = q.to(torch.float32).abs().sum(dim=1)
        tol = 2e-6 * (127.0 * l1 * float(mul.abs().max()) + add_max * inv_sq)
    if torch.isnan(got).any():
        raise AssertionError("kernel produced NaN")
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError("kernel and plain version disagree on -inf buckets")
    fin = torch.isfinite(want)
    diff = torch.where(fin, (got - want).abs(), torch.zeros_like(got))
    err = float(diff.max()) if diff.numel() else 0.0
    over = diff > tol[:, None]
    if over.any():
        raise AssertionError(f"kernel off by {err} (> tolerance at {int(over.sum())} buckets)")
    return err


def compare(kernels, q, v, mul, add, bucket, inv_sq) -> dict:
    """The kernel against its plain version on the card, then both timed."""
    import torch

    got = kernels.bucket_scores(q, v, mul, add, bucket, inv_sq=inv_sq)
    want = plain_chunked(kernels, q, v, mul, add, bucket, inv_sq)
    torch.cuda.synchronize()
    err = check_close(got, want, q, v, mul, add, inv_sq)
    ms = time_ms(lambda: kernels.bucket_scores(q, v, mul, add, bucket, inv_sq=inv_sq), TIMING_REPS)
    plain_ms = time_ms(lambda: plain_chunked(kernels, q, v, mul, add, bucket, inv_sq), TIMING_REPS)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_kernel_vs_plain(kernels, topk2) -> list[dict]:
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    n, device = KERNEL_ROWS, "cuda"
    v32 = torch.from_numpy(rng.standard_normal((n, D), dtype=np.float32)).to(device)
    mul = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(device)
    add = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    add[torch.from_numpy(rng.random(n) < 0.1).to(device)] = float("-inf")
    add[: 4 * 128] = float("-inf")  # whole buckets of masked rows
    v16 = v32.to(torch.bfloat16)
    v8, sv = topk2.quantize_corpus_int8(v32)
    results = []
    for qn in (1, 8, 100, 1024):
        q32 = torch.from_numpy(rng.standard_normal((qn, D), dtype=np.float32)).to(device)
        for bucket in (128, 32):
            for route in ("f32", "bf16", "int8"):
                if route == "f32":
                    args = (q32, v32, mul, add, bucket, None)
                elif route == "bf16":
                    args = (q32.to(torch.bfloat16), v16, mul, add, bucket, None)
                else:
                    q8, inv_sq = topk2.quantize_queries_int8(q32)
                    args = (q8, v8, mul * sv, add, bucket, inv_sq)
                r = compare(kernels, *args)
                results.append({"route": route, "q": qn, "n": n, "bucket": bucket, **r})
    return results


def main_path_inputs(topk2, vectors, tags, spec, queries_np, device):
    """The phase-1 kernel's inputs exactly as topk_two_phase builds them
    for one search of phase 3."""
    import torch

    name, qn, metric, k, precision, filtered, flat = spec
    corpus = torch.from_numpy(vectors).to(device)
    n = corpus.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=device)
    if filtered:
        valid &= torch.from_numpy(tags < 50).to(device)
    mul, add = topk2.prepare_aux(corpus, valid, metric)
    qp = topk2.prepare_queries(torch.from_numpy(queries_np).to(device), metric).contiguous()
    bucket = topk2.bucket_for(qn, n)
    if precision == "int8":
        v8, sv = topk2.quantize_corpus_int8(corpus)
        q8, inv_sq = topk2.quantize_queries_int8(qp)
        return (q8, v8, mul * sv, add, bucket, inv_sq)
    if precision == "bf16":
        return (qp.to(torch.bfloat16), corpus.to(torch.bfloat16), mul, add, bucket, None)
    return (qp, corpus, mul, add, bucket, None)


# -- phase 3/4/5: server, searches, oracle -------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_healthy(client, proc, timeout_s: float = 300.0) -> None:
    deadline = time.time() + timeout_s
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"server exited with {proc.returncode}")
        try:
            if client.health().get("status") == "ok":
                return
        except Exception:
            if time.time() > deadline:
                raise
        client.close()
        time.sleep(0.5)


def launches(client) -> dict:
    stats = client.stats()
    return {r: int(stats.get(f"kernel.bucket_scores.{r}.launches", 0)) for r in ROUTES.values()}


class Oracle:
    """Float64 exact ranking on the card, independent of the port's
    code: (distance asc, row id asc). A coarse float64 matmul pass picks
    k + 16 candidates; their distances are then recomputed elementwise
    (identical rows give identical values) and sorted by (distance, id)."""

    def __init__(self, vectors, device):
        import torch

        self.v = torch.from_numpy(vectors).to(device=device, dtype=torch.float64)
        self.sq = (self.v * self.v).sum(dim=1)
        self.norm = self.sq.sqrt().clamp_min(1e-12)
        self.device = device

    def exact(self, q, idx, metric):
        """Elementwise float64 distances of rows ``idx`` [Q, c] to ``q``."""
        cand = self.v[idx]  # [Q, c, D]
        if metric == "l2":
            return ((cand - q[:, None, :]) ** 2).sum(-1).sqrt()
        if metric == "cosine":
            qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
            return 0.5 - 0.5 * (cand * qn[:, None, :]).sum(-1) / self.norm[idx]
        return -(cand * q[:, None, :]).sum(-1)

    def topk(self, queries_np, metric, k, mask=None, chunk=64):
        import torch

        out_ids, out_d = [], []
        for s in range(0, queries_np.shape[0], chunk):
            q = torch.from_numpy(queries_np[s : s + chunk]).to(self.device, torch.float64)
            if metric == "l2":
                d = (q * q).sum(1, keepdim=True) - 2.0 * q @ self.v.T + self.sq[None, :]
            elif metric == "cosine":
                qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
                d = 0.5 - 0.5 * (qn @ self.v.T) / self.norm[None, :]
            else:
                d = -(q @ self.v.T)
            if mask is not None:
                d = torch.where(mask[None, :], d, torch.inf)
            coarse, idx = torch.topk(d, k + 16, dim=1, largest=False)
            del d
            fine = self.exact(q, idx, metric)
            idx, order = torch.sort(idx, dim=1)
            fine = torch.gather(fine, 1, order)
            fine, order = torch.sort(fine, dim=1, stable=True)
            idx = torch.gather(idx, 1, order)
            # the (k+16)-th coarse distance must clear the k-th exact one,
            # or a tied row past the window could belong in the top k
            if metric == "l2":  # the coarse pass ranks squared distances
                coarse = coarse.clamp_min(0.0).sqrt()
            margin = coarse[:, -1] - fine[:, k - 1]
            if (margin <= 1e-9 * (1.0 + fine[:, k - 1].abs())).any():
                raise AssertionError("oracle window too narrow for the ties at k")
            out_ids.append(idx[:, :k].cpu())
            out_d.append(fine[:, :k].cpu())
        return torch.cat(out_ids).numpy(), torch.cat(out_d).numpy()


def split_result(result, qn: int, k: int):
    """[Q, k] ids and distances from a result table."""
    import numpy as np

    ids = np.array(result.column("id"))
    dist = np.array(result.column("__DISTANCE__"))
    if "__QUERY_ID__" in result.column_names:
        qid = result.column("__QUERY_ID__").to_numpy()
    else:
        qid = np.zeros(len(ids), np.int64)
    if len(ids) != qn * k or not np.array_equal(qid, np.repeat(np.arange(qn), k)):
        raise AssertionError(f"result has {len(ids)} rows, expected {qn} x {k} in query order")
    if not np.isfinite(dist).all():
        raise AssertionError("non-finite distance in the result")
    return ids.reshape(qn, k), dist.reshape(qn, k)


def check_search(oracle, spec, queries_np, result, mask) -> dict:
    import numpy as np
    import torch

    name, qn, metric, k, precision, filtered, flat = spec
    ids, dist = split_result(result, qn, k)
    want_ids, want_d = oracle.topk(queries_np, metric, k, mask)
    q = torch.from_numpy(queries_np).to(oracle.device, torch.float64)
    got_d64 = oracle.exact(q, torch.from_numpy(ids).to(oracle.device), metric).cpu().numpy()
    dist_err = np.abs(dist - got_d64) / np.maximum(1.0, np.abs(got_d64))
    if dist_err.max() > 1e-4:
        raise AssertionError(f"{name}: distance off float64 by {dist_err.max()} relative")
    if mask is not None and not mask.cpu().numpy()[ids].all():
        raise AssertionError(f"{name}: a filtered-out row was returned")
    ties = sum(
        len(set(row.tolist()) & {i + DUP for i in row.tolist() if i < DUP}) for row in ids
    )
    out = {"ties_in_results": int(ties), "max_rel_dist_err": float(dist_err.max())}
    # fp32 resolves distances to about 1e-6 relative; float64 neighbours
    # closer than NEAR_TIE can come back in either order from any fp32
    # engine. Exactly equal float64 distances (the duplicate rows) must
    # come back in id order.
    near_tie = NEAR_TIE * np.maximum(1.0, np.abs(want_d))
    if precision == "fp32":
        differ = ids != want_ids
        far = differ & (np.abs(got_d64 - want_d) > near_tie)
        if far.any():
            bad = int(far.any(axis=1).sum())
            raise AssertionError(f"{name}: ids differ from the float64 oracle in {bad} queries")
        tied = got_d64[:, 1:] == got_d64[:, :-1]
        if (tied & (ids[:, 1:] < ids[:, :-1])).any():
            raise AssertionError(f"{name}: exactly tied rows not in id order")
        if flat is False and ties == 0:
            raise AssertionError(f"{name}: no duplicate-row ties were exercised")
        out["ids_equal_positions"] = float(1.0 - differ.mean())
        out["near_tie_swaps"] = int(differ.sum())
    else:
        kth = want_d[:, -1:]
        hits = got_d64 <= kth + near_tie[:, -1:]
        recall = float(hits.mean())
        if recall < 0.99:
            raise AssertionError(f"{name}: recall@{k} {recall} < 0.99")
        out["recall"] = recall
    return out


def start_server(root: str, port: int, log_path: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    log = open(log_path, "w")
    cmd = [
        sys.executable, "-m", "fenix_tpu_torch.launch", root,
        "--host", "127.0.0.1", "--port", str(port), "--device", "cuda",
    ]
    return subprocess.Popen(cmd, cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT), log


def run() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from fenix_tpu_torch import expr
    from fenix_tpu_torch.flight import Flight
    from fenix_tpu_torch.ops import kernels, topk2

    device = "cuda"

    # -- phase 1 --------------------------------------------------------------
    t = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    lib = str(kernels.build())
    emit({"phase": "device_build", "device": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "library": lib,
          "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    vectors, ids_np, tags = make_data(ROWS, seed=0)
    queries = [make_queries(vectors, spec[1], seed=10 + i) for i, spec in enumerate(SEARCHES)]
    emit({"phase": "data", "rows": ROWS, "dim": D, "seconds": time.perf_counter() - t})

    # -- phase 2 --------------------------------------------------------------
    t = time.perf_counter()
    small = phase_kernel_vs_plain(kernels, topk2)
    for r in small:
        emit({"phase": "kernel_vs_plain", **r})
    main_shapes = []
    for spec, qnp in zip(SEARCHES, queries):
        inputs = main_path_inputs(topk2, vectors, tags, spec, qnp, device)
        r = compare(kernels, *inputs)
        main_shapes.append({"search": spec[0], "route": ROUTES[spec[4]], "q": spec[1],
                            "n": ROWS, "bucket": inputs[4], **r})
        emit({"phase": "kernel_vs_plain_main_path", **main_shapes[-1]})
        del inputs
        torch.cuda.empty_cache()
    emit({"phase": "kernel_vs_plain_done", "seconds": time.perf_counter() - t})

    # -- phase 3 --------------------------------------------------------------
    work = os.path.join(HERE, "build", "chip_smoke", f"run-{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    root = os.path.join(work, "root")
    port = free_port()
    proc, log = start_server(root, port, os.path.join(work, "server.log"))
    client = Flight(host="127.0.0.1", port=port)
    try:
        t = time.perf_counter()
        wait_healthy(client, proc)
        before = launches(client)
        if any(before.values()):
            raise AssertionError(f"launch counts not 0 before the main path: {before}")
        emit({"phase": "server_up", "seconds": time.perf_counter() - t})

        import pyarrow as pa

        from fenix_tpu_torch.io import ingest

        schema = pa.schema({"id": pa.int64(), "vector": pa.list_(pa.float32(), D),
                            "tag": pa.int32()})

        def batches():
            for s in range(0, ROWS, BATCH_ROWS):
                e = min(s + BATCH_ROWS, ROWS)
                yield pa.record_batch(
                    [pa.array(ids_np[s:e]),
                     ingest.numpy_to_fixed_size_list(vectors[s:e], pa.float32()),
                     pa.array(tags[s:e])],
                    schema=schema,
                )

        t = time.perf_counter()
        client.make_table("smoke/items", pa.RecordBatchReader.from_batches(schema, batches()))
        emit({"phase": "put", "rows": ROWS, "batch_rows": BATCH_ROWS,
              "seconds": time.perf_counter() - t})

        results, latencies = [], {}
        for spec, qnp in zip(SEARCHES, queries):
            name, qn, metric, k, precision, filtered, flat = spec
            kw = dict(metric=metric, maxval=k, precision=precision)
            if filtered:
                kw["filter"] = expr.field("tag") < 50
            target = qnp[0] if flat else qnp
            route = ROUTES[precision]
            t = time.perf_counter()
            c0 = launches(client)
            result = client.search(target, "smoke/items", "vector", **kw)
            c1 = launches(client)
            first = time.perf_counter() - t
            if c1[route] <= c0[route]:
                raise AssertionError(f"{name}: the {route} kernel count did not rise")
            warm = []
            for _ in range(WARM_REPS):
                c0 = launches(client)
                s = time.perf_counter()
                client.search(target, "smoke/items", "vector", **kw)
                warm.append((time.perf_counter() - s) * 1e3)
                if launches(client)[route] <= c0[route]:
                    raise AssertionError(f"{name}: the {route} kernel count did not rise")
            latencies[name] = warm
            results.append(result)
            emit({"phase": "search", "search": name, "q": qn, "k": k, "metric": metric,
                  "precision": precision, "filtered": filtered, "rows_returned": result.num_rows,
                  "first_call_s": first, "launches_after": c1})
        main_launches = launches(client)
        stats = client.stats()
        emit({"phase": "main_path_done", "launches": main_launches,
              "cache_device_bytes": stats.get("cache.device_bytes")})
    finally:
        client.close()
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        with open(os.path.join(work, "server.log")) as fh:
            tail = fh.read().splitlines()[-20:]
        print("server log (last lines):", *tail, sep="\n", file=sys.stderr)
        shutil.rmtree(work, ignore_errors=True)

    # -- phase 4 --------------------------------------------------------------
    t = time.perf_counter()
    oracle = Oracle(vectors, device)
    mask = torch.from_numpy(tags < 50).to(device)
    for spec, qnp, result in zip(SEARCHES, queries, results):
        check = check_search(oracle, spec, qnp, result, mask if spec[5] else None)
        emit({"phase": "oracle", "search": spec[0], **check})
    del oracle
    emit({"phase": "oracle_done", "seconds": time.perf_counter() - t})

    # -- phase 5 --------------------------------------------------------------
    for spec in SEARCHES:
        warm = latencies[spec[0]]
        emit({"phase": "warm_latency", "search": spec[0], "q": spec[1], "k": spec[3],
              "precision": spec[4], "median_ms": float(np.median(warm)),
              "min_ms": float(min(warm)), "all_ms": warm, "device": kind, "nvidia_smi": smi})

    entries = []
    for route in ("f32", "bf16", "int8"):
        shapes = [m for m in main_shapes if m["route"] == route]
        top = max(shapes, key=lambda m: m["q"])
        errs = [r["max_abs_err"] for r in small + shapes if r["route"] == route]
        entries.append({
            "name": f"bucket_scores.{route}", "route": "cuda",
            "source": "fenix_tpu_torch/csrc/bucket_scores.cu",
            "replaces": REPLACES[route], "launches": main_launches[route],
            "max_abs_err": max(errs), "ms": top["ms"], "plain_ms": top["plain_ms"],
        })
        emit({"phase": "kernel_timed_at", "name": entries[-1]["name"], "search": top["search"],
              "q": top["q"], "n": top["n"], "d": D, "bucket": top["bucket"]})
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    try:
        return run()
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
