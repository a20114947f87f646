"""Multi-codebook k-means (Lloyd) — port of ``fenix_tpu/ops/kmeans.py``
(``lloyd_step_single``, ``lloyd_step``, ``train``).

One Lloyd step per batch: assign each sample to its nearest centroid,
then take the mean of {old centroid} ∪ {assigned samples} (the
reference's ``index_reduce(..., reduce="mean", include_self=True)``);
cosine normalizes before and after. The JAX package vmaps the step over
the codebook axis; here the codebooks are one batched product
(``[n, B, D] × [n, K, D]``) and the sums one ``index_add_`` over ``n·K``
segments.

Random draws: ``train`` takes its initial rows and its per-epoch
permutations from ``utils/threefry.py`` (:func:`draw_indices`), a numpy
copy of the ``jax.random`` draws the JAX package's ``train`` makes, so a
seed trains the JAX package's coder, on the CPU and on the card, up to
fp32 summation order (``index_add_`` on the card sums in no fixed order,
and a sample whose two nearest centroids are closer than fp32 resolves
may be assigned either way).

``train_streaming`` trains over a host corpus past the device budget:
permuted row chunks stream to the card through ``io/batch.prefetch_to_device``
in fp32, bf16 or int8 transport, the Lloyd math in fp32; its draws are
numpy's (``default_rng``), as in the JAX package's, so a seed gives that
function's coder.

``train_sharded`` trains over a row-sharded corpus on a mesh
(``parallel/mesh.py``): every shard samples its own rows with
replacement, each step's weighted segment sums and counts are gathered
(``Mesh.gather``) and added on the lead device in shard order (the JAX
package's ``psum``), and the draws are the JAX package's for the seed
and shard count (``threefry.choice`` for the initial rows, ``fold_in``
per global shard id, ``randint`` per step). Over several processes each
runs its own shards and adds every shard's statistics in the same
order, so each holds the codebooks one process would train, bit for bit.

``sharded_lloyd_step`` is one Lloyd step on a ``(data, model)`` mesh:
whole codebooks per model column, the batch rows split over the data
shards, each column's sums and counts gathered and added in data-shard
order, then the single update.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fenix_tpu_torch import native
from fenix_tpu_torch.io import batch as batch_io
from fenix_tpu_torch.ops import topk2
from fenix_tpu_torch.ops.distance import canonical_metric, normalize, pairwise_distance
from fenix_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from fenix_tpu_torch.utils import hbm, threefry
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

_DRAW_THREADS = 4  # permutations drawn at once


def _lloyd_sums(
    codebooks: torch.Tensor,  # [n, K, D]
    batch: torch.Tensor,  # [n, B, D]
    metric: str,
    weight: "torch.Tensor | None" = None,  # 0-dim f32: every sample's weight
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The statistics of one Lloyd step: ``(codebooks as compared —
    normalized for cosine —, per-centroid sums [n, K, D] and counts [n, K]
    of the (weighted) samples assigned to each, the assignment [n, B])``."""
    if metric == "cosine":
        codebooks = normalize(codebooks)
        batch = normalize(batch)
    n, k, d = codebooks.shape
    assign = torch.argmin(pairwise_distance(batch, codebooks, metric), dim=-1)  # [n, B]
    segment = (assign + k * torch.arange(n, device=assign.device)[:, None]).reshape(-1)
    values = batch.reshape(-1, d)
    ones = torch.ones_like(segment, dtype=batch.dtype)
    if weight is not None:
        values, ones = values * weight, ones * weight
    sums = torch.zeros((n * k, d), dtype=batch.dtype, device=batch.device)
    sums.index_add_(0, segment, values)
    counts = torch.zeros(n * k, dtype=batch.dtype, device=batch.device)
    counts.index_add_(0, segment, ones)
    return codebooks, sums.view(n, k, d), counts.view(n, k), assign


def _lloyd_update(codebooks: torch.Tensor, sums: torch.Tensor, counts: torch.Tensor, metric: str) -> torch.Tensor:
    """The mean of each old centroid and its samples."""
    new = (codebooks + sums) / (1.0 + counts[..., None])
    return normalize(new) if metric == "cosine" else new


def lloyd_step_assign(
    codebooks: torch.Tensor,  # [n, K, D]
    batch: torch.Tensor,  # [n, B, D]
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd step per codebook: ``(new codebooks [n, K, D], the
    assignment [n, B] it made)``."""
    metric = canonical_metric(metric)
    codebooks, sums, counts, assign = _lloyd_sums(codebooks, batch, metric)
    return _lloyd_update(codebooks, sums, counts, metric), assign


def lloyd_step(codebooks: torch.Tensor, batch: torch.Tensor, metric: str) -> torch.Tensor:
    """The Lloyd step over the codebook axis (the JAX package's vmap)."""
    return lloyd_step_assign(codebooks, batch, metric)[0]


def lloyd_step_single(centroids: torch.Tensor, batch: torch.Tensor, metric: str) -> torch.Tensor:
    """One Lloyd step for a single codebook ``[K, D]`` over ``[B, D]``."""
    return lloyd_step(centroids[None], batch[None], metric)[0]


def draw_indices(
    n_rows: int,
    seed: int,
    num_codebooks: int,
    codebook_size: int,
    batch_size: int,
    num_epochs: int,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The rows :func:`train` reads, as CPU int64 tensors: the initial
    rows ``[n·K]`` (without replacement) and, per epoch, the permuted
    sample rows ``[steps, n, b]`` with ``steps = N // (n·b)`` (the
    remainder of the permutation is dropped). These are the JAX package's
    draws for the seed (``fenix_tpu/ops/kmeans.py:83-107``): ``PRNGKey``,
    one split into the epoch key and the init key, ``choice(replace=False)``
    for the init rows and one ``permutation`` per epoch key. The
    permutations are independent, so they run in threads (numpy's sorts
    and ufuncs release the interpreter lock)."""
    need = num_codebooks * codebook_size
    if need > n_rows:
        raise ValueError(
            f"{num_codebooks} x {codebook_size} initial centroids need that many rows; "
            f"the corpus has {n_rows}"
        )
    key, init_key = threefry.split(threefry.prng_key(seed))
    keys = [init_key, *threefry.split(key, num_epochs)] if num_epochs else [init_key]
    with ThreadPoolExecutor(max_workers=min(len(keys), _DRAW_THREADS)) as pool:
        perms = [*pool.map(lambda k: threefry.permutation(k, n_rows), keys)]
    per_step = num_codebooks * batch_size
    steps = n_rows // per_step
    epochs = [
        torch.from_numpy(p[: steps * per_step]).view(steps, num_codebooks, batch_size)
        for p in perms[1:]
    ]
    return torch.from_numpy(perms[0][:need]), epochs


def train(
    corpus: torch.Tensor,  # [N, D] fp32 on the training device
    seed: int,
    num_codebooks: int,
    codebook_size: int,
    batch_size: int,
    num_epochs: int,
    metric: str,
) -> torch.Tensor:  # [num_codebooks, codebook_size, D]
    """Multi-codebook training: random-row init, then per epoch a fresh
    permutation consumed in ``num_codebooks·batch_size`` batches, one
    Lloyd step each (the reference's coder.py:94-127)."""
    n_rows, dim = corpus.shape
    init, epochs = draw_indices(
        n_rows, seed, num_codebooks, codebook_size, batch_size, num_epochs
    )
    codebooks = corpus[init.to(corpus.device)].view(num_codebooks, codebook_size, dim)
    for idx in epochs:
        idx = idx.to(corpus.device)
        for step in range(idx.shape[0]):
            codebooks = lloyd_step(codebooks, corpus[idx[step]], metric)
    return codebooks


def train_sharded(
    mesh,  # parallel.mesh.Mesh
    corpus,  # parallel.search.Sharded [N_pad, D] f32, padding zeros at the global tail
    rows: int,  # valid rows
    seed: int,
    *,
    num_codebooks: int,
    codebook_size: int,
    batch_size: int,
    num_epochs: int,
    metric: str,
) -> torch.Tensor:  # [num_codebooks, codebook_size, D] on the mesh's first device
    """Multi-codebook training over a row-sharded corpus, data-parallel
    over its shards: the JAX package's ``train_sharded``, draw for draw.

    The initial rows are ``choice(replace=False)`` of one unfolded key,
    gathered from the shards that own them (to every process). Each step,
    every shard draws
    ``ceil(batch_size / S)`` of its own valid rows with replacement
    (``randint`` under ``fold_in(sample_key, shard)``, split per epoch and
    step) and weighs its statistics by ``valid_rows / rows · batch_size /
    b_local``, so every row's expected mass is ``batch_size / rows`` and
    empty shards weigh 0; the shards' sums and counts are gathered and
    added on the lead device in shard order, so the result does not depend
    on the devices' timing or on which process holds a shard, and each
    codebook update is the single update on the union batch. ``steps =
    max(rows // (num_codebooks · batch_size), 1)`` per epoch. The result
    is on the lead device of every process."""
    metric_c = canonical_metric(metric)
    n_shards = mesh.size
    dim = corpus.shape[1]
    per = corpus.rows_local
    b_local = -(-batch_size // n_shards)
    steps = max(rows // (num_codebooks * batch_size), 1)
    dev0 = mesh.lead
    local = mesh.local_shards

    _, init_key, sample_key = threefry.split(threefry.prng_key(seed), 3)
    init_rows = threefry.choice(init_key, rows, codebook_size * num_codebooks)
    owner = init_rows // per
    width = int(np.bincount(owner, minlength=n_shards).max())

    def owned(s: int) -> torch.Tensor:
        """Shard ``s``'s initial rows, padded with its row 0 to ``width``."""
        at = np.zeros(width, np.int64)
        pos = np.flatnonzero(owner == s)
        at[: pos.size] = init_rows[pos] - s * per
        return corpus.shards[s][torch.from_numpy(at).to(mesh.devices[s])]

    picked = mesh.gather([owned(s) if mesh.is_local(s) else None for s in range(n_shards)])
    init = torch.empty((init_rows.shape[0], dim), dtype=torch.float32, device=dev0)
    for o in np.unique(owner):
        pos = np.flatnonzero(owner == o)
        init[torch.from_numpy(pos).to(dev0)] = picked[o][: pos.size]
    codebooks = init.view(num_codebooks, codebook_size, dim)

    # per local shard: its sample weight and, per epoch, its [steps, n, b_local] rows
    weights, draws = {}, {}
    for s in local:
        valid = min(max(rows - s * per, 0), per)
        weights[s] = torch.tensor(np.float32(np.float32(valid) / np.float32(rows)) * np.float32(batch_size / b_local),
                                  device=mesh.devices[s])
        epochs = threefry.split(threefry.fold_in(sample_key, s), num_epochs) if num_epochs else []
        draws[s] = [
            torch.from_numpy(np.stack([
                threefry.randint(key, (num_codebooks, b_local), 0, max(valid, 1))
                for key in threefry.split(ekey, steps)
            ]).astype(np.int64)).to(mesh.devices[s])
            for ekey in epochs
        ]

    for epoch in range(num_epochs):
        for step in range(steps):
            parts: list = [None] * n_shards
            for s in local:
                idx = draws[s][epoch][step]  # [n, b_local]
                sample = corpus.shards[s][idx.reshape(-1)].view(num_codebooks, b_local, dim)
                parts[s] = _lloyd_sums(codebooks.to(mesh.devices[s]), sample, metric_c, weights[s])[1:3]
            all_sums = mesh.gather([None if p is None else p[0] for p in parts])
            all_counts = mesh.gather([None if p is None else p[1] for p in parts])
            total_sums, total_counts = all_sums[0], all_counts[0]
            for sums, counts in zip(all_sums[1:], all_counts[1:]):
                total_sums = total_sums + sums
                total_counts = total_counts + counts
            base = normalize(codebooks) if metric_c == "cosine" else codebooks
            codebooks = _lloyd_update(base, total_sums, total_counts, metric_c)
    return codebooks


def sharded_lloyd_step(mesh, data_axis: str, model_axis: "str | None", metric: str):
    """One Lloyd step over a mesh (``parallel.mesh.Mesh``): ``fn(codebooks
    [n, K, D], batch [n, B, D]) -> [n, K, D]`` on the mesh's lead device
    (the inputs whole on every process).

    The codebooks split over ``model_axis`` (whole books per model column,
    ``n`` a multiple of its size; with None every column would hold every
    book, so the first column alone works); the batch rows split over
    ``data_axis`` (``B`` a multiple of its size). Shard ``(r, c)`` takes
    the segment sums and counts of column ``c``'s books over row block
    ``r``; they are gathered and add on the lead device in ``r`` order, so
    the sum order does not depend on the devices' timing or processes,
    and the update is ``lloyd_step_single``'s on the whole batch."""
    if data_axis != DATA_AXIS or model_axis not in (MODEL_AXIS, None):
        raise ValueError(f"axes must be {DATA_AXIS!r} and {MODEL_AXIS!r} or None, got {data_axis!r}, {model_axis!r}")
    metric_c = canonical_metric(metric)
    rows, m = len(mesh.grid), len(mesh.grid[0])
    cols = m if model_axis else 1

    def step(codebooks: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
        n, b = codebooks.shape[0], batch.shape[1]
        if n % cols or b % rows:
            raise ValueError(f"{n} codebooks x {b} rows do not split over a {rows} x {cols} mesh")
        nb, rb = n // cols, b // rows

        def part(s: int):
            r, c = divmod(s, m)
            if c >= cols:
                return None
            dev = mesh.devices[s]
            books = codebooks[c * nb : (c + 1) * nb].to(dev, non_blocking=True)
            sample = batch[c * nb : (c + 1) * nb, r * rb : (r + 1) * rb].to(dev, non_blocking=True)
            return _lloyd_sums(books, sample, metric_c)[1:3]

        parts = mesh.map(part)
        dev0 = mesh.lead
        out = []
        for c in range(cols):
            column = range(c, rows * m, m)
            sums = mesh.gather([None if p is None else p[0] for p in parts], column)
            counts = mesh.gather([None if p is None else p[1] for p in parts], column)
            books = codebooks[c * nb : (c + 1) * nb].to(dev0, non_blocking=True)
            base = normalize(books) if metric_c == "cosine" else books
            total_s, total_c = sums[0], counts[0]
            for s_r, c_r in zip(sums[1:], counts[1:]):
                total_s, total_c = total_s + s_r, total_c + c_r
            out.append(_lloyd_update(base, total_s, total_c, metric_c))
        return torch.cat(out)

    return step


TRANSPORTS = ("fp32", "bf16", "int8")


def train_streaming(
    matrix: np.ndarray,  # [N, D] fp32 host corpus
    seed: int,
    *,
    num_codebooks: int,
    codebook_size: int,
    batch_size: int,
    num_epochs: int,
    metric: str,
    device: "str | torch.device" = "cuda",
    chunk_rows: "int | None" = None,
    precision: str = "fp32",
    int8_mirror=None,  # optional (codes [N, D] int8, scales [N] f32) of ``matrix``
) -> torch.Tensor:  # [num_codebooks, codebook_size, D] on ``device``
    """Multi-codebook training over a host corpus that never lands on the
    device: per epoch a fresh ``np.random.default_rng(seed)`` permutation
    (after the ``choice`` of the initial rows) is cut into
    ``num_codebooks·batch_size`` batches; chunks of ``[steps, codebooks,
    batch, D]`` rows are gathered on the host and uploaded double-buffered
    (``io/batch.prefetch_to_device``) while the previous chunk runs its
    Lloyd steps. The codebooks are the only lasting device state. The JAX
    package's ``train_streaming``, step for step.

    ``precision`` is the chunks' transport: "fp32"; "bf16" (rows rounded to
    bfloat16 on the host, half the bytes); "int8" (per-row codes and
    scales, a quarter: the mirror ``int8_mirror`` when its shape is the
    corpus's, else the corpus quantized once here; the initial rows are
    dequantized too, so the run is fp32 training over the dequantized
    corpus). Every sample is widened to fp32 on the card, and the update
    math stays fp32. ``chunk_rows`` defaults to a quarter of 0.9 × the
    device budget at the transport's bytes per row (two chunks in flight),
    at most 1,048,576. Counters: ``train.stream_<precision>`` (runs) and
    ``train.stream_steps`` (Lloyd steps); the uploads count in
    ``transfer.*``."""
    if precision not in TRANSPORTS:
        raise ValueError(f"precision must be one of {TRANSPORTS}, got {precision!r}")
    n_rows, dim = matrix.shape
    rng = np.random.default_rng(seed)
    codes = scales = None
    if precision == "int8":
        if int8_mirror is not None and (
            int8_mirror[0].shape == (n_rows, dim) and int8_mirror[1].shape[0] == n_rows
        ):
            codes, scales = int8_mirror
        else:
            # a mirror of another revision would train on other rows'
            # codes: quantize the corpus once, in 256 MiB slices
            codes, scales = np.empty((n_rows, dim), np.int8), np.empty(n_rows, np.float32)
            step = max(1, (256 << 20) // (4 * dim))
            for s in range(0, n_rows, step):
                codes[s : s + step], scales[s : s + step] = topk2.quantize_rows_int8_np(matrix[s : s + step])

    init_rows = rng.choice(n_rows, codebook_size * num_codebooks, replace=False).astype(np.int64)
    if precision == "int8":
        init = np.asarray(codes[init_rows], np.float32) * np.asarray(scales[init_rows])[:, None]
    else:
        init = native.gather_rows(matrix, init_rows)
    codebooks = torch.from_numpy(np.ascontiguousarray(init, np.float32)).to(device)
    codebooks = codebooks.view(num_codebooks, codebook_size, dim)

    per_step = num_codebooks * batch_size
    steps_total = n_rows // per_step
    if chunk_rows is None:
        budget = hbm.budget_bytes(device) or (2 << 30)
        per_row = {"fp32": 4 * dim, "bf16": 2 * dim, "int8": dim + 4}[precision]
        chunk_rows = min(1 << 20, max(int(0.9 * budget / 4 / per_row), 1))
    steps_per_chunk = max(1, min(chunk_rows // per_step, steps_total))
    shape = (steps_per_chunk, num_codebooks, batch_size, dim)

    def chunks():
        # every chunk has one shape (the double buffers are allocated
        # from the first); an epoch's last, shorter chunk is zero-padded
        # and only its valid steps run
        for _ in range(num_epochs):
            perm = rng.permutation(n_rows)[: steps_total * per_step]
            for s0 in range(0, steps_total, steps_per_chunk):
                idx = perm[s0 * per_step : (s0 + steps_per_chunk) * per_step].astype(np.int64)
                if precision == "int8":
                    c8 = np.zeros((steps_per_chunk * per_step, dim), np.int8)
                    sv = np.zeros(steps_per_chunk * per_step, np.float32)
                    c8[: idx.size] = codes[idx]
                    sv[: idx.size] = scales[idx]
                    yield c8.reshape(shape), sv.reshape(shape[:-1])
                    continue
                rows = np.zeros((steps_per_chunk * per_step, dim), np.float32)
                rows[: idx.size] = native.gather_rows(matrix, idx)
                if precision == "bf16":  # round to nearest even on the host, sent as raw bits
                    rows = torch.from_numpy(rows).to(torch.bfloat16).view(torch.int16).numpy()
                yield (rows.reshape(shape),)

    METRICS.add(f"train.stream_{precision}")
    valid = [min(steps_per_chunk, steps_total - s0) for s0 in range(0, steps_total, steps_per_chunk)]
    for item, steps in zip(batch_io.prefetch_to_device(chunks(), device), valid * num_epochs):
        if precision == "int8":
            c8, sv = item
            samples = c8[:steps].to(torch.float32) * sv[:steps, ..., None]
        elif precision == "bf16":
            samples = item[0][:steps].view(torch.bfloat16).to(torch.float32)
        else:
            samples = item[0][:steps]
        for step in range(steps):
            codebooks = lloyd_step(codebooks, samples[step], metric)
        METRICS.add("train.stream_steps", steps)
    return codebooks
