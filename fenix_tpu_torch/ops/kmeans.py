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

Not ported yet (ROADMAP queue 1 item 3, IVF past the budget, and item
10): ``train_streaming``, ``train_sharded``, ``sharded_lloyd_step``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from fenix_tpu_torch.ops.distance import canonical_metric, normalize, pairwise_distance
from fenix_tpu_torch.utils import threefry

_DRAW_THREADS = 4  # permutations drawn at once


def lloyd_step_assign(
    codebooks: torch.Tensor,  # [n, K, D]
    batch: torch.Tensor,  # [n, B, D]
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd step per codebook: ``(new codebooks [n, K, D], the
    assignment [n, B] it made)``."""
    metric = canonical_metric(metric)
    if metric == "cosine":
        codebooks = normalize(codebooks)
        batch = normalize(batch)
    n, k, d = codebooks.shape
    assign = torch.argmin(pairwise_distance(batch, codebooks, metric), dim=-1)  # [n, B]
    segment = (assign + k * torch.arange(n, device=assign.device)[:, None]).reshape(-1)
    sums = torch.zeros((n * k, d), dtype=batch.dtype, device=batch.device)
    sums.index_add_(0, segment, batch.reshape(-1, d))
    counts = torch.zeros(n * k, dtype=batch.dtype, device=batch.device)
    counts.index_add_(0, segment, torch.ones_like(segment, dtype=batch.dtype))
    new = (codebooks + sums.view(n, k, d)) / (1.0 + counts.view(n, k, 1))
    if metric == "cosine":
        new = normalize(new)
    return new, assign


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
