"""A cell's corpus and queries, made on the device from ``--seed``.

Rows and queries are draws from one Gaussian mixture (real embeddings
are clustered; isotropic rows make IVF hub cells): ``centers`` centers
of unit-variance normal coordinates, each row a uniformly chosen center
plus ``noise`` times a normal vector. The ``tag`` column is uniform in
``[0, tag_range)``. The configuration file names the sizes and lists the
mixture's parameters as assumed.

Three generators on the device, one per stream (centers, corpus,
queries), each seeded from ``(seed, stream)``: the corpus can be made
again after the window for the reference, and the same seed gives the
same inputs on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

CENTERS, CORPUS, QUERIES = 0, 1, 2
BLOCK_ROWS = 1 << 18  # rows made per call: bounds the gather's temporary


def generator(seed: int, stream: int, device) -> torch.Generator:
    sub = int(np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(sub)


def _centers(cfg: dict, seed: int, device) -> torch.Tensor:
    mix = cfg["mixture"]
    return torch.randn(mix["centers"], cfg["dim"], generator=generator(seed, CENTERS, device), device=device)


def _draw(cfg: dict, centers: torch.Tensor, n: int, gen: torch.Generator, device) -> torch.Tensor:
    out = torch.empty((n, cfg["dim"]), dtype=torch.float32, device=device)
    noise = float(cfg["mixture"]["noise"])
    for start in range(0, n, BLOCK_ROWS):
        stop = min(start + BLOCK_ROWS, n)
        which = torch.randint(0, centers.shape[0], (stop - start,), generator=gen, device=device)
        block = out[start:stop]
        torch.randn(block.shape, generator=gen, device=device, out=block)
        block.mul_(noise).add_(centers[which])
    return out


def corpus(cfg: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``([rows, dim] float32 vectors, [rows] int32 tags)`` on ``device``."""
    gen = generator(seed, CORPUS, device)
    vectors = _draw(cfg, _centers(cfg, seed, device), cfg["rows"], gen, device)
    tags = torch.randint(0, cfg["tag_range"], (cfg["rows"],), generator=gen, device=device, dtype=torch.int32)
    return vectors, tags


def queries(cfg: dict, n: int, seed: int, device) -> np.ndarray:
    """``[n, dim]`` float32 queries from the corpus's mixture, on the host."""
    return _draw(cfg, _centers(cfg, seed, device), n, generator(seed, QUERIES, device), device).cpu().numpy()
