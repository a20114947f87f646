"""The draws of ``jax.random`` that the k-means trainer makes, in numpy.

``fenix_tpu/ops/kmeans.py:train`` takes its initial rows from
``jax.random.choice(..., replace=False)`` and its per-epoch sample order
from ``jax.random.permutation``, both under the default threefry2x32
generator. This module computes the same numbers without JAX, so a coder
that this package trains from a seed is the JAX package's coder of that
seed:

- ``prng_key(seed)``: ``PRNGKey`` of a 32-bit seed, ``(0, seed)``;
- ``split(key, num)``: the key-splitting rule of
  ``jax_threefry_partitionable`` mode (JAX's default; the tests check
  that the JAX they run uses it), i.e.
  ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))`` for ``i < num``;
- ``random_bits(key, n)``: 32-bit draws, the XOR of the two hash words
  of the same counters;
- ``permutation(key, n)``: ``jax.random._shuffle``, rounds of stably
  sorting by fresh 32-bit draws, ``ceil(3 ln n / ln(2³² − 1))`` rounds
  (three at 8M rows); ``choice(key, n, size)`` (``replace=False``) is
  its prefix;
- ``fold_in(key, data)``: the hash of the counter ``(0, data)``, i.e.
  ``split(key, data + 1)[data]``;
- ``randint(key, shape, minval, maxval)``: int32 draws, two 32-bit draws
  per value (of the two keys of ``split(key)``) folded into the span in
  uint32 arithmetic, as ``jax.random.randint`` computes them
  (``train_sharded``'s per-shard samples).

A stable sort keeps tied draws in their current order, which is what
``lax.sort_key_val(..., is_stable=True)`` does, so the result is the JAX
permutation element for element (``tests/test_torch_select.py`` holds it
to ``jax.random`` up to 1,048,583 rows).
"""

from __future__ import annotations

import math

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_HASH_BLOCK = 1 << 16  # counters hashed per numpy pass


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(np.uint32(seed))`` as a pair of ints."""
    return 0, int(seed) & _MASK


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the counter words ``(x0, x1)``
    (uint32 arrays of one shape) under ``key``."""
    ks = (key[0] & _MASK, key[1] & _MASK, (key[0] ^ key[1] ^ _PARITY) & _MASK)
    x0 = x0 + np.uint32(ks[0])
    x1 = x1 + np.uint32(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 ^= x0
        x0 += np.uint32(ks[(i + 1) % 3])
        x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & _MASK)
    return x0, x1


def _counters(start: int, stop: int) -> tuple[np.ndarray, np.ndarray]:
    """The high and low words of the uint64 counters ``start..stop-1``."""
    i = np.arange(start, stop, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(_MASK)).astype(np.uint32)


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)`` as a list of keys."""
    b0, b1 = threefry2x32(key, *_counters(0, num))
    return [(int(a), int(b)) for a, b in zip(b0, b1)]


def random_bits(key: tuple[int, int], n: int) -> np.ndarray:
    """``n`` uint32 draws: ``jax.random.bits(key, (n,), uint32)``. Hashed
    in blocks that stay in cache (five times faster than whole arrays at
    8M draws)."""
    out = np.empty(n, np.uint32)
    for start in range(0, n, _HASH_BLOCK):
        x0, x1 = _counters(start, min(start + _HASH_BLOCK, n))
        b0, b1 = threefry2x32(key, x0, x1)
        np.bitwise_xor(b0, b1, out=out[start : start + b0.shape[0]])
    return out


def shuffle_rounds(n: int) -> int:
    """The round count of ``jax.random._shuffle`` for ``n`` elements."""
    return int(math.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: tuple[int, int], n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` as int64. Each round sorts by
    ``(draw, current position)`` packed into one uint64: the positions are
    distinct, so this is the stable sort by draw."""
    x = np.arange(n, dtype=np.int64)
    position = np.arange(n, dtype=np.uint64)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        packed = (random_bits(sub, n).astype(np.uint64) << np.uint64(32)) | position
        packed.sort()
        x = x[(packed & np.uint64(_MASK)).astype(np.int64)]
    return x


def choice(key: tuple[int, int], n: int, size: int) -> np.ndarray:
    """``jax.random.choice(key, n, (size,), replace=False)`` as int64:
    the first ``size`` entries of :func:`permutation`."""
    if size > n:
        raise ValueError(f"cannot take {size} of {n} without replacement")
    return permutation(key, n)[:size]


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32), np.full(1, int(data) & _MASK, np.uint32))
    return int(b0[0]), int(b1[0])


def randint(key: tuple[int, int], shape: tuple[int, ...], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, the
    default dtype with 64-bit types off) as an int32 array: the high and
    low draws of ``split(key)``'s two keys, each reduced mod the span
    ``maxval − minval`` (1 when empty) and combined as
    ``(hi % span · m + lo % span) % span``, ``m = (2¹⁶ % span)² % span``,
    every product wrapping as uint32 does: the JAX package's sampler."""
    n = int(np.prod(shape, dtype=np.int64))
    k1, k2 = split(key)
    higher, lower = random_bits(k1, n), random_bits(k2, n)
    span = np.uint32((int(maxval) - int(minval)) & _MASK) if maxval > minval else np.uint32(1)
    multiplier = (1 << 16) % int(span)
    multiplier = np.uint32(((multiplier * multiplier) & _MASK) % int(span))  # the square wraps too
    with np.errstate(over="ignore"):
        offset = (higher % span) * multiplier + (lower % span)  # wraps mod 2³², as uint32 does
    offset = offset % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32).reshape(shape)
