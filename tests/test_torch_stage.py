"""The prefetch pipeline's staging copy (``fenix_tpu_torch/io/batch.py``):
one copy of an item's source rows straight into its destination, the
pad rows filled there, split over threads by row ranges.

Every case is held byte for byte to what the stream's chunks carried
before the stager wrote the pad: ``np.concatenate`` of the rows and the
pad, then ``np.copyto`` into the (reused, stale) destination. The kinds
are the stream's arrays: fp32 rows, int8 codes and scales, ``aux_mul``
and ``aux_add`` (whose filtered rows are already −inf)."""

import threading

import numpy as np
import pytest
import torch

from fenix_tpu_torch.io import batch as batch_io
from fenix_tpu_torch.ops import distance as distance_ops
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

DIM = 96
CHUNK = 1024


def _rows(kind: str, rng, n: int) -> np.ndarray:
    if kind == "f32_rows":
        return rng.standard_normal((n, DIM), dtype=np.float32)
    if kind == "int8_codes":
        return rng.integers(-127, 128, (n, DIM), dtype=np.int8)
    if kind == "int8_scales":
        return rng.random(n, dtype=np.float32) + np.float32(1e-3)
    if kind == "aux_mul":
        return rng.standard_normal(n, dtype=np.float32)
    add = rng.standard_normal(n, dtype=np.float32)  # aux_add: a filter's −inf already in
    add[rng.random(n) < 0.3] = np.float32(distance_ops.NEG_INF)
    return add


FILL = {"f32_rows": 0.0, "int8_codes": 0, "int8_scales": 1e-30, "aux_mul": 0.0,
        "aux_add": distance_ops.NEG_INF}
# (source rows, pad rows): a whole chunk, one row, a pad larger than the
# rows, the ragged tail of a table
SHAPES = {"whole": (CHUNK, 0), "one_row": (1, CHUNK - 1), "pad_gt_rows": (100, CHUNK - 100),
          "ragged": (904, CHUNK - 904)}


def _concatenated(rows: np.ndarray, pad: int, fill) -> np.ndarray:
    return np.concatenate([rows, np.full((pad, *rows.shape[1:]), fill, rows.dtype)])


@pytest.mark.parametrize("split", [False, True], ids=["one_range", "ranges_of_256_bytes"])
@pytest.mark.parametrize("threads", [1, 2, 8])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", list(FILL))
def test_stage_equals_concatenate_then_copy(monkeypatch, kind, shape, threads, split):
    """Into a destination that holds an earlier item's bytes (the pinned
    slot is reused): the same bytes as concatenating, then copying. With
    the default range every item here is one copy; with 256-byte ranges
    the rows split over ``threads`` ranges, some across the pad's start."""
    if split:
        monkeypatch.setattr(batch_io, "_STAGE_RANGE_BYTES", 256)
    rng = np.random.default_rng([list(FILL).index(kind), list(SHAPES).index(shape)])
    n, pad = SHAPES[shape]
    rows = _rows(kind, rng, n)
    dst = np.empty((n + pad, *rows.shape[1:]), rows.dtype)
    batch_io.stage(dst, _rows(kind, rng, n + pad), threads)  # the earlier item
    want = dst.copy()
    np.copyto(want, _concatenated(rows, pad, FILL[kind]))
    batch_io.stage(dst, batch_io.Padded(rows, pad, FILL[kind]), threads)
    assert dst.tobytes() == want.tobytes()


@pytest.mark.parametrize("threads", [1, 8])
def test_stage_splits_rows_across_threads(monkeypatch, threads):
    """A large item is copied in ``min(threads, bytes / range)`` ranges,
    beyond the first on pool threads; the ranges cover every row once."""
    monkeypatch.setattr(batch_io, "_STAGE_RANGE_BYTES", 4 * DIM * 64)  # 64 fp32 rows a range
    seen, threads_seen = [], set()
    real = np.copyto

    def spy(dst, src, *args, **kwargs):
        seen.append(dst.shape[0])
        threads_seen.add(threading.get_ident())
        return real(dst, src, *args, **kwargs)

    monkeypatch.setattr(batch_io.np, "copyto", spy)
    rows = np.arange(1000 * DIM, dtype=np.float32).reshape(1000, DIM)
    dst = np.full((CHUNK, DIM), 7.0, np.float32)
    batch_io.stage(dst, batch_io.Padded(rows, CHUNK - 1000, 0.0), threads)
    assert len(seen) == threads and sum(seen) == 1000
    assert (len(threads_seen) > 1) == (threads > 1)  # the caller copies one range, the pool the rest
    assert np.array_equal(dst, _concatenated(rows, CHUNK - 1000, 0.0))


@pytest.mark.parametrize("kind", list(FILL))
def test_stage_refuses_another_shape(kind):
    rows = _rows(kind, np.random.default_rng(0), 10)
    dst = np.empty((12, *rows.shape[1:]), rows.dtype)
    with pytest.raises(ValueError, match="cannot stage"):
        batch_io.stage(dst, batch_io.Padded(rows, 1, FILL[kind]), 2)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", list(FILL))
def test_whole_gives_the_concatenated_array(kind, shape):
    """The helper of the consumers without a pinned slot (a CPU device, a
    mesh's ``put_rows``): today's padded array, and the source itself
    (no copy) when there is no pad."""
    n, pad = SHAPES[shape]
    rows = _rows(kind, np.random.default_rng(1), n)
    got = batch_io.whole(batch_io.Padded(rows, pad, FILL[kind]))
    assert got.dtype == rows.dtype and got.tobytes() == _concatenated(rows, pad, FILL[kind]).tobytes()
    if not pad:
        assert got is rows
    assert batch_io.whole(rows) is rows


def test_prefetch_on_the_cpu_pads_and_counts():
    """A CPU device yields each item's padded arrays as tensors, and counts
    each item with pad rows once, its pad once (not once an array)."""
    rng = np.random.default_rng(2)
    items = []
    for n in (CHUNK, CHUNK, 904):  # two whole chunks and a ragged tail
        pad = CHUNK - n
        items.append((batch_io.Padded(_rows("f32_rows", rng, n), pad, 0.0),
                      batch_io.Padded(_rows("aux_mul", rng, n), pad, 0.0),
                      batch_io.Padded(_rows("aux_add", rng, n), pad, distance_ops.NEG_INF)))
    before = METRICS.snapshot()
    got = list(batch_io.prefetch_to_device(iter(items), "cpu"))
    after = METRICS.snapshot()
    assert after.get("transfer.padded_items", 0) - before.get("transfer.padded_items", 0) == 1
    assert after.get("transfer.pad_rows", 0) - before.get("transfer.pad_rows", 0) == CHUNK - 904
    for item, tensors in zip(items, got, strict=True):
        for a, t in zip(item, tensors, strict=True):
            assert t.device == torch.device("cpu")
            assert t.numpy().tobytes() == _concatenated(a.rows, a.pad, a.fill).tobytes()
