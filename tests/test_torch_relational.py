"""fenix_tpu_torch.ops.relational against fenix_tpu.ops.relational on the
same inputs, on the CPU.

Sorts, joins and integer aggregates are exact, so they must be equal.
Float aggregates accumulate in float32 in both packages, in orders that
may differ: within 1e-5 relative of the largest absolute group value.
``group_aggregate_int`` returns the aggregates themselves (int64, the
exact mean in float64); the JAX package returns limb lanes, unpacked
here with its ``unpack_int_aggregate``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenix_tpu.ops import relational as jrel
from fenix_tpu_torch.ops import relational

torch.set_num_threads(2)

INT32_MAX = 2**31 - 1


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a: np.ndarray):
    return jnp.asarray(a)


def test_sorts_are_stable_and_equal_the_jax_package(rng):
    keys = rng.integers(0, 50, 3000).astype(np.int32)  # many duplicates
    values = rng.standard_normal(3000).astype(np.float32)
    sk, sv = relational.sort_kv(t(keys), t(values))
    jsk, jsv = jrel.sort_kv(j(keys), j(values))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jsk))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jsv))
    perm = relational.argsort_stable(t(keys))
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jrel.argsort_stable(j(keys))))
    np.testing.assert_array_equal(perm.numpy(), np.argsort(keys, kind="stable"))
    sk, si = relational.sort_with_index(t(keys))
    jsk, jsi = jrel.sort_with_index(j(keys))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jsk))
    np.testing.assert_array_equal(si.numpy(), np.asarray(jsi))


def test_lookup_join_first_duplicate_wins(rng):
    right = rng.integers(0, 400, 2000).astype(np.int32)  # duplicated right keys
    right[:3] = INT32_MAX  # a real INT32_MAX key
    left = np.concatenate([rng.integers(-5, 450, 1000), [INT32_MAX, -1]]).astype(np.int32)
    got = relational.join_lookup(t(left), t(right)).numpy()
    want = np.asarray(jrel.join_lookup(j(left), j(right)))
    np.testing.assert_array_equal(got, want)
    first = {}
    for i, k in enumerate(right.tolist()):
        first.setdefault(k, i)
    np.testing.assert_array_equal(got, [first.get(k, -1) for k in left.tolist()])
    sk, si = relational.sort_with_index(t(right))
    got_sorted = relational.join_lookup_sorted(t(left), sk, si).numpy()
    jsk, jsi = jrel.sort_with_index(j(right))
    np.testing.assert_array_equal(got_sorted, np.asarray(jrel.join_lookup_sorted(j(left), jsk, jsi)))


@pytest.mark.parametrize("max_matches", [64, 5000])
def test_inner_join_with_a_padded_tail_and_n_valid(rng, max_matches):
    """A build side padded with INT32_MAX (as ``sorted_key`` pads), real
    INT32_MAX keys ahead of the padding, probes of INT32_MAX: n_valid stops
    the padding counting as matches."""
    real = rng.integers(0, 300, 1500).astype(np.int32)
    real[::97] = INT32_MAX
    keys = np.concatenate([real, np.full(548, INT32_MAX, np.int32)])  # padded to 2048
    left = np.concatenate([rng.integers(0, 320, 200), [INT32_MAX, 7, INT32_MAX]]).astype(np.int32)
    sk, si = relational.sort_with_index(t(keys))
    li, ri, total = relational.join_inner_sorted(t(left), sk, si, max_matches, n_valid=len(real))
    jsk, jsi = jrel.sort_with_index(j(keys))
    jli, jri, jtotal = jrel.join_inner_sorted(j(left), jsk, jsi, max_matches, n_valid=jnp.int32(len(real)))
    np.testing.assert_array_equal(li.numpy(), np.asarray(jli))
    np.testing.assert_array_equal(ri.numpy(), np.asarray(jri))
    assert int(total) == int(jtotal)
    pairs = [(a, b) for a, lk in enumerate(left.tolist()) for b, rk in enumerate(real.tolist()) if lk == rk]
    assert int(total) == len(pairs)
    n = min(len(pairs), max_matches)
    assert list(zip(li.numpy()[:n].tolist(), ri.numpy()[:n].tolist())) == pairs[:n]
    assert (li.numpy()[n:] == -1).all() and (ri.numpy()[n:] == -1).all()


def test_inner_join_unsorted_build_side(rng):
    right = rng.integers(0, 40, 120).astype(np.int32)
    left = rng.integers(0, 50, 30).astype(np.int32)
    got = relational.join_inner(t(left), t(right), 256)
    want = jrel.join_inner(j(left), j(right), 256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _group_inputs(rng, n=2000):
    keys = rng.integers(-20, 20, n).astype(np.int32)
    keys[::37] = INT32_MAX  # a real group keyed INT32_MAX
    mask = rng.random(n) < 0.7
    return keys, mask


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_group_aggregate_float_matches_jax(rng, agg, masked):
    keys, mask = _group_inputs(rng)
    values = rng.standard_normal(keys.shape[0]).astype(np.float32) * 10
    m = mask if masked else None
    gk, gv, n = relational.group_aggregate(t(keys), t(values), 64, agg=agg, mask=None if m is None else t(m))
    jgk, jgv, jn = jrel.group_aggregate(j(keys), j(values), 64, agg=agg, mask=None if m is None else j(m))
    assert int(n) == int(jn) == len(np.unique(keys if m is None else keys[m]))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jgk))
    assert gv.dtype == torch.float32
    scale = float(np.abs(np.asarray(jgv)).max())
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=0, atol=1e-5 * scale)
    assert INT32_MAX in gk.numpy()[: int(n)].tolist()  # the real INT32_MAX group


def test_group_sum_count_matches_jax(rng):
    keys, mask = _group_inputs(rng)
    values = rng.standard_normal(keys.shape[0]).astype(np.float32)
    got = relational.group_sum_count(t(keys), t(values), 64, mask=t(mask))
    want = jrel.group_sum_count(j(keys), j(values), 64, mask=j(mask))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-5 * float(np.abs(want[1]).max()))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])


@pytest.mark.parametrize("agg", ["sum", "mean", "min", "max", "count"])
def test_group_aggregate_int_equals_the_unpacked_lanes(rng, agg):
    """int64-exact where float32 would round: values near ±2^31."""
    keys, mask = _group_inputs(rng)
    values = rng.integers(2**27, 2**31 - 1, keys.shape[0]).astype(np.int64)
    values[::3] *= -1
    values = values.astype(np.int32)
    gk, gv, n = relational.group_aggregate_int(t(keys), t(values), 64, agg=agg, mask=t(mask))
    jgk, lanes, jn = jrel.group_aggregate_int(j(keys), j(values), 64, agg=agg, mask=j(mask))
    want = jrel.unpack_int_aggregate(np.asarray(lanes), agg)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jgk))
    assert int(n) == int(jn)
    assert gv.dtype == (torch.float64 if agg == "mean" else torch.int64)
    np.testing.assert_array_equal(gv.numpy(), want)
    # and against numpy over the valid rows, group by group
    for slot, g in enumerate(gk.numpy()[: int(n)].tolist()):
        sel = values[mask & (keys == g)].astype(np.int64)
        expect = {"sum": sel.sum(), "mean": sel.sum() / len(sel), "min": sel.min(),
                  "max": sel.max(), "count": len(sel)}[agg]
        assert gv.numpy()[slot] == expect


def test_group_overflow_reports_the_true_count(rng):
    keys = np.arange(100, dtype=np.int32)
    gk, gv, n = relational.group_aggregate(t(keys), t(np.ones(100, np.float32)), 16, agg="sum")
    jgk, jgv, jn = jrel.group_aggregate(j(keys), j(np.ones(100, np.float32)), 16, agg="sum")
    assert int(n) == int(jn) == 100
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jgk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jgv))
    with pytest.raises(ValueError, match="unknown agg"):
        relational.group_aggregate(t(keys), t(np.ones(100, np.float32)), 16, agg="median")


def test_group_float_sums_add_in_row_order(rng):
    """A float group sum adds each group's values in row order (the
    stable sort's), so a replayed aggregate has the same bits: equal, bit
    for bit, to a float32 sum left to right over the group's rows."""
    keys, mask = _group_inputs(rng)
    values = (rng.standard_normal(keys.shape[0]) * 10.0 ** rng.integers(-3, 4, keys.shape[0])).astype(np.float32)
    gk, gv, n = relational.group_aggregate(t(keys), t(values), 64, agg="sum", mask=t(mask))
    for slot, key in enumerate(gk.numpy()[: int(n)]):
        acc = np.float32(0)
        for v in values[(keys == key) & mask]:
            acc = np.float32(acc + v)
        assert gv.numpy()[slot].view(np.uint32) == acc.view(np.uint32), key
