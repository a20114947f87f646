"""Relational operators on the device — port of ``fenix_tpu/ops/relational.py``:
filter compaction, sorts, lookup and inner joins, group-by aggregates.

Filter compaction: the JAX package packs the True rows of a mask to the
front with one stable sort (XLA lowers it to the TPU's sort unit). Here a
prefix count gives every True row its slot and one scatter writes it
there: the same output, in linear work.

Sorts are stable (``torch.sort(stable=True)``), so a build side with
duplicate keys keeps row order and a lookup's first match is the row of
the smallest original index. Group-by sorts by (validity, key): a masked
row never merges with a real group keyed ``INT32_MAX``, groups come out in
ascending key order, slots past the group count carry ``INT32_MAX``.

The float aggregate accumulates in float32, as the JAX package does.
``group_aggregate_int`` accumulates in int64 on the card and returns the
aggregates themselves: int64 for sum / count / min / max and the exact
ratio in float64 for mean. The JAX package's limb lanes (``_limb_plan``,
``unpack_int_aggregate``) have no counterpart here: they spread an int64
sum over 6-bit int32 limbs only because JAX runs with x64 off, and a CUDA
card adds int64 natively. The results are the same exact int64.

``hash_partition`` is the shuffle's destination hash
(``parallel/shuffle.py``): the murmur3 finalizer over the low 32 bits of
the key, bit-equal to ``native.hash_partition``. torch has no uint32
arithmetic on a card, so the hash runs in int64 held below 2^32.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1

_AGGS = ("sum", "count", "min", "max", "mean")


# -- sort -----------------------------------------------------------------


def sort_kv(keys: torch.Tensor, values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort of (keys, values) pairs."""
    sk, perm = torch.sort(keys, stable=True)
    return sk, values[perm]


def argsort_stable(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, stable=True).indices.to(torch.int32)


def sort_with_index(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys, original positions as int32) — the build side of a
    lookup join, cached per table revision (``DeviceCache.sorted_key``)."""
    sk, perm = torch.sort(keys, stable=True)
    return sk, perm.to(torch.int32)


# -- filter → compaction --------------------------------------------------


def compact_indices(mask: torch.Tensor, width: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched filter compaction of ``[..., N]`` bool masks: the indices of
    the True entries of each row, in ascending order, packed to the front
    and padded with ``N``, cut to ``width`` columns (``N`` when None), as
    int32; and each row's True count, as int32."""
    n = mask.shape[-1]
    w = n if width is None else width
    slot = torch.cumsum(mask, dim=-1) - 1  # the slot of each True entry
    # False entries and True entries past the width go to a spare column
    dest = torch.where(mask & (slot < w), slot, w)
    iota = torch.arange(n, dtype=torch.int32, device=mask.device).expand(mask.shape)
    packed = torch.full((*mask.shape[:-1], w + 1), n, dtype=torch.int32, device=mask.device)
    packed.scatter_(-1, dest, iota)
    count = mask.sum(dim=-1, dtype=torch.int32)
    return packed[..., :w], count


def compact(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """1-D form of :func:`compact_indices`: ``(indices padded with N,
    count)``; the selected rows are ``indices[:count]``."""
    return compact_indices(mask)


# -- join -----------------------------------------------------------------


def join_lookup_sorted(
    left_keys: torch.Tensor, sorted_keys: torch.Tensor, sorted_index: torch.Tensor
) -> torch.Tensor:
    """Probe side of the lookup join against a pre-sorted build side: the
    original position of each left key's first match, or −1 (int32)."""
    n = sorted_keys.shape[0]
    left_keys = left_keys.to(sorted_keys.dtype)
    pos = torch.searchsorted(sorted_keys, left_keys, side="left").clamp(0, n - 1)
    hit = sorted_keys[pos] == left_keys
    return torch.where(hit, sorted_index[pos], -1).to(torch.int32)


def join_lookup(left_keys: torch.Tensor, right_keys: torch.Tensor) -> torch.Tensor:
    """Primary-key (enrichment) join: for each left key, the index of a
    matching row of ``right_keys`` or −1. ``right_keys`` need not be sorted
    or unique; with duplicates the first occurrence wins."""
    return join_lookup_sorted(left_keys, *sort_with_index(right_keys))


def join_inner_sorted(
    left_keys: torch.Tensor,
    sorted_keys: torch.Tensor,
    sorted_index: torch.Tensor,
    max_matches: int,
    n_valid: "int | torch.Tensor | None" = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """General inner join against a pre-sorted build side: (left_idx
    [max_matches], right_idx [max_matches], count), int32; pairs past
    ``count`` are (−1, −1). Pairs come in left-row order, duplicates in
    right-row order. ``count`` is the true pair total, which may exceed
    ``max_matches`` (the caller raises).

    ``n_valid``: the length of the valid prefix of the sorted build side
    when it carries an ``INT32_MAX`` padding tail (``sorted_key`` pads that
    way; the stable sort keeps real ``INT32_MAX`` keys ahead of it).
    Without the clamp a real ``INT32_MAX`` probe would count every padding
    slot as a match."""
    n_right = sorted_keys.shape[0]
    device = sorted_keys.device
    left_keys = left_keys.to(sorted_keys.dtype)
    lo = torch.searchsorted(sorted_keys, left_keys, side="left")
    hi = torch.searchsorted(sorted_keys, left_keys, side="right")
    if n_valid is not None:
        lo = lo.clamp_max(n_valid)
        hi = hi.clamp_max(n_valid)
    counts = hi - lo  # matches per left row (int64)
    ends = torch.cumsum(counts, dim=0)
    starts = ends - counts
    total = counts.sum()

    out = torch.arange(max_matches, device=device)
    # the left row each output slot belongs to
    owner = torch.searchsorted(ends, out, side="right").clamp(0, max(left_keys.shape[0] - 1, 0))
    if left_keys.shape[0] == 0:
        empty = torch.full((max_matches,), -1, dtype=torch.int32, device=device)
        return empty, empty.clone(), total.to(torch.int32)
    ridx = sorted_index[(lo[owner] + out - starts[owner]).clamp(0, n_right - 1)]
    valid = out < total
    return (
        torch.where(valid, owner, -1).to(torch.int32),
        torch.where(valid, ridx, -1).to(torch.int32),
        total.to(torch.int32),
    )


def join_inner(
    left_keys: torch.Tensor, right_keys: torch.Tensor, max_matches: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """General inner join on single keys (unsorted build side): sort +
    :func:`join_inner_sorted`."""
    return join_inner_sorted(left_keys, *sort_with_index(right_keys), max_matches)


# -- group-by aggregate ---------------------------------------------------


def _group_prep(keys: torch.Tensor, values: torch.Tensor, mask: "torch.Tensor | None"):
    """Sort by (validity, key), stably: (sorted keys, sorted values, group
    index [N] int64 ascending, new-group flags, masked-group count 0/1).
    Masked rows sort after every valid row whatever their key and collapse
    into one trailing group, which the caller subtracts."""
    keys = keys.to(torch.int32)
    if mask is None:
        inval = torch.zeros_like(keys, dtype=torch.int64)
    else:
        inval = (~mask).to(torch.int64)
        keys = torch.where(mask, keys, 0)
    # one stable sort on the packed (validity, key) pair
    packed = (inval << 32) | (keys.to(torch.int64) + 2**31)
    sp, perm = torch.sort(packed, stable=True)
    sk, sv = keys[perm], values[perm]
    new_group = torch.ones_like(sp, dtype=torch.bool)
    new_group[1:] = sp[1:] != sp[:-1]
    gid = torch.cumsum(new_group, dim=0) - 1
    dropped = (sp[-1] >> 32) if sp.numel() else sp.new_zeros(())
    return sk, sv, gid, new_group, dropped


def _group_keys_count(sk, gid, new_group, max_groups: int, dropped):
    """(group keys [max_groups] int32, group count, valid-slot mask). Slots
    at or past the count carry ``INT32_MAX``; consumers slice by the count
    (a real group keyed ``INT32_MAX`` is a valid slot below it)."""
    n_groups = (gid[-1] + 1 - dropped) if gid.numel() else gid.new_zeros(())
    group_keys = torch.full((max_groups + 1,), INT32_MAX, dtype=torch.int32, device=sk.device)
    first = new_group.nonzero().squeeze(1)
    group_keys.index_copy_(0, gid[first].clamp_max(max_groups), sk[first])
    valid = torch.arange(max_groups, device=sk.device) < n_groups
    group_keys = torch.where(valid, group_keys[:max_groups], INT32_MAX)
    return group_keys, n_groups.to(torch.int32), valid


def _segment(values: torch.Tensor, gid: torch.Tensor, max_groups: int, reduce: str) -> torch.Tensor:
    """Per-group reduction of ``values`` over ``gid``; groups at or past
    ``max_groups`` are dropped. Empty groups read 0. A sum adds each
    group's values in row order, on the CPU and the card alike (an
    accumulating ``index_put_`` sorts the slots stably; ``index_add_``
    adds floats by atomics on a card, in an order that varies from run to
    run), so a replayed aggregate has the same bits."""
    slot = gid.clamp_max(max_groups)  # a spare slot swallows the overflow
    out = values.new_zeros(max_groups + 1)
    if reduce == "sum":
        out.index_put_((slot,), values, accumulate=True)
    else:
        out.scatter_reduce_(0, slot, values, reduce, include_self=False)
    return out[:max_groups]


def group_aggregate(
    keys: torch.Tensor,
    values: torch.Tensor,
    max_groups: int,
    agg: str = "sum",
    mask: "torch.Tensor | None" = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group ``values`` by ``keys`` (hash-aggregate equivalent), in float32:
    (group keys [max_groups] int32 ascending, aggregates [max_groups]
    float32, true group count int32). Slots past the count carry key
    ``INT32_MAX`` and aggregate 0. Use :func:`group_aggregate_int` for
    integer value columns (float32 rounds integer sums past 2^24)."""
    if agg not in _AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    sk, sv, gid, new_group, dropped = _group_prep(keys, values, mask)
    sv = sv.to(torch.float32)
    if agg == "count":
        out = _segment(torch.ones_like(sv), gid, max_groups, "sum")
    elif agg == "sum":
        out = _segment(sv, gid, max_groups, "sum")
    elif agg == "mean":
        s = _segment(sv, gid, max_groups, "sum")
        c = _segment(torch.ones_like(sv), gid, max_groups, "sum")
        out = s / c.clamp_min(1.0)
    else:
        out = _segment(sv, gid, max_groups, "amin" if agg == "min" else "amax")
    group_keys, n_groups, valid = _group_keys_count(sk, gid, new_group, max_groups, dropped)
    return group_keys, torch.where(valid, out, 0.0), n_groups


def group_sum_count(
    keys: torch.Tensor,
    values: torch.Tensor,
    max_groups: int,
    mask: "torch.Tensor | None" = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(group keys, float32 sums, float32 counts, group count) in one sort
    pass: the partials of a mean that ships sum and count apart."""
    sk, sv, gid, new_group, dropped = _group_prep(keys, values, mask)
    sv = sv.to(torch.float32)
    s = _segment(sv, gid, max_groups, "sum")
    c = _segment(torch.ones_like(sv), gid, max_groups, "sum")
    group_keys, n_groups, valid = _group_keys_count(sk, gid, new_group, max_groups, dropped)
    return group_keys, torch.where(valid, s, 0.0), torch.where(valid, c, 0.0), n_groups


def group_aggregate_int(
    keys: torch.Tensor,
    values: torch.Tensor,
    max_groups: int,
    agg: str = "sum",
    mask: "torch.Tensor | None" = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact integer group aggregate: (group keys [max_groups] int32,
    aggregates [max_groups], group count int32). The values are taken as
    int32 (the device type of integer columns) and accumulate in int64:
    sum / count / min / max come back int64, mean as the exact ratio
    ``sum / count`` in float64 — the JAX package's unpacked lanes."""
    if agg not in _AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    sk, sv, gid, new_group, dropped = _group_prep(keys, values.to(torch.int32), mask)
    sv = sv.to(torch.int64)
    if agg in ("sum", "mean"):
        out = _segment(sv, gid, max_groups, "sum")
        if agg == "mean":
            c = _segment(torch.ones_like(sv), gid, max_groups, "sum")
            out = out.to(torch.float64) / c.clamp_min(1).to(torch.float64)
    elif agg == "count":
        out = _segment(torch.ones_like(sv), gid, max_groups, "sum")
    else:
        out = _segment(sv, gid, max_groups, "amin" if agg == "min" else "amax")
    group_keys, n_groups, valid = _group_keys_count(sk, gid, new_group, max_groups, dropped)
    return group_keys, torch.where(valid, out, torch.zeros_like(out)), n_groups


# -- hash partition (for the shuffle) -------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2^32`` for int64 ``x`` in [0, 2^32): ``c`` in 16-bit
    halves, so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def hash_partition(keys: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Partition id (int32) per key: the murmur3 finalizer over the key's
    low 32 bits, ``% num_partitions`` — the JAX package's
    ``relational.hash_partition`` and ``native.hash_partition``."""
    x = keys.to(torch.int64) & _MASK32
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x % num_partitions).to(torch.int32)
