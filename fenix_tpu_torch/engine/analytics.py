"""Composite analytics queries: kNN search → device join → aggregate —
port of ``fenix_tpu/engine/analytics.py``.

BASELINE.json config 3: "kNN over embeddings joined to a 10M-row
attributes table, hash aggregate over match groups". The attribute
table's key column is sorted once per revision on the card
(``DeviceCache.sorted_key``); a search's winners are joined against it
(``ops.relational.join_lookup_sorted``) and the requested aggregate
reduces over the match groups on the card, so only the group table (or
the attribute row of each winner) comes back to the host.

Routes (counters ``join.fused``, ``join.two_step``, ``join.inner``):

- fused: an exact fp32 search with a metric that ``residency.plan``
  keeps in DUAL residency. One device pass: ``topk2.topk_two_phase`` →
  the winners' keys gathered from the search table's key column on the
  card → ``join_lookup_sorted`` → the group aggregate (or, with no
  aggregate, the attribute row index of each winner). The JAX package
  takes this route without asking the residency plan and builds the full
  device matrix of a table past the budget; here such a request takes
  the two-step route.
- two-step: every other lookup join (bf16 / int8 scans, IVF, host-corpus
  residency): ``executor.execute_search``, then the join and aggregate on
  the card over the result's keys.
- inner (``how="inner"``): the search, then ``join_inner_sorted``'s
  bounded expansion; every matching attribute row gives one output row,
  unmatched winners drop, ``max_matches`` bounds the pairs.

Integer value columns and counts aggregate exactly in int64
(``group_aggregate_int``), others in float32. Group keys are int32 on
the card.

Over a mesh (a cache with a ``mesh``) the fact side is row-sharded: the
fused route's search is the all-gather step of
``parallel.search.build_serving_search`` (never the ring, as in the JAX
package) over the sharded matrix and aux, with the filter folded in per
shard, and the winners' keys come from the sharded key column through
``parallel.search.gather_rowsharded``. The two-step and inner routes
search through the executor's mesh routes. The attribute side then takes
one of two placements (``_use_partitioned``: an explicit ``partitioned``
wins, else tables of at least ``FENIX_PART_ATTRS_MIN`` rows, default
2^20, are partitioned, the JAX package's rule and default):

- replicated: the join and aggregate run once, on the merged winners, on
  the card that holds them (the mesh's first device, where
  ``merge_candidates`` leaves them). So the sorted keys and the group and
  value columns are held once, on that card, where the JAX package's
  ``shard_map`` body holds them on every device; the answers are the
  same.
- partitioned (counter ``join.partitioned``): ``DeviceCache.parted_key``
  splits the globally sorted keys into one contiguous range per shard.
  Every shard binary-searches the probe keys in its range and claims a
  key iff it exceeds the previous range's last key (shard 0 on the bare
  match), so one shard claims each key's first global match. An
  aggregate builds a partial group table per shard (int64 sums and
  counts, float32 sums in row order; a mean ships its sum and count) and
  the host merges them exactly (``_merge_parted_tables``: int64, float64).
  An enrichment combines the claims by a max. An inner join expands each
  shard's pairs inside its range and orders them by (left row, global
  sorted position) on the host, where its aggregate finishes in numpy
  (``_inner_aggregate_host``).

With one device ``partitioned=True`` is downgraded loudly (a warning and
``join.partitioned_downgraded``), as in the JAX package.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from fenix_tpu_torch.engine import executor, residency
from fenix_tpu_torch.engine.session import DeviceCache, _StaleRevision
from fenix_tpu_torch.io import ingest
from fenix_tpu_torch.io.locks import read_stable
from fenix_tpu_torch.ops import distance as distance_ops
from fenix_tpu_torch.ops import relational, topk2
from fenix_tpu_torch.parallel import search as psearch
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

GROUP_COL = "__GROUP__"
AGG_COL = "__AGG__"

LOGGER = logging.getLogger("fenix_tpu_torch")


@dataclass
class JoinSpec:
    """Join search results to ``source`` where
    ``source.right_on == <search result>.left_on``.

    ``how="lookup"`` (default): enrichment — one attribute row per result
    row (first match wins; misses become nulls). ``how="inner"``: general
    inner join — result rows repeat per matching attribute row, unmatched
    result rows drop, bounded by ``max_matches``. ``partitioned`` splits
    the attribute side over a mesh in sorted key ranges instead of
    holding it whole; None routes by table size (``FENIX_PART_ATTRS_MIN``
    rows, default 2^20). On one device ``True`` is downgraded with a
    warning."""

    source: str | Sequence[str]
    right_on: str
    left_on: str = "id"
    columns: Sequence[str] | None = None  # None → all non-key columns
    how: str = "lookup"
    max_matches: int = 4096
    partitioned: bool | None = None

    @staticmethod
    def from_dict(obj: dict) -> "JoinSpec":
        how = obj.get("how", "lookup")
        if how not in ("lookup", "inner"):
            raise ValueError(f"unknown join how={how!r}; expected lookup|inner")
        return JoinSpec(
            source=obj["source"],
            right_on=obj["right_on"],
            left_on=obj.get("left_on", "id"),
            columns=obj.get("columns"),
            how=how,
            max_matches=int(obj.get("max_matches", 4096)),
            partitioned=obj.get("partitioned"),
        )


@dataclass
class AggregateSpec:
    """Group the joined rows by ``group_by`` (a column of the joined
    attribute table) and aggregate ``value`` with ``agg``."""

    group_by: str
    value: str | None = None  # None → count semantics
    agg: str = "count"
    max_groups: int = 1024

    @staticmethod
    def from_dict(obj: dict) -> "AggregateSpec":
        return AggregateSpec(
            group_by=obj["group_by"],
            value=obj.get("value"),
            agg=obj.get("agg", "count"),
            max_groups=obj.get("max_groups", 1024),
        )


def _uses_value_col(aggregate: AggregateSpec) -> bool:
    return aggregate.value is not None and aggregate.value != executor.DIST_COL


def _int_agg_mode(aggregate: AggregateSpec, value_col) -> bool:
    """True when the aggregate runs exactly in int64: integer value columns
    (any agg) and pure counts. Distances and float columns stay float32.
    ``value_col`` is a tensor or a ``Sharded`` one."""
    if _uses_value_col(aggregate):
        return not value_col.dtype.is_floating_point and value_col.dtype != torch.bool
    return aggregate.value is None and aggregate.agg == "count"


def _device_agg(aggregate: AggregateSpec) -> str:
    """The aggregate the device runs: a count with no value column sums
    ones."""
    if aggregate.value is None and aggregate.agg == "count":
        return "sum"
    return aggregate.agg


def _empty_groups_table(cache: DeviceCache, join: JoinSpec, aggregate: AggregateSpec) -> pa.Table:
    """The empty aggregate result, with the column types a non-empty run of
    the same query gives (int64 on the exact integer path unless mean,
    float64 otherwise)."""
    if _uses_value_col(aggregate):
        try:
            field = cache.host_table(join.source).schema.field(aggregate.value)
            int_lane = pa.types.is_integer(field.type)
        except KeyError:
            int_lane = False
    else:
        int_lane = aggregate.value is None and aggregate.agg == "count"
    agg_type = pa.int64() if int_lane and aggregate.agg != "mean" else pa.float64()
    return pa.table({GROUP_COL: pa.array([], pa.int64()), AGG_COL: pa.array([], agg_type)})


def _check_groups(n: int, g: int) -> None:
    if n > g:
        raise ValueError(
            f"aggregate produced {n} distinct groups but max_groups={g}; "
            "raise aggregate.max_groups"
        )


def _groups_table(groups: "tuple[torch.Tensor, torch.Tensor, torch.Tensor]", max_groups: int) -> pa.Table:
    """The device's (group keys, aggregates, group count) as a table, in one
    device→host copy. Aggregates are int64 on the exact integer path
    (float64 for its mean), float32 widened to float64 otherwise. More
    groups than ``max_groups`` raise rather than truncate."""
    keys, values, n = groups
    g = max_groups
    bits = values.to(torch.float64).view(torch.int64) if values.is_floating_point() else values
    host = torch.cat([keys.to(torch.int64), bits.to(torch.int64), n.reshape(1).to(torch.int64)]).cpu().numpy()
    vals = host[g : 2 * g]
    if values.is_floating_point():
        vals = vals.view(np.float64)
    n = int(host[2 * g])
    _check_groups(n, g)
    return pa.table({GROUP_COL: pa.array(host[:n]), AGG_COL: pa.array(vals[:n])})


def _attrs_key(join: JoinSpec) -> tuple:
    return (join.source,) if isinstance(join.source, str) else tuple(join.source)


def _attrs_device_entries(cache: DeviceCache, join: JoinSpec, aggregate: "AggregateSpec | None"):
    """The attribute side's device entries and host table under ONE
    revision: ``(sorted keys, positions, valid rows, group column, value
    column, host table)``. Each entry memoizes under its own stamp, so the
    read repeats until the table's stamp holds across all of them (a
    re-sorted key index must not meet a stale group column, nor row
    indices minted against one revision a host table of another)."""

    def read():
        sorted_keys, sorted_index, attr_rows = cache.sorted_key(join.source, join.right_on)
        group_col = value_col = None
        if aggregate is not None:
            group_col = cache.scalar(join.source, aggregate.group_by).data
            if _uses_value_col(aggregate):
                value_col = cache.scalar(join.source, aggregate.value).data
        return sorted_keys, sorted_index, attr_rows, group_col, value_col, cache.host_table(join.source)

    value, _ = read_stable(lambda: cache._mtimes(_attrs_key(join)), read, f"table {join.source!r}")
    return value


def _attrs_parted_entries(cache: DeviceCache, join: JoinSpec, aggregate: "AggregateSpec | None"):
    """The partitioned attribute side under ONE revision, as
    :func:`_attrs_device_entries` reads the replicated one: ``(sorted
    keys, original rows, bounds, valid rows, group column, value column,
    host table)``, the keys and columns split in sorted-key order."""

    def read():
        pk, pi, bounds, rows, _ = cache.parted_key(join.source, join.right_on)
        group_col = value_col = None
        if aggregate is not None:
            group_col = cache.parted_scalar(join.source, aggregate.group_by, join.right_on)
            if _uses_value_col(aggregate):
                value_col = cache.parted_scalar(join.source, aggregate.value, join.right_on)
        return pk, pi, bounds, rows, group_col, value_col, cache.host_table(join.source)

    value, _ = read_stable(lambda: cache._mtimes(_attrs_key(join)), read, f"table {join.source!r}")
    return value


def _use_partitioned(cache: DeviceCache, join: JoinSpec) -> bool:
    """Whether the attribute side is partitioned over the mesh: an explicit
    ``partitioned`` wins; otherwise tables of at least
    ``FENIX_PART_ATTRS_MIN`` rows (default 2^20, the JAX package's) are.
    One device replicates, and ``partitioned=True`` there is downgraded
    loudly: a silent downgrade would hide a misconfiguration for dimension
    tables sized past one device."""
    if cache.mesh is None:
        if join.partitioned:
            METRICS.add("join.partitioned_downgraded")
            LOGGER.warning(
                "join.partitioned=True but no serving mesh is active (one device) — "
                "replicating %r instead",
                join.source,
            )
        return False
    if join.partitioned is not None:
        return bool(join.partitioned)
    threshold = int(os.environ.get("FENIX_PART_ATTRS_MIN", str(1 << 20)))
    return cache.host_table(join.source).num_rows >= threshold


def _pack_groups(groups, values, hit, agg: str, max_groups: int, int_values: bool):
    """Group the joined rows that ``hit``: (keys, aggregates, true group
    count) on the card."""
    if int_values:
        return relational.group_aggregate_int(groups, values, max_groups, agg=agg, mask=hit)
    return relational.group_aggregate(groups, values, max_groups, agg=agg, mask=hit)


def _taken_values(value_col, safe, int_values: bool):
    taken = value_col[safe]
    return taken.to(torch.int32) if int_values else taken.to(torch.float32)


def _join_aggregate_device(
    left_keys, sorted_keys, sorted_index, attr_rows: int, group_col, value_col, left_values,
    *, agg: str, max_groups: int, int_values: bool, valid=None,
):
    """Join probe + group gather + aggregate. The aggregated values are the
    attribute ``value_col`` at each match, or ``left_values`` (the
    result's distances, or ones for a count) when it is None. ``valid``
    masks probe rows that are not real winners."""
    ridx = relational.join_lookup_sorted(left_keys, sorted_keys, sorted_index)
    hit = (ridx >= 0) & (ridx < attr_rows)
    if valid is not None:
        hit &= valid
    safe = torch.where(hit, ridx, 0).long()
    groups = group_col[safe].to(torch.int32)
    values = _taken_values(value_col, safe, int_values) if value_col is not None else left_values
    return _pack_groups(groups, values, hit, agg, max_groups, int_values)


# -- the partitioned attribute side ------------------------------------------


def _local_join_claim(keys, valid, pk, pi, bound: int, attr_rows: int, first: bool):
    """One shard's claims of the probe ``keys`` against its sorted key
    range ``pk`` (original rows ``pi``): ``(hit, local sorted position)``.
    A key's first global match lies here iff the key exceeds ``bound``, the
    previous range's last key (every key of earlier ranges is at most
    that); the first shard has no predecessor and claims on the bare match,
    since no int32 bound lies below ``INT32_MIN``, a legal key. So exactly
    one shard claims each matched key, duplicates included."""
    pos = torch.searchsorted(pk, keys, side="left").clamp(0, pk.shape[0] - 1)
    hit = (pk[pos] == keys) & (pi[pos] < attr_rows)
    if valid is not None:
        hit &= valid
    if not first:
        hit &= keys > int(bound)
    return hit, pos


def _pack_groups_parted(groups, values, hit, agg: str, max_groups: int, int_values: bool):
    """One shard's PARTIAL group table ``(keys, lanes [max_groups, L],
    group count)``, its lanes combinable across shards: int64 sums,
    counts, minima or maxima (a mean ships sum and count); float32 sums
    (in row order), counts, minima or maxima (a mean ships sum and
    count)."""
    if int_values:
        if agg == "mean":
            gk, s, n = relational.group_aggregate_int(groups, values, max_groups, agg="sum", mask=hit)
            _, c, _ = relational.group_aggregate_int(groups, values, max_groups, agg="count", mask=hit)
            return gk, torch.stack([s, c], dim=1), n
        gk, v, n = relational.group_aggregate_int(groups, values, max_groups, agg=agg, mask=hit)
        return gk, v[:, None], n
    if agg == "mean":
        gk, s, c, n = relational.group_sum_count(groups, values, max_groups, mask=hit)
        return gk, torch.stack([s, c], dim=1), n
    gk, v, n = relational.group_aggregate(groups, values, max_groups, agg=agg, mask=hit)
    return gk, v[:, None], n


def _partial_packed(gk, lanes, n) -> torch.Tensor:
    """A partial table as one int64 vector on its device: keys, lanes (a
    float lane as its float64 bits), group count."""
    bits = lanes.to(torch.float64).view(torch.int64) if lanes.is_floating_point() else lanes.to(torch.int64)
    return torch.cat([gk.to(torch.int64), bits.reshape(-1), n.reshape(1).to(torch.int64)])


def _partial_from_host(host: np.ndarray, g: int, floating: bool) -> "tuple[np.ndarray, np.ndarray, int]":
    """(keys int64, lanes as int64 or float64, group count) of a
    :func:`_partial_packed` vector read back."""
    body = host[g:-1].reshape(g, -1)
    return host[:g], body.view(np.float64) if floating else body, int(host[-1])


def _parted_partials(mesh, entries, left_keys, valid, left_values, *, agg: str, max_groups: int,
                     int_values: bool) -> list:
    """Every shard's partial group table of the probe ``left_keys``
    (copied to each shard with ``valid`` and ``left_values``), on the
    host, in shard order: gathered to every process (``Mesh.gather``) and
    read back in one device→host copy."""
    pk, pi, bounds, attr_rows, p_group, p_value = entries
    keys_s = psearch.replicate(mesh, left_keys)
    valid_s = psearch.replicate(mesh, valid) if valid is not None else [None] * mesh.size
    values_s = psearch.replicate(mesh, left_values) if left_values is not None else [None] * mesh.size

    def part(s: int):
        hit, pos = _local_join_claim(keys_s[s], valid_s[s], pk.shards[s], pi.shards[s], bounds[s], attr_rows,
                                     s == 0)
        safe = torch.where(hit, pos, 0)
        groups = p_group.shards[s][safe].to(torch.int32)
        values = _taken_values(p_value.shards[s], safe, int_values) if p_value is not None else values_s[s]
        return _partial_packed(*_pack_groups_parted(groups, values, hit, agg, max_groups, int_values))

    host = torch.stack(mesh.gather(mesh.map(part))).cpu().numpy()
    return [_partial_from_host(h, max_groups, not int_values) for h in host]


def _parted_lookup(mesh, pk, pi, bounds, attr_rows: int, left_keys, valid) -> torch.Tensor:
    """The original attribute row of each probe key's first match, or −1,
    on the mesh's lead device: each shard's claims (unique per key),
    gathered, combined by a max."""
    keys_s = psearch.replicate(mesh, left_keys)
    valid_s = psearch.replicate(mesh, valid) if valid is not None else [None] * mesh.size

    def part(s: int) -> torch.Tensor:
        hit, pos = _local_join_claim(keys_s[s], valid_s[s], pk.shards[s], pi.shards[s], bounds[s], attr_rows,
                                     s == 0)
        return torch.where(hit, pi.shards[s][pos], -1)

    out = None
    for claim in mesh.gather(mesh.map(part)):
        out = claim if out is None else torch.maximum(out, claim)
    return out


def _merge_parted_tables(parts: list, max_groups: int, agg: str, int_values: bool) -> pa.Table:
    """Exact host merge of the shards' partial tables (``(keys, lanes,
    count)`` each): integer lanes in int64, float lanes in float64. More
    than ``max_groups`` groups on a shard or in the union raise."""
    g = max_groups
    keys, lanes = [], []
    for gk, body, n in parts:
        _check_groups(n, g)
        keys.append(gk[:n])
        lanes.append(body[:n])
    keys_cat, lanes_cat = np.concatenate(keys), np.concatenate(lanes)
    uniq, inv = np.unique(keys_cat, return_inverse=True)
    _check_groups(uniq.size, g)
    merged = np.zeros((uniq.size, lanes_cat.shape[1]), lanes_cat.dtype)
    if agg in ("sum", "count", "mean"):  # additive partials
        np.add.at(merged, inv, lanes_cat)
    elif agg == "min":
        merged[:] = lanes_cat.max() if lanes_cat.size else 0
        np.minimum.at(merged, inv, lanes_cat)
    else:
        merged[:] = lanes_cat.min() if lanes_cat.size else 0
        np.maximum.at(merged, inv, lanes_cat)
    if agg == "mean":  # the exact ratio, as the single-device int mean
        out = merged[:, 0].astype(np.float64) / np.maximum(merged[:, 1], 1).astype(np.float64)
    else:
        out = merged[:, 0]
    return pa.table({GROUP_COL: pa.array(uniq.astype(np.int64)), AGG_COL: pa.array(out)})


def _parted_inner_expand(cache: DeviceCache, left_keys_np: np.ndarray, join: JoinSpec):
    """``(left rows, attribute rows, pair total, attrs host table)`` of the
    inner join against the partitioned attribute side, in the replicated
    route's pair order. Each shard expands its range's matches of the
    probe keys (a run straddling a boundary gives each shard its segment;
    ranges clamp to the valid prefix, so an ``INT32_MAX`` probe counts no
    padding) into up to ``max_matches`` (left row, attribute row, global
    sorted position) triples; the host orders them by (left row, global
    sorted position). The bound is checked on the summed totals. The host
    table is the revision the rows were minted against."""
    pk, pi, _, attr_rows, _, _, attrs_host = _attrs_parted_entries(cache, join, None)
    mesh, m = cache.mesh, join.max_matches
    keys_s = psearch.replicate(mesh, torch.from_numpy(left_keys_np.astype(np.int32)))

    def part(s: int):
        pk_l, pi_l, keys = pk.shards[s], pi.shards[s], keys_s[s]
        nloc = pk_l.shape[0]
        n_valid = (pi_l < attr_rows).sum()
        lo = torch.minimum(torch.searchsorted(pk_l, keys, side="left"), n_valid)
        hi = torch.minimum(torch.searchsorted(pk_l, keys, side="right"), n_valid)
        counts = hi - lo
        ends = torch.cumsum(counts, dim=0)
        starts = ends - counts
        total = counts.sum()
        out = torch.arange(m, device=pk_l.device)
        owner = torch.searchsorted(ends, out, side="right").clamp(0, keys.shape[0] - 1)
        lpos = (lo[owner] + out - starts[owner]).clamp(0, nloc - 1)
        ri = pi_l[lpos].long()
        ok = (out < total) & (ri < attr_rows)
        packed = torch.stack([torch.where(ok, owner, -1), torch.where(ok, ri, -1), torch.where(ok, s * nloc + lpos, 0)])
        return packed.cpu().numpy(), int(total)

    parts = mesh.map(part)
    total = sum(t for _, t in parts)
    _check_matches(total, join)
    packed = np.concatenate([p[:, p[0] >= 0] for p, _ in parts], axis=1)
    li, ri, gpos = packed
    order = np.lexsort((gpos, li))
    return li[order], ri[order], total, attrs_host


def _inner_aggregate_host(attrs: pa.Table, result: pa.Table, li: np.ndarray, ri: np.ndarray,
                          aggregate: AggregateSpec) -> pa.Table:
    """An aggregate over inner-join match pairs finished on the host in
    numpy (the partitioned route's pairs are on the host already): integer
    value columns and counts exactly in int64, others in float64. ``attrs``
    is the revision the row indices were minted against."""
    groups = np.asarray(attrs.column(aggregate.group_by))[ri].astype(np.int64)
    agg = aggregate.agg
    if _uses_value_col(aggregate):
        values = np.asarray(attrs.column(aggregate.value))[ri]
        int_values = np.issubdtype(values.dtype, np.integer)
    elif aggregate.value == executor.DIST_COL:
        values = np.asarray(result.column(executor.DIST_COL), dtype=np.float64)[li]
        int_values = False
    else:  # count semantics: one unit per match pair
        values = np.ones(len(ri), np.int64)
        int_values = True
        agg = _device_agg(aggregate)
    values = values.astype(np.int64 if int_values else np.float64)

    uniq, inv = np.unique(groups, return_inverse=True)
    _check_groups(uniq.size, aggregate.max_groups)
    if agg in ("sum", "count"):
        out = np.zeros(uniq.size, values.dtype)
        np.add.at(out, inv, values)
    elif agg == "mean":
        s = np.zeros(uniq.size, np.float64)
        c = np.zeros(uniq.size, np.float64)
        np.add.at(s, inv, values.astype(np.float64))
        np.add.at(c, inv, 1.0)
        out = s / np.maximum(c, 1.0)
    elif agg == "min":
        out = np.full(uniq.size, values.max(initial=0), values.dtype)
        np.minimum.at(out, inv, values)
    elif agg == "max":
        out = np.full(uniq.size, values.min(initial=0), values.dtype)
        np.maximum.at(out, inv, values)
    else:
        raise ValueError(f"unknown agg {aggregate.agg!r}")
    return pa.table({GROUP_COL: pa.array(uniq), AGG_COL: pa.array(out)})


# -- the fused route ------------------------------------------------------------


def _fused_search(cache: DeviceCache, req, join: JoinSpec):
    """The fused route's search over one revision of the search table:
    ``(host table, revision stamp, dists, ids, left keys)``, the last three
    ``[Q, k]`` for the top ``k`` winners (the keys of −1 slots 0) on the
    card (over a mesh, on its first device: the sharded search's
    all-gather merge, then the keys through ``gather_rowsharded``). The
    key column joins device row ids, so a mutation between the reads
    raises ``_StaleRevision``."""
    metric = distance_ops.canonical_metric(req.metric)
    mesh = cache.mesh
    sharded = mesh is not None
    data, corpus, snap_stamp = cache.snapshot(req.source, req.column, sharded=sharded)
    target = executor.normalize_target(
        req.target, ingest.vector_field_type(data.schema.field(req.column)).list_size
    )
    left_col = cache.scalar(req.source, join.left_on, sharded=sharded)
    if sharded:
        aux_mul, aux_add = cache.sharded_aux(req.source, req.column, metric)
    else:
        aux_mul, aux_add = cache.metric_aux(req.source, req.column, metric)
    plan = executor._FilterPlan(
        cache, req.source, req.column, req.filter, data, corpus.rows_padded, corpus.rows
    )
    aux_add = plan.overlay(aux_add)
    if left_col.rows_padded != corpus.rows_padded:
        raise _StaleRevision
    executor._check_revision(cache, req.source, req.column, None, snap_stamp)

    k = int(min(req.maxval, corpus.rows))
    k_pad = min(executor._canonical_k(k), corpus.rows_padded)
    if sharded:
        queries = torch.tensor(target, device=mesh.devices[0])
        search = psearch.build_serving_search(mesh, k_pad, metric)
        dist, ids = search(corpus.data, queries, aux_mul, aux_add)
        dist, ids = dist[:, :k], ids[:, :k]
        left_keys = psearch.gather_rowsharded(left_col.data, ids, ids >= 0).to(torch.int32)
    else:
        queries = torch.tensor(target, device=cache.device)
        dist, ids = topk2.topk_two_phase(corpus.data, queries, aux_mul, aux_add, k=k_pad, metric=metric)
        dist, ids = dist[:, :k], ids[:, :k]
        left_keys = left_col.data[torch.where(ids >= 0, ids, 0)].to(torch.int32)
    return data, snap_stamp, dist, ids, left_keys


def _winner_values(aggregate: AggregateSpec, dist, int_values: bool) -> "torch.Tensor | None":
    """The per-winner values of an aggregate that reads no attribute value
    column: the distances, or ones for a count."""
    if _uses_value_col(aggregate):
        return None
    if aggregate.value == executor.DIST_COL:
        return dist.reshape(-1)
    return torch.ones(dist.numel(), dtype=torch.int32 if int_values else torch.float32, device=dist.device)


def _execute_fused(cache: DeviceCache, req, join: JoinSpec, aggregate: "AggregateSpec | None") -> pa.Table:
    """Search → join[→ aggregate] in one device pass (exact fp32, DUAL);
    over a mesh, on the replicated or the partitioned attribute side."""
    METRICS.add("join.fused")
    parted = _use_partitioned(cache, join)
    data, snap_stamp, dist, ids, left_keys = _fused_search(cache, req, join)
    valid = ids >= 0  # real winners: the queries are not padded and the slots are cut to k
    if parted:
        METRICS.add("join.partitioned")
        pk, pi, bounds, attr_rows, p_group, p_value, attrs_host = _attrs_parted_entries(cache, join, aggregate)
    else:
        sorted_keys, sorted_index, attr_rows, group_col, value_col, attrs_host = _attrs_device_entries(
            cache, join, aggregate
        )

    if aggregate is not None:
        int_values = _int_agg_mode(aggregate, p_value if parted else value_col)
        left_values = _winner_values(aggregate, dist, int_values)
        if parted:
            parts = _parted_partials(
                cache.mesh, (pk, pi, bounds, attr_rows, p_group, p_value), left_keys.reshape(-1),
                valid.reshape(-1), left_values, agg=_device_agg(aggregate), max_groups=aggregate.max_groups,
                int_values=int_values,
            )
            return _merge_parted_tables(parts, aggregate.max_groups, _device_agg(aggregate), int_values)
        groups = _join_aggregate_device(
            left_keys.reshape(-1), sorted_keys, sorted_index, attr_rows, group_col, value_col,
            left_values, agg=_device_agg(aggregate), max_groups=aggregate.max_groups,
            int_values=int_values, valid=valid.reshape(-1),
        )
        return _groups_table(groups, aggregate.max_groups)

    # enrichment: one copy of (distances, result ids, attribute row index)
    if parted:
        ridx = _parted_lookup(cache.mesh, pk, pi, bounds, attr_rows, left_keys.reshape(-1), valid.reshape(-1))
        ridx = ridx.reshape(ids.shape).to(torch.int32)
    else:
        ridx = relational.join_lookup_sorted(left_keys.reshape(-1), sorted_keys, sorted_index).reshape(ids.shape)
        ridx = torch.where((ridx < attr_rows) & valid, ridx, -1)
    packed = torch.stack([dist.view(torch.int32), ids.to(torch.int32), ridx]).cpu().numpy()
    dists, ids_np, ridx_np = packed[0].view(np.float32), packed[1], packed[2]

    value_dtype = ingest.vector_field_type(data.schema.field(req.column)).value_type.to_pandas_dtype()
    select = [*req.select] if req.select is not None else data.column_names
    views = cache.host_column_views(req.source, data, snap_stamp)
    result = executor.gather_results(data, select + [executor.DIST_COL], dists, ids_np, value_dtype, views=views)
    # query-major over the valid winners: the row order gather_results keeps
    return _attach_join_columns(result, attrs_host, ridx_np[ids_np >= 0], join)


def _attach_join_columns(result: pa.Table, attrs: pa.Table, ridx_flat: np.ndarray, join: JoinSpec) -> pa.Table:
    """Append the joined attribute columns for each result row; misses
    become nulls, names the result already has are skipped."""
    hit = ridx_flat >= 0
    take = pa.array(np.where(hit, ridx_flat, 0).astype(np.int64))
    existing = set(result.column_names)
    columns = (
        [c for c in attrs.column_names if c != join.right_on and c not in existing]
        if join.columns is None
        else [*join.columns]
    )
    hit_arr = pa.array(hit)
    for name in columns:
        col = attrs.column(name).take(take).combine_chunks()
        if not hit.all():
            col = pc.if_else(hit_arr, col, pa.nulls(len(col), col.type))
        result = result.append_column(name, col)
    return result


def execute_search_join(
    cache: DeviceCache,
    req: executor.SearchRequest,
    join: JoinSpec,
    aggregate: AggregateSpec | None = None,
) -> pa.Table:
    """Search, join each result row to the attribute table, and return
    either the enriched rows or the aggregate over the match groups."""
    if req.maxval is None:
        raise ValueError("join/aggregate queries require maxval (top-k)")
    if join.how == "inner":
        return _execute_inner_join(cache, req, join, aggregate)
    if (
        req.coding is None
        and req.precision == "fp32"
        and req.metric is not None
        and residency.plan(cache, req) == residency.DUAL
    ):
        return executor._retry(lambda: _execute_fused(cache, req, join, aggregate), req.source)
    return _execute_two_step(cache, req, join, aggregate)


# -- the two-step and inner routes ----------------------------------------------


def _search_left_keys(cache: DeviceCache, req, join: JoinSpec) -> "tuple[pa.Table, np.ndarray]":
    """The plain search's result and its join keys as int64."""
    result = executor.execute_search(cache, req)
    left_keys = np.asarray(result.column(join.left_on)).astype(np.int64)
    info = np.iinfo(np.int32)
    if left_keys.size and (left_keys.max() > info.max or left_keys.min() < info.min):
        raise ValueError(
            f"join key {join.left_on!r} has values outside the device int32 range; re-key below 2^31"
        )
    return result, left_keys


def _left_values(result: pa.Table, aggregate: AggregateSpec, int_values: bool, device) -> "torch.Tensor | None":
    """The per-result-row values of an aggregate that reads no attribute
    value column: the result's distances, or ones for a count."""
    if _uses_value_col(aggregate):
        return None
    if aggregate.value == executor.DIST_COL:
        return torch.tensor(np.asarray(result.column(executor.DIST_COL), dtype=np.float32), device=device)
    return torch.ones(result.num_rows, dtype=torch.int32 if int_values else torch.float32, device=device)


def _empty_join(cache: DeviceCache, result: pa.Table, join: JoinSpec, aggregate: "AggregateSpec | None"):
    """The answer of a join whose probe side is empty."""
    if aggregate is not None:
        return _empty_groups_table(cache, join, aggregate)
    return _attach_join_columns(result, cache.host_table(join.source), np.empty(0, np.int32), join)


def _execute_two_step(cache: DeviceCache, req, join: JoinSpec, aggregate: "AggregateSpec | None") -> pa.Table:
    """Lookup join after a plain search (bf16 / int8 scans, IVF, host-corpus
    residency): the join and aggregate run on the card over the result's
    keys, or against the partitioned attribute side."""
    METRICS.add("join.two_step")
    result, left_keys_np = _search_left_keys(cache, req, join)
    if result.num_rows == 0:  # empty probe side: nothing to join
        return _empty_join(cache, result, join, aggregate)
    if _use_partitioned(cache, join):
        return _execute_parted_post(cache, result, left_keys_np, join, aggregate)

    sorted_keys, sorted_index, attr_rows, group_col, value_col, attrs_host = _attrs_device_entries(
        cache, join, aggregate
    )
    left_keys = torch.from_numpy(left_keys_np.astype(np.int32)).to(cache.device)
    if aggregate is not None:
        int_values = _int_agg_mode(aggregate, value_col)
        groups = _join_aggregate_device(
            left_keys, sorted_keys, sorted_index, attr_rows, group_col, value_col,
            _left_values(result, aggregate, int_values, cache.device),
            agg=_device_agg(aggregate), max_groups=aggregate.max_groups, int_values=int_values,
        )
        return _groups_table(groups, aggregate.max_groups)

    ridx = relational.join_lookup_sorted(left_keys, sorted_keys, sorted_index).cpu().numpy()
    return _attach_join_columns(result, attrs_host, np.where(ridx < attr_rows, ridx, -1), join)


def _execute_parted_post(cache: DeviceCache, result: pa.Table, left_keys_np: np.ndarray, join: JoinSpec,
                         aggregate: "AggregateSpec | None") -> pa.Table:
    """The two-step lookup join or aggregate against the partitioned
    attribute side: the result's keys (on the host) go to every shard,
    each shard claims its key range, as the fused route does after its
    search."""
    METRICS.add("join.partitioned")
    pk, pi, bounds, attr_rows, p_group, p_value, attrs_host = _attrs_parted_entries(cache, join, aggregate)
    left_keys = torch.from_numpy(left_keys_np.astype(np.int32))
    if aggregate is not None:
        int_values = _int_agg_mode(aggregate, p_value)
        parts = _parted_partials(
            cache.mesh, (pk, pi, bounds, attr_rows, p_group, p_value), left_keys, None,
            _left_values(result, aggregate, int_values, "cpu"), agg=_device_agg(aggregate),
            max_groups=aggregate.max_groups, int_values=int_values,
        )
        return _merge_parted_tables(parts, aggregate.max_groups, _device_agg(aggregate), int_values)
    ridx = _parted_lookup(cache.mesh, pk, pi, bounds, attr_rows, left_keys, None).cpu().numpy()
    return _attach_join_columns(result, attrs_host, ridx, join)


def _inner_join_aggregate_device(
    left_keys, sorted_keys, sorted_index, attr_rows: int, group_col, value_col, left_values,
    *, agg: str, max_groups: int, max_matches: int, int_values: bool,
):
    """Inner-join expansion + aggregate over the MATCH PAIRS: (the groups of
    ``_pack_groups``, the true pair total)."""
    li, ri, total = relational.join_inner_sorted(
        left_keys, sorted_keys, sorted_index, max_matches, n_valid=attr_rows
    )
    hit = (ri >= 0) & (ri < attr_rows)
    safe_r = torch.where(hit, ri, 0).long()
    groups = group_col[safe_r].to(torch.int32)
    if value_col is not None:
        values = _taken_values(value_col, safe_r, int_values)
    else:
        values = left_values[torch.where(li >= 0, li, 0).long()]
    return _pack_groups(groups, values, hit, agg, max_groups, int_values), total


def _check_matches(total: int, join: JoinSpec) -> None:
    if total > join.max_matches:
        raise ValueError(
            f"inner join produced {total} pairs but max_matches={join.max_matches}; "
            "raise join.max_matches"
        )


def _execute_inner_join(cache: DeviceCache, req, join: JoinSpec, aggregate: "AggregateSpec | None") -> pa.Table:
    """Search → general inner join: result rows repeat per matching
    attribute row (left-row order, then right-row order), unmatched result
    rows drop."""
    METRICS.add("join.inner")
    result, left_keys_np = _search_left_keys(cache, req, join)
    if result.num_rows == 0:  # empty probe side: nothing to expand
        return _empty_join(cache, result, join, aggregate)
    if _use_partitioned(cache, join):
        METRICS.add("join.partitioned")
        li, ri, _, attrs_host = _parted_inner_expand(cache, left_keys_np, join)
        if aggregate is not None:
            return _inner_aggregate_host(attrs_host, result, li, ri, aggregate)
        expanded = result.take(pa.array(li.astype(np.int64)))
        return _attach_join_columns(expanded, attrs_host, ri.astype(np.int64), join)

    sorted_keys, sorted_index, attr_rows, group_col, value_col, attrs_host = _attrs_device_entries(
        cache, join, aggregate
    )
    left_keys = torch.from_numpy(left_keys_np.astype(np.int32)).to(cache.device)
    if aggregate is not None:
        int_values = _int_agg_mode(aggregate, value_col)
        groups, total = _inner_join_aggregate_device(
            left_keys, sorted_keys, sorted_index, attr_rows, group_col, value_col,
            _left_values(result, aggregate, int_values, cache.device),
            agg=_device_agg(aggregate), max_groups=aggregate.max_groups,
            max_matches=join.max_matches, int_values=int_values,
        )
        _check_matches(int(total), join)
        return _groups_table(groups, aggregate.max_groups)

    li, ri, total = relational.join_inner_sorted(
        left_keys, sorted_keys, sorted_index, join.max_matches, n_valid=attr_rows
    )
    _check_matches(int(total), join)
    li, ri = li.cpu().numpy(), ri.cpu().numpy()
    valid = (li >= 0) & (ri >= 0) & (ri < attr_rows)
    expanded = result.take(pa.array(li[valid].astype(np.int64)))
    return _attach_join_columns(expanded, attrs_host, ri[valid], join)
