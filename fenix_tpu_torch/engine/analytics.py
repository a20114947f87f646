"""Composite analytics queries: kNN search → device join → aggregate —
port of the single-device half of ``fenix_tpu/engine/analytics.py``.

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
the card. ``partitioned=True`` needs a mesh; with one device it is
downgraded loudly (a warning and ``join.partitioned_downgraded``), as in
the JAX package. Over a mesh every join and aggregate (``partitioned``
or not) raises ``NotImplementedError``: the partitioned and mesh-sharded
routes are ROADMAP queue 1 item 10 (c).
"""

from __future__ import annotations

import logging
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
    result rows drop, bounded by ``max_matches``. ``partitioned`` shards
    the attribute side over a mesh (ROADMAP queue 1 item 10 (c): raises);
    on one device it is downgraded with a warning."""

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


def _int_agg_mode(aggregate: AggregateSpec, value_col: "torch.Tensor | None") -> bool:
    """True when the aggregate runs exactly in int64: integer value columns
    (any agg) and pure counts. Distances and float columns stay float32."""
    if _uses_value_col(aggregate):
        return not value_col.is_floating_point() and value_col.dtype != torch.bool
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
    if n > g:
        raise ValueError(
            f"aggregate produced {n} distinct groups but max_groups={g}; "
            "raise aggregate.max_groups"
        )
    return pa.table({GROUP_COL: pa.array(host[:n]), AGG_COL: pa.array(vals[:n])})


def _attrs_device_entries(cache: DeviceCache, join: JoinSpec, aggregate: "AggregateSpec | None"):
    """The attribute side's device entries and host table under ONE
    revision: ``(sorted keys, positions, valid rows, group column, value
    column, host table)``. Each entry memoizes under its own stamp, so the
    read repeats until the table's stamp holds across all of them (a
    re-sorted key index must not meet a stale group column, nor row
    indices minted against one revision a host table of another)."""
    key = (join.source,) if isinstance(join.source, str) else tuple(join.source)

    def read():
        sorted_keys, sorted_index, attr_rows = cache.sorted_key(join.source, join.right_on)
        group_col = value_col = None
        if aggregate is not None:
            group_col = cache.scalar(join.source, aggregate.group_by).data
            if _uses_value_col(aggregate):
                value_col = cache.scalar(join.source, aggregate.value).data
        return sorted_keys, sorted_index, attr_rows, group_col, value_col, cache.host_table(join.source)

    value, _ = read_stable(lambda: cache._mtimes(key), read, f"table {join.source!r}")
    return value


def _downgrade_partitioned(join: JoinSpec) -> None:
    """One device replicates the attribute side (the JAX package's
    ``_use_partitioned`` without a mesh). ``partitioned=True`` is
    downgraded loudly: a silent downgrade would hide a misconfiguration
    for dimension tables sized past one device."""
    if join.partitioned:
        METRICS.add("join.partitioned_downgraded")
        LOGGER.warning(
            "join.partitioned=True but no serving mesh is active (one device) — "
            "replicating %r instead",
            join.source,
        )


def _pack_groups(groups, values, hit, agg: str, max_groups: int, int_values: bool):
    """Group the joined rows that ``hit``: (keys, aggregates, true group
    count) on the card."""
    if int_values:
        return relational.group_aggregate_int(groups, values, max_groups, agg=agg, mask=hit)
    return relational.group_aggregate(groups, values, max_groups, agg=agg, mask=hit)


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
    if value_col is not None:
        taken = value_col[safe]
        values = taken.to(torch.int32) if int_values else taken.to(torch.float32)
    else:
        values = left_values
    return _pack_groups(groups, values, hit, agg, max_groups, int_values)


def _fused_search(cache: DeviceCache, req, join: JoinSpec):
    """The fused route's search on the card over one revision of the
    search table: ``(host table, revision stamp, dists, ids, left keys)``,
    the last three ``[Q, k]`` for the top ``k`` winners (the keys of −1
    slots 0). The key column joins device row ids, so a mutation between
    the reads raises ``_StaleRevision``."""
    metric = distance_ops.canonical_metric(req.metric)
    data, corpus, snap_stamp = cache.snapshot(req.source, req.column)
    target = executor.normalize_target(
        req.target, ingest.vector_field_type(data.schema.field(req.column)).list_size
    )
    left_col = cache.scalar(req.source, join.left_on)
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
    queries = torch.tensor(target, device=cache.device)
    dist, ids = topk2.topk_two_phase(corpus.data, queries, aux_mul, aux_add, k=k_pad, metric=metric)
    dist, ids = dist[:, :k], ids[:, :k]
    left_keys = left_col.data[torch.where(ids >= 0, ids, 0)].to(torch.int32)
    return data, snap_stamp, dist, ids, left_keys


def _execute_fused(cache: DeviceCache, req, join: JoinSpec, aggregate: "AggregateSpec | None") -> pa.Table:
    """Search → join[→ aggregate] in one device pass (exact fp32, DUAL)."""
    METRICS.add("join.fused")
    _downgrade_partitioned(join)
    data, snap_stamp, dist, ids, left_keys = _fused_search(cache, req, join)
    sorted_keys, sorted_index, attr_rows, group_col, value_col, attrs_host = _attrs_device_entries(
        cache, join, aggregate
    )

    if aggregate is not None:
        int_values = _int_agg_mode(aggregate, value_col)
        if aggregate.value == executor.DIST_COL:
            left_values = dist.reshape(-1)
        else:  # ones: a count (exact on the int path) or a value column's dummy
            left_values = torch.ones(ids.numel(), dtype=torch.int32 if int_values else torch.float32,
                                     device=ids.device)
        groups = _join_aggregate_device(
            left_keys.reshape(-1), sorted_keys, sorted_index, attr_rows, group_col, value_col,
            left_values, agg=_device_agg(aggregate), max_groups=aggregate.max_groups,
            int_values=int_values, valid=(ids >= 0).reshape(-1),
        )
        return _groups_table(groups, aggregate.max_groups)

    # enrichment: one copy of (distances, result ids, attribute row index)
    ridx = relational.join_lookup_sorted(left_keys.reshape(-1), sorted_keys, sorted_index).reshape(ids.shape)
    ridx = torch.where((ridx < attr_rows) & (ids >= 0), ridx, -1)
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
    if cache.mesh is not None:
        raise NotImplementedError(
            "joins and aggregates over a mesh are not ported (ROADMAP queue 1 item 10 (c))"
        )
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
        for _ in range(4):
            try:
                return _execute_fused(cache, req, join, aggregate)
            except _StaleRevision:
                continue
        raise RuntimeError(f"table {req.source!r} kept changing during search")
    return _execute_two_step(cache, req, join, aggregate)


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


def _execute_two_step(cache: DeviceCache, req, join: JoinSpec, aggregate: "AggregateSpec | None") -> pa.Table:
    """Lookup join after a plain search (bf16 / int8 scans, IVF, host-corpus
    residency): the join and aggregate run on the card over the result's
    keys."""
    METRICS.add("join.two_step")
    result, left_keys_np = _search_left_keys(cache, req, join)
    if result.num_rows == 0:  # empty probe side: nothing to join
        if aggregate is not None:
            return _empty_groups_table(cache, join, aggregate)
        return _attach_join_columns(result, cache.host_table(join.source), np.empty(0, np.int32), join)
    _downgrade_partitioned(join)

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
        taken = value_col[safe_r]
        values = taken.to(torch.int32) if int_values else taken.to(torch.float32)
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
        if aggregate is not None:
            return _empty_groups_table(cache, join, aggregate)
        return _attach_join_columns(result, cache.host_table(join.source), np.empty(0, np.int32), join)
    _downgrade_partitioned(join)

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
