"""Arrow Flight serving surface: Server + client SDK — port of
``fenix_tpu/flight.py``.

The JSON wire is the contract, so the JAX package's ``fenix_tpu.Flight``
client drives this server unchanged, and this client drives either
server. ``do_put`` ingests a table (overwrite), ``do_get`` reads,
``do_exchange`` runs kNN search, ``do_action`` is the control plane.
Commands, tickets and action bodies are JSON; filters are
``fenix_tpu_torch.expr`` trees; the server keeps no session state.

IVF: ``make-coder`` trains a coder on the server's device,
``make-index`` assigns the table's rows to its cells, ``drop-index``
drops the coder and every index built from it, ``list-coders`` lists
coders, and a read with ``coding`` and ``column`` joins the
``__CODED_ID__`` column on. The server's ``stats`` show the probed
routes as ``search.ivf_clustered`` and ``search.ivf_scan``, the filter
routes as ``filter.device_pushdown`` and ``filter.host_upload`` (with
``cache.device_mask_builds``), and the no-top-k reads (``maxval=None``)
as ``search.nomax_full``, ``search.nomax_selected`` and
``search.residency_host_nomax``.

A search config with a ``join`` (and optionally an ``aggregate``) joins
its winners to an attribute table (``engine/analytics.py``; ``stats``:
``join.fused``, ``join.two_step``, ``join.inner``,
``join.partitioned_downgraded``, ``cache.sorted_key_seconds``); every
other search goes through the micro-batcher (``engine/batching.py``;
``batch.dispatches``, ``batch.requests``, ``batch.queries``,
``batch.drains``). On a card, ``stats`` also carries
``device.max_memory_allocated``.

Mutations: ``do_put`` in mode ``append`` adds a delta part and assigns
only its rows into every index, ``upsert`` replaces or inserts by a key
column and writes ``{"replaced", "inserted"}`` as the put's metadata;
``delete-rows`` filters a table and its indexes by one mask and
``compact-table`` folds the delta parts into the base. Searches after a
mutation refresh the device cache across the hop (``stats``:
``cache.incremental_refreshes``, ``cache.lineage_refreshes``).

``repartition`` hash-partitions a table into shard tables
(``parallel/distributed.py``; by default one per mesh device, else 2);
every verb resolves a repartitioned name
to its shards (append and upsert refuse one), and ``drop-table`` and an
overwrite put remove them. ``fault-inject`` arms failure points when the
server runs with ``FENIX_ENABLE_FAULT_INJECTION=1``.

Catalog discovery: ``list_flights`` lists every table of the root and
``get_flight_info`` gives one table's schema, its path descriptor, one
endpoint (a ``do_get`` ticket) and its row count.

Typed vector columns (``fenix_tpu_torch.types``: tensor, nested leaves,
quint8) are searched and returned as in the JAX package; the server
registers no extension type and reads them by name.

Diagnostics: with ``$FENIX_TRACE_DIR`` set, each search is captured by
``utils/profiling.trace`` into a Chrome trace under ``fenix.rpc.search``
(one capture at a time); a traced search goes through the micro-batcher
like any other, and the spans of the dispatcher's thread land in the
capture beside the handler's. Each search gets a request id, which its
``fenix.rpc.search`` span and its batch's ``batch.dispatch`` span carry;
the handler's own work is timed as ``flight.decode_seconds`` (the target)
and ``flight.encode_seconds`` (the result). With ``$FENIX_QUERY_LOG``
set, each search is appended to that query log (``utils/replay.py``).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import shutil
import time
from typing import Any, Iterator, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.flight as fl
import torch

from fenix_tpu_torch import coder as coder_mod
from fenix_tpu_torch import expr as expr_mod
from fenix_tpu_torch import index as index_mod
from fenix_tpu_torch import types
from fenix_tpu_torch.engine import executor, service
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.io.locks import catalog_lock
from fenix_tpu_torch.ops import kernels
from fenix_tpu_torch.parallel import distributed
from fenix_tpu_torch.utils import profiling, replay
from fenix_tpu_torch.utils.faults import GLOBAL as FAULTS
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

LOGGER = logging.getLogger("fenix_tpu_torch")

METRICS_SET: set[str] = {"cosine", "dot", "inner_product", "l2", "euclidean"}

# route counters, shown from the start: the JAX package's residency
# counters under its names, the two IVF routes, and the rows the host
# rescore reads (its timers, ``residency.phase_a_seconds``,
# ``residency.rescore_{gather,score}_seconds``, appear once they count;
# its spans are listed in ``engine/residency.py``)
_ROUTE_COUNTERS = (
    "search.ivf_clustered",
    "search.ivf_scan",
    "search.nomax_full",
    "search.nomax_selected",
    "search.residency_host_nomax",
    "filter.device_pushdown",
    "filter.host_upload",
    "search.residency_probed_host",
    "search.residency_int8",
    "search.residency_stream",
    "search.stream_chunks",
    "residency.rescore_rows",
    "cache.int8_sidecar_loads",
    "cache.int8_sidecar_writes",
    "cache.ivf_sidecar_loads",
    "cache.ivf_sidecar_writes",
    "cache.mirror_rows_quantized",
    "cache.mirror_delta_refreshes",
    "index.host_assigns",
    "batch.dispatches",
    "batch.requests",
    "batch.queries",
    "batch.drains",
    "join.fused",
    "join.two_step",
    "join.inner",
    "join.partitioned_downgraded",
)


def _dumps(obj: Any) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def _loads(raw: bytes) -> Any:
    return json.loads(raw.decode())


def _decode_filter(obj: Any) -> expr_mod.Expr | None:
    return None if obj is None else expr_mod.Expr.from_dict(obj)


class Server(fl.FlightServerBase):
    """Stateless Flight front-end over the query engine on ``device``."""

    def __init__(
        self, root: str, host: str = "0.0.0.0", port: int = 9001, device: str = "cuda"
    ) -> None:
        self.root = os.path.abspath(root)
        self.device = device
        self.grpc = f"grpc://{host}:{port}"
        self._search_ids = itertools.count(1)  # request ids of the searches' spans
        super().__init__(location=self.grpc)

    @property
    def cache(self) -> Any:
        return executor.get_cache(self.root, self.device)

    # -- ingest -----------------------------------------------------------

    def do_put(
        self,
        ctx: fl.ServerCallContext,
        descriptor: fl.FlightDescriptor,
        reader: fl.MetadataRecordBatchReader,
        writer: fl.FlightMetadataWriter,
    ) -> None:
        FAULTS.check("put")
        name = descriptor.path[0].decode()
        mode = descriptor.path[1].decode() if len(descriptor.path) > 1 else "overwrite"
        if mode != "overwrite" and distributed.load_manifest(self.root, name):
            raise ValueError(
                f"table {name!r} is repartitioned; append/upsert are not "
                "supported on a sharded name — overwrite it or re-ingest"
            )
        with METRICS.timed("put", table=name, mode=mode):
            match mode:
                case "overwrite":
                    # One lock scope: the rewrite and the index drop form a
                    # single catalog mutation.
                    with catalog_lock(self.root):
                        # a fresh table replaces any previous sharded form
                        distributed.drop_repartition(self.root, name)
                        table.make(self.root, name, reader.to_reader())
                        # Existing indexes are no longer row-aligned; drop
                        # them so probed search fails loudly instead of
                        # returning rows assigned under the previous revision.
                        index_mod.drop_for_source(self.root, name)
                case "append":
                    new = reader.to_reader().read_all()
                    # One lock scope: the table append and the index
                    # extension form one catalog mutation
                    with catalog_lock(self.root):
                        fresh = not os.path.exists(table.path_of(self.root, name))
                        table.append(self.root, name, new)
                        if fresh:
                            # a dropped-then-recreated table must not
                            # inherit leftover index files
                            index_mod.drop_for_source(self.root, name)
                        else:
                            index_mod.extend_for_source(self.root, name, new, self.device)
                case "upsert":
                    key = descriptor.path[2].decode() if len(descriptor.path) > 2 else "id"
                    new = reader.to_reader().read_all()
                    replaced, inserted = index_mod.upsert_rows(self.root, name, new, key=key, device=self.device)
                    writer.write(pa.py_buffer(_dumps({"replaced": replaced, "inserted": inserted})))
                case _:
                    raise ValueError(f"unknown put mode {mode!r}")

    # -- table read -------------------------------------------------------

    def do_get(self, ctx: fl.ServerCallContext, ticket: fl.Ticket):
        FAULTS.check("get")
        req = _loads(ticket.ticket)
        source = distributed.resolve_source(self.root, req["source"])
        coding, column = req.get("coding"), req.get("column")
        select = req.get("select")
        filter_ = _decode_filter(req.get("filter"))
        order_by = req.get("order_by")  # [[column, "ascending"|"descending"], ...]

        with METRICS.timed("get", source=source):
            if coding is not None and column is not None:
                data = index_mod.load(self.root, coding, source, column)
            else:
                data = table.load(self.root, source)
            if filter_ is not None:
                data = data.filter(pa.array(filter_.mask(data)))
            if order_by:
                data = data.take(pc.sort_indices(data, sort_keys=[(c, d) for c, d in order_by]))
            if select is not None:
                data = data.select(select)
            return fl.GeneratorStream(data.schema, data.to_reader())

    # -- search -----------------------------------------------------------

    def do_exchange(
        self,
        ctx: fl.ServerCallContext,
        descriptor: fl.FlightDescriptor,
        reader: fl.MetadataRecordBatchReader,
        writer: fl.MetadataRecordBatchWriter,
    ) -> None:
        FAULTS.check("search")
        config = _loads(descriptor.command)
        request = next(self._search_ids)
        # a trace per request behind $FENIX_TRACE_DIR (a no-op when unset; a
        # request during an active capture writes no file, its spans land in it)
        with profiling.trace(cuda=self.cache.device.type == "cuda"), profiling.annotate(
            "fenix.rpc.search", requests=(request,)
        ):
            with profiling.annotate("flight.decode", counter="flight.decode"):
                target_table = reader.read_all()
                # a typed target (tensor, quint8) arrives in its unregistered form
                target = types.typed_column(target_table, "target").combine_chunks()

            with METRICS.timed("search", source=config["source"], metric=config.get("metric")) as record:
                data = service.run_search_config(self.cache, config, target, request)
                record["rows_returned"] = data.num_rows
                # flat value column = one query (reference wire shape);
                # FixedSizeList (or typed) column = one query per row
                typed = isinstance(target, pa.ExtensionArray)
                record["queries"] = len(target) if typed or pa.types.is_fixed_size_list(target.type) else 1
                record["maxval"] = config.get("maxval")
                record["probes"] = config.get("probes")
                record["precision"] = config.get("precision") or "fp32"

            replay.record(config, target_table, data)

            with profiling.annotate("flight.encode", counter="flight.encode"):
                writer.begin(data.schema)
                writer.write_table(data)

    # -- control plane ----------------------------------------------------

    def do_action(self, ctx: fl.ServerCallContext, action: fl.Action) -> Iterator[fl.Result]:
        body = action.body.to_pybytes()
        config = _loads(body) if body else {}

        match action.type:
            case "make-coder":
                config["source"] = distributed.resolve_source(self.root, config["source"])
                with METRICS.timed("make-coder", coder=config.get("name")):
                    coder_mod.make(self.root, **config, device=self.device, mesh=self.cache.mesh)
                return iter([])

            case "make-index":
                config["source"] = distributed.resolve_source(self.root, config["source"])
                with METRICS.timed("make-index", coder=config.get("name")):
                    index_mod.make(self.root, **config, device=self.device)
                self.cache.invalidate()
                return iter([])

            case "drop-index":
                coder_mod.drop(self.root, config["name"])
                index_mod.drop_all(self.root, config["name"])
                self.cache.invalidate()
                return iter([])

            case "drop-table":
                # a repartitioned name drops its shard tables + manifest
                if not distributed.drop_repartition(self.root, config["name"]):
                    # indexes first: attribution needs the table's schema
                    index_mod.drop_for_source(self.root, config["name"])
                    table.drop(self.root, **config)
                self.cache.invalidate()
                return iter([])

            case "repartition":
                name = config["source"]
                mesh = self.cache.mesh
                num_shards = int(config.get("num_shards") or (mesh.size if mesh is not None else 2))
                with METRICS.timed("repartition", table=name, shards=num_shards):
                    manifest = distributed.repartition(
                        self.root, name, num_shards, key_column=config.get("key", "id"), mesh=mesh
                    )
                self.cache.invalidate()
                return iter([fl.Result(manifest.to_json().encode())])

            case "remove":
                shutil.rmtree(self.root, ignore_errors=True)
                self.cache.invalidate()
                return iter([])

            case "list-tables":
                return iter([fl.Result(_dumps([*table.list(self.root)]))])

            case "list-coders":
                return iter([fl.Result(_dumps([*coder_mod.list(self.root)]))])

            case "list-indexes":
                return iter([fl.Result(_dumps([*index_mod.list(self.root)]))])

            case "stats":
                snap = METRICS.snapshot()
                for name in _ROUTE_COUNTERS:  # shown from the start, as 0
                    snap.setdefault(name, 0.0)
                snap["cache.device_bytes"] = float(self.cache.device_bytes())
                snap["cache.evictions"] = float(self.cache.evictions)
                snap["cache.device_mask_builds"] = float(self.cache.device_mask_builds)
                snap["cache.incremental_refreshes"] = float(self.cache.incremental_refreshes)
                snap["cache.lineage_refreshes"] = float(self.cache.lineage_refreshes)
                for kind, count in self.cache.device_entry_kinds().items():
                    snap[f"cache.device_entries.{kind}"] = float(count)
                for name, count in [*kernels.LAUNCHES.items(), *kernels.DEVICE_LAUNCHES.items()]:
                    snap[f"kernel.{name}.launches"] = float(count)
                if self.cache.device.type == "cuda":
                    snap["device.max_memory_allocated"] = float(torch.cuda.max_memory_allocated(self.cache.device))
                return iter([fl.Result(_dumps(snap))])

            case "health":
                return iter([fl.Result(b'{"status":"ok"}')])

            case "fault-inject":
                # arm deterministic failure points — resilience testing
                # only, and only when the operator opted in (any client
                # could otherwise deny service with one request)
                if os.environ.get("FENIX_ENABLE_FAULT_INJECTION") != "1":
                    raise PermissionError(
                        "fault injection disabled; set "
                        "FENIX_ENABLE_FAULT_INJECTION=1 on the server"
                    )
                FAULTS.configure(config.get("spec", ""))
                return iter([])

            case "compact-table":
                # fold the delta parts into the base Arrow IPC file (the
                # at-rest form the reference reads), e.g. before a backup
                with METRICS.timed("compact", table=config["name"]):
                    table.compact(self.root, config["name"])
                return iter([])

            case "delete-rows":
                sources = distributed.resolve_source(self.root, config["source"])
                if isinstance(sources, str):
                    sources = [sources]
                filt = _decode_filter(config["filter"])
                with METRICS.timed("delete-rows", source=config["source"]):
                    # each shard's mask is its own: the counts sum
                    deleted = sum(index_mod.delete_rows(self.root, s, filt) for s in sources)
                return iter([fl.Result(_dumps({"deleted": deleted}))])

            case _:
                raise ValueError(f"unknown action {action.type!r}")

    # -- catalog discovery ------------------------------------------------

    def _flight_info(self, name: str) -> fl.FlightInfo:
        data = table.load(self.root, name)
        return fl.FlightInfo(
            data.schema,
            fl.FlightDescriptor.for_path(name),
            [fl.FlightEndpoint(_dumps({"source": name}), [])],
            data.num_rows,
            -1,
        )

    def get_flight_info(self, ctx: fl.ServerCallContext, descriptor: fl.FlightDescriptor) -> fl.FlightInfo:
        return self._flight_info(descriptor.path[0].decode())

    def list_flights(self, ctx: fl.ServerCallContext, criteria: bytes):
        for name in table.list(self.root):
            yield self._flight_info(name)


class Flight:
    """Client SDK for the verbs this package serves (the JAX package's
    ``fenix_tpu.Flight`` speaks the same wire).

    ``retries`` > 0 re-issues idempotent requests (search, reads, admin
    queries) on transient server failures with exponential backoff."""

    def __init__(self, host: str = "0.0.0.0", port: int = 9001, retries: int = 0) -> None:
        self.host = host
        self.port = port
        self.retries = retries
        self._conn: fl.FlightClient | None = None

    def _retrying(self, fn):
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except fl.FlightError as e:  # noqa: PERF203
                last = e
                if attempt < self.retries:
                    time.sleep(0.05 * (2**attempt))
        assert last is not None
        raise last

    @property
    def conn(self) -> fl.FlightClient:
        if self._conn is None:
            self._conn = fl.connect(f"grpc://{self.host}:{self.port}")
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

    # -- tables -----------------------------------------------------------

    def make_table(self, name: str, data: pa.RecordBatchReader) -> "Flight":
        return self._put(name, data, "overwrite")

    def append_table(self, name: str, data: pa.RecordBatchReader) -> "Flight":
        """Append rows to ``name`` (created if absent); the indexes over
        it assign only the appended rows."""
        return self._put(name, data, "append")

    def _put(self, name: str, data: pa.RecordBatchReader, mode: str) -> "Flight":
        descriptor = fl.FlightDescriptor.for_path(name, mode)
        writer, _ = self.conn.do_put(descriptor, data.schema)
        with writer:
            for batch in data:
                writer.write_batch(batch)
        return self

    def upsert_rows(self, name: str, data: pa.RecordBatchReader, key: str = "id") -> dict:
        """Replace or insert by ``key`` (the table is created if absent):
        rows whose key matches an incoming row are deleted, then the
        incoming rows are appended, in one catalog mutation. Returns
        ``{"replaced": n, "inserted": m}``. Not retried: the counts are
        not idempotent."""
        descriptor = fl.FlightDescriptor.for_path(name, "upsert", key)
        writer, meta_reader = self.conn.do_put(descriptor, data.schema)
        with writer:
            for batch in data:
                writer.write_batch(batch)
            writer.done_writing()
            buf = meta_reader.read()
        return _loads(buf.to_pybytes()) if buf is not None else {}

    def delete_rows(self, source: str, filter: expr_mod.Expr) -> int:
        """Delete the rows matching ``filter``; returns their count. The
        indexes over the table are filtered by the same mask. Not retried:
        a retry after a lost response would report 0 for rows the first
        attempt deleted."""
        if not isinstance(filter, expr_mod.Expr):
            raise TypeError("filter must be a fenix_tpu_torch.expr.Expr")
        action = fl.Action("delete-rows", _dumps({"source": source, "filter": filter.to_dict()}))
        return _loads([*self.conn.do_action(action)][0].body.to_pybytes())["deleted"]

    def compact_table(self, name: str) -> "Flight":
        """Fold the table's delta parts into its base file (idempotent)."""
        self._action("compact-table", {"name": name})
        return self

    def read_table(
        self,
        source: str | Sequence[str],
        select: Sequence[str] | None = None,
        filter: expr_mod.Expr | None = None,
        order_by: Sequence[tuple[str, str]] | None = None,
        coding: str | None = None,
        column: str | None = None,
    ) -> pa.RecordBatchReader:
        """Read a table; with ``coding`` and ``column`` the index's
        ``__CODED_ID__`` column is joined on."""
        if filter is not None and not isinstance(filter, expr_mod.Expr):
            raise TypeError("filter must be a fenix_tpu_torch.expr.Expr")
        ticket = fl.Ticket(
            _dumps(
                {
                    "source": source if isinstance(source, str) else [*source],
                    "coding": coding,
                    "column": column,
                    "select": [*select] if select is not None else None,
                    "filter": filter.to_dict() if filter is not None else None,
                    "order_by": (
                        [[c, d] for c, d in order_by] if order_by is not None else None
                    ),
                }
            )
        )
        return self._retrying(lambda: self.conn.do_get(ticket).to_reader())

    def drop_table(self, name: str) -> "Flight":
        self._action("drop-table", {"name": name})
        return self

    def repartition(self, source: str, num_shards: int | None = None, key: str = "id") -> dict:
        """Hash-partition ``source`` into ``num_shards`` shard tables (by
        default one per device of the server's mesh, else 2) keyed by
        ``key``; the name then resolves to the shards on every verb, and
        its indexes are dropped. Returns the manifest."""
        results = self._action("repartition", {"source": source, "num_shards": num_shards, "key": key})
        return _loads(results[0].body.to_pybytes())

    # -- index lifecycle --------------------------------------------------

    def make_index(
        self, name: str, source: str | Sequence[str], column: str, config: dict
    ) -> "Flight":
        """Train coder ``name`` over ``source.column`` with ``config``
        (metric, codebook_size, num_codebooks, batch_size, num_epochs),
        then assign the rows to its cells."""
        self._action(
            "make-coder", {"name": name, "source": source, "column": column, "config": dict(config)}
        )
        return self.sync_index(name, source, column)

    def sync_index(self, name: str, source: str | Sequence[str], column: str) -> "Flight":
        self._action("make-index", {"name": name, "source": source, "column": column})
        return self

    def drop_index(self, name: str) -> "Flight":
        self._action("drop-index", {"name": name})
        return self

    # -- search -----------------------------------------------------------

    def search(
        self,
        target: Any,
        source: str | Sequence[str],
        column: str,
        metric: str | None = None,
        select: Sequence[str] | None = None,
        filter: expr_mod.Expr | None = None,
        maxval: int | None = None,
        precision: str = "fp32",
        residency: str = "auto",
        extra: dict | None = None,
        coding: str | None = None,
        probes: int | None = None,
        join: dict | None = None,
        aggregate: dict | None = None,
    ) -> pa.Table:
        """k-NN search; with ``coding`` and ``probes`` an IVF search over
        the coder's ``probes`` nearest cells, whose metric is the
        default. ``join`` (the wire form of ``analytics.JoinSpec``: source,
        right_on, left_on, columns, how, max_matches, partitioned) joins
        each result row to an attribute table; with ``aggregate``
        (``analytics.AggregateSpec``: group_by, value, agg, max_groups) the
        answer is the group table (``__GROUP__``, ``__AGG__``)."""
        assert metric is None or metric in METRICS_SET, f"metric must be one of {sorted(METRICS_SET)}"
        assert precision in ("fp32", "bf16", "int8"), precision
        assert residency in ("auto", "dual", "int8", "stream"), residency
        assert extra is None or isinstance(extra, dict), extra
        if filter is not None and not isinstance(filter, expr_mod.Expr):
            raise TypeError("filter must be a fenix_tpu_torch.expr.Expr")

        descriptor = fl.FlightDescriptor.for_command(
            _dumps(
                {
                    "coding": coding,
                    "source": source if isinstance(source, str) else [*source],
                    "column": column,
                    "metric": metric,
                    "select": [*select] if select is not None else None,
                    "filter": filter.to_dict() if filter is not None else None,
                    "maxval": maxval,
                    "probes": probes,
                    "join": join,
                    "aggregate": aggregate,
                    "precision": precision,
                    "residency": residency,
                    # per-request knobs, e.g. {"window": ...} for the
                    # int8-resident / streaming rescore window
                    "extra": extra,
                }
            )
        )
        target = self._encode_target(target)

        def attempt() -> pa.Table:
            writer, reader = self.conn.do_exchange(descriptor)
            with writer:
                writer.begin(target.schema)
                writer.write_table(target)
                writer.done_writing()
                return reader.read_all()

        return self._retrying(attempt)

    @staticmethod
    def _encode_target(target: Any) -> pa.Table:
        """Single query → flat float column (the reference wire shape);
        query batch [Q, D] → FixedSizeList column."""
        if hasattr(target, "__array__") and not isinstance(target, (pa.Array, pa.ChunkedArray)):
            target = np.asarray(target)
        if isinstance(target, np.ndarray):
            if target.ndim == 2:
                target = ingest.numpy_to_fixed_size_list(
                    np.ascontiguousarray(target, dtype=np.float32), pa.float32()
                )
            else:
                target = pa.array(np.ascontiguousarray(target))
        return pa.table({"target": target})

    # -- admin ------------------------------------------------------------

    def remove(self) -> "Flight":
        self._action("remove", {})
        return self

    def list_tables(self) -> list[str]:
        return self._action_json("list-tables")

    def list_coders(self) -> list[str]:
        return self._action_json("list-coders")

    def list_indexes(self) -> list[str]:
        return self._action_json("list-indexes")

    def stats(self) -> dict[str, float]:
        return self._action_json("stats")

    def health(self) -> dict[str, str]:
        return self._action_json("health")

    def _action(self, verb: str, body: Any) -> list[fl.Result]:
        # drain the iterator: server-side errors surface on consumption
        return self._retrying(lambda: [*self.conn.do_action(fl.Action(verb, _dumps(body)))])

    def _action_json(self, verb: str) -> Any:
        return _loads(self._action(verb, {})[0].body.to_pybytes())
