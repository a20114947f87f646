"""Wire config → engine dispatch — port of ``fenix_tpu/engine/service.py``.

``run_search_config`` resolves a repartitioned name to its shard tables
(``parallel/distributed.resolve_source``), for the search table and for a
join's attribute table. A request with a ``join`` goes to
``analytics.execute_search_join`` (with its ``aggregate``, if any); every
other request goes to the cache's micro-batcher
(``batching.get_batcher(cache).submit``), which coalesces concurrent
compatible searches into one device search and runs the rest solo; a
traced request too, since the spans of every thread are recorded while
a capture is active (``utils/profiling``). ``request`` is the search's
request id, which its spans carry. A config with an ``aggregate`` and no
``join`` is the plain search, as in the JAX package, which reads the
aggregate only inside a join.
"""

from __future__ import annotations

from typing import Any

import pyarrow as pa

from fenix_tpu_torch import expr as expr_mod
from fenix_tpu_torch.engine import analytics, batching, executor
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.parallel import distributed


def request_from_config(config: dict[str, Any], target: Any) -> executor.SearchRequest:
    return executor.SearchRequest(
        source=config["source"],
        column=config["column"],
        target=target,
        metric=config.get("metric"),
        coding=config.get("coding"),
        select=config.get("select"),
        filter=(
            expr_mod.Expr.from_dict(config["filter"])
            if config.get("filter") is not None
            else None
        ),
        maxval=config.get("maxval"),
        probes=config.get("probes"),
        precision=config.get("precision") or "fp32",
        residency=config.get("residency") or "auto",
        extra=config.get("extra") or {},
    )


def run_search_config(
    cache: DeviceCache, config: dict[str, Any], target: Any, request: "int | None" = None
) -> pa.Table:
    config = {**config, "source": distributed.resolve_source(cache.root, config["source"])}
    req = request_from_config(config, target)
    join = config.get("join")
    if join is None:
        return batching.get_batcher(cache).submit(req, request)
    join = {**join, "source": distributed.resolve_source(cache.root, join["source"])}
    aggregate = config.get("aggregate")
    return analytics.execute_search_join(
        cache,
        req,
        analytics.JoinSpec.from_dict(join),
        analytics.AggregateSpec.from_dict(aggregate) if aggregate is not None else None,
    )
