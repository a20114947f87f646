"""Wire config → engine dispatch — port of ``fenix_tpu/engine/service.py``.

``run_search_config`` resolves a repartitioned name to its shard tables
(``parallel/distributed.resolve_source``) and hands the request straight
to ``executor.execute_search``. A config with an ``aggregate`` and no
``join`` is the plain search, as in the JAX package, which reads the
aggregate only inside a join. Fused joins (ROADMAP queue 1 item 9) and
micro-batching of concurrent requests (``engine/batching.py``, item 6)
are not ported yet.
"""

from __future__ import annotations

from typing import Any

import pyarrow as pa

from fenix_tpu_torch import expr as expr_mod
from fenix_tpu_torch.engine import executor
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


def run_search_config(cache: DeviceCache, config: dict[str, Any], target: Any) -> pa.Table:
    if config.get("join") is not None:
        raise NotImplementedError("search joins and aggregates (ROADMAP queue 1 item 9: analytics)")
    config = {**config, "source": distributed.resolve_source(cache.root, config["source"])}
    return executor.execute_search(cache, request_from_config(config, target))
