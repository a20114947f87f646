"""End-to-end quickstart: server + client in one process — the port's
twin of ``examples/quickstart.py``.

Run:  python -m fenix_tpu_torch.examples.quickstart               (on the card)
      python -m fenix_tpu_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import threading

import numpy as np
import pyarrow as pa

import fenix_tpu_torch
from fenix_tpu_torch import expr
from fenix_tpu_torch.io import ingest


def main(device: str = "cuda") -> None:
    rng = np.random.default_rng(0)
    n, d = 50_000, 128
    vectors = rng.standard_normal((n, d)).astype(np.float32)

    # ---- server --------------------------------------------------------
    root = tempfile.mkdtemp(prefix="fenix_quickstart_")
    server = fenix_tpu_torch.Server(root, host="127.0.0.1", port=0, device=device)
    threading.Thread(target=server.serve, daemon=True).start()
    client = fenix_tpu_torch.Flight(host="127.0.0.1", port=server.port)

    # ---- ingest --------------------------------------------------------
    client.make_table(
        "demo/items",
        pa.table(
            {
                "id": pa.array(np.arange(n)),
                "category": pa.array(rng.integers(0, 10, n)),
                "vector": ingest.numpy_to_fixed_size_list(vectors, pa.float32()),
            }
        ).to_reader(),
    )
    print("tables:", client.list_tables())

    # ---- exact filtered kNN -------------------------------------------
    query = rng.standard_normal(d).astype(np.float32)
    hits = client.search(
        query,
        source="demo/items",
        column="vector",
        metric="cosine",
        filter=expr.field("category").isin([2, 3]),
        maxval=5,
    )
    print("exact filtered top-5 ids:", hits.column("id").to_pylist())
    print("distances:", [round(x, 4) for x in hits.column("__DISTANCE__").to_pylist()])

    # ---- train an IVF coder + probe it --------------------------------
    client.make_index(
        "demo/ivf",
        "demo/items",
        "vector",
        {
            "metric": "cosine",
            "codebook_size": 8,
            "num_codebooks": 2,
            "batch_size": 1024,
            "num_epochs": 3,
        },
    )
    approx = client.search(
        query,
        source="demo/items",
        column="vector",
        metric="cosine",
        coding="demo/ivf",
        maxval=5,
        probes=16,
    )
    print("IVF top-5 ids:", approx.column("id").to_pylist())

    # ---- mutate the catalog (indexes stay consistent) -------------------
    fresh = rng.standard_normal((100, d)).astype(np.float32) + 8.0
    client.append_table(
        "demo/items",
        pa.table(
            {
                "id": pa.array(np.arange(n, n + 100)),
                "category": pa.array(np.full(100, 99)),
                "vector": ingest.numpy_to_fixed_size_list(fresh, pa.float32()),
            }
        ).to_reader(),
    )
    counts = client.upsert_rows(
        "demo/items",
        pa.table(
            {
                "id": pa.array([0, n + 100]),
                "category": pa.array([99, 99]),
                "vector": ingest.numpy_to_fixed_size_list(fresh[:2] * 0.5, pa.float32()),
            }
        ).to_reader(),
    )
    print("upsert:", counts)
    deleted = client.delete_rows("demo/items", expr.field("category") == 99)
    print("deleted:", deleted, "rows (category 99)")

    # ---- fused search -> join -> aggregate ------------------------------
    client.make_table(
        "demo/attrs",
        pa.table(
            {
                "key": pa.array(np.arange(n)),
                "grp": pa.array(rng.integers(0, 4, n)),
            }
        ).to_reader(),
    )
    groups = client.search(
        query,
        source="demo/items",
        column="vector",
        metric="cosine",
        maxval=32,
        join={"source": "demo/attrs", "right_on": "key"},
        aggregate={"group_by": "grp", "agg": "count", "max_groups": 8},
    )
    print("matches per group:", dict(zip(
        groups.column("__GROUP__").to_pylist(),
        groups.column("__AGG__").to_pylist(),
    )))

    print("server stats:", {k: v for k, v in client.stats().items() if k.endswith("count")})
    client.close()
    server.shutdown()
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="torch device the server searches on, e.g. cuda or cpu")
    main(parser.parse_args().device)
