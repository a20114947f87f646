"""fenix_tpu_torch's probe-cell ranking on the card, at glove-100's IVF
shape (a 4,096-cell cosine coder over 100-d rows, 1,024 queries, 50
probes): the card's cells, rank by rank, against a float64 ranking
written here, up to near ties; ``ivf.rank_device`` once per probed
search; and one upload of the codebooks for two searches. Runs where a
CUDA card is present (``-m cuda``); it imports no JAX."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from fenix_tpu_torch import coder, index
from fenix_tpu_torch.engine import executor
from fenix_tpu_torch.engine.session import DeviceCache
from fenix_tpu_torch.io import ingest, table
from fenix_tpu_torch.utils.metrics import GLOBAL as METRICS

ROWS, DIM, CELLS, Q, PROBES = 65536, 100, 4096, 1024, 50
NEAR = 1e-5  # cells whose float64 distances lie this close may rank either way in fp32


@pytest.mark.cuda
def test_card_ranks_the_cells_of_glove_shape(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device ranking of a CUDA cache")
    rng = np.random.default_rng(19)
    root = str(tmp_path)
    rows = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    table.make(root, "items", pa.table({
        "id": pa.array(np.arange(ROWS, dtype=np.int64)),
        "vector": ingest.numpy_to_fixed_size_list(rows, pa.float32()),
    }).to_reader())
    books = rng.standard_normal((1, CELLS, DIM)).astype(np.float32)
    config = {"metric": "cosine", "codebook_size": CELLS, "num_codebooks": 1, "batch_size": 4096, "num_epochs": 1}
    coder._persist(root, "ivf", config, pa.list_(pa.float32(), DIM), books)
    index.make(root, "ivf", "items", "vector", device="cuda")
    cache = DeviceCache(root, device="cuda", mesh=None)
    queries = rng.standard_normal((Q, DIM)).astype(np.float32)

    host, dev = executor._rank_cells(cache, "ivf", queries, "cosine", PROBES)
    assert dev.device.type == "cuda" and dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.cpu().numpy(), host)
    q64 = queries.astype(np.float64) / np.linalg.norm(queries.astype(np.float64), axis=1, keepdims=True)
    b64 = books[0].astype(np.float64) / np.linalg.norm(books[0].astype(np.float64), axis=1, keepdims=True)
    d64 = 0.5 - 0.5 * q64 @ b64.T
    want = np.argsort(d64, axis=1, kind="stable")[:, :PROBES]
    rows_q = np.arange(Q)[:, None]
    gap = np.abs(d64[rows_q, host] - d64[rows_q, want])  # rank by rank
    assert gap.max() <= NEAR, gap.max()
    differ = int((host != want).any(axis=1).sum())
    print(f"card ranking: {differ} of {Q} queries differ from float64's, all within {NEAR} (max {gap.max():.3g})")

    req = executor.SearchRequest(source="items", column="vector", target=queries, maxval=10, coding="ivf",
                                 probes=PROBES)
    for search in range(2):
        before = METRICS.snapshot()
        out = executor.execute_search(cache, req)
        after = METRICS.snapshot()
        assert out.num_rows == Q * 10
        assert after.get("ivf.rank_device", 0) - before.get("ivf.rank_device", 0) == 1
        routes = sum(after.get(r, 0) - before.get(r, 0) for r in ("search.ivf_scan", "search.ivf_clustered"))
        assert routes == 1
        if search == 0:
            uploaded = cache.codebooks("ivf")
    assert cache.codebooks("ivf") is uploaded  # not uploaded again for the second search
