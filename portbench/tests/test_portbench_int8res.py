"""The int8-resident cell comes out not correct when its exact rescore is
skipped: the host returns the card's window as it came, each query's
first k rows in the int8-narrowed order with their int8-narrowed
distances (``(q̂ · dequantized row) / ‖row‖`` as cosine distances), the
fp32 rows never read. The run is the harness's own, at a tiny size on
the CPU; the fault is planted in the port in this process, where the
server runs. Its ``dist_gap`` reading is the fault's end of the cell's
limits (``PERF.md`` §2)."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.tests.test_portbench_cells import run_cell

CELL = "openai1536-500k-int8res.batch-q64"


@pytest.mark.parametrize("seed", [977, 2**33 + 11])
def test_rescore_skipped(tiny, monkeypatch, seed):
    from fenix_tpu_torch.engine import residency
    from fenix_tpu_torch.ops import topk2

    narrowed = []
    window = topk2.topk_window_int8

    def window_and_scores(v8, sv, queries, aux_mul, aux_add, k, w, metric):
        win = window(v8, sv, queries, aux_mul, aux_add, k=k, w=w, metric=metric)
        qp = topk2.prepare_queries(queries, metric)
        scores = (v8[win].float() * qp[:, None, :]).sum(-1) * (aux_mul * sv)[win] + aux_add[win]
        narrowed.append(scores.cpu().numpy())
        return win

    def skipped(host, aux_mul, aux_add, mask, queries, win, rows, k, metric, spent=None, **kwargs):
        scores = narrowed.pop()[:, :k]
        return (0.5 - 0.5 * scores).astype(np.float32), win[:, :k].astype(np.int32)

    monkeypatch.setattr(topk2, "topk_window_int8", window_and_scores)
    monkeypatch.setattr(residency, "_host_rescore_topk", skipped)
    rc, out, err = run_cell(tiny, CELL, False, seed=seed)
    assert rc == 0, "\n".join(err)
    line = json.loads(out[-1])
    print(json.dumps(line["checks"]))
    assert line["run"]["counters"]["search.residency_int8"] == line["run"]["counters"]["batch.dispatches"]
    assert not line["correct"], line["checks"]
    assert line["checks"]["dist_gap"]["value"] > line["checks"]["dist_gap"]["limit"], line["checks"]
