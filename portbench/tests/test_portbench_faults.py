"""A run with the timed path broken underneath comes out not correct:
once for each fault these cells can have. The run is the harness's own,
at a tiny size on the CPU (the card check is skipped by passing the
device); the fault is planted in the port in this process, where the
server runs.

- an answer altered where it is produced (the result rows);
- half of a batch left out: the second half's queries get the first
  half's answers;
- a training step that returns its state unchanged (the IVF coder).

The exchange between chips is no fault of these one-chip cells.
"""

from __future__ import annotations

import json

import pyarrow as pa
import pytest
import torch

from portbench.tests.test_portbench_cells import run_cell


def verdict(root, workload: str) -> dict:
    rc, out, err = run_cell(root, workload, False, seed=977)
    assert rc == 0, "\n".join(err)
    return json.loads(out[-1])


@pytest.mark.parametrize("workload", ["cohere768-1m.batch-q1024-f99", "glove100-ivf4096.serve-c32"])
def test_altered_answer(tiny, monkeypatch, workload):
    from fenix_tpu_torch.engine import executor

    gather = executor.gather_results

    def altered(*args, **kwargs):
        table = gather(*args, **kwargs)
        ids = table.column("id").to_numpy().copy()
        ids[0] = (ids[0] + 1) % 6000
        return table.set_column(table.schema.get_field_index("id"), "id", pa.array(ids))

    monkeypatch.setattr(executor, "gather_results", altered)
    line = verdict(tiny, workload)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["cohere768-1m.batch-q1024-f99", "glove100-ivf4096.batch-q1024-p50"])
def test_half_the_batch_left_out(tiny, monkeypatch, workload):
    from fenix_tpu_torch.ops import topk2

    for name in ("topk_two_phase", "topk_two_phase_probed", "topk_ivf_clustered"):
        search = getattr(topk2, name)

        def half(corpus, queries, *args, _search=search, **kwargs):
            q = queries.shape[0]
            h = (q + 1) // 2
            # the per-query inputs (probe cells, bucket lists) are cut with the queries
            args = [a[:h] if torch.is_tensor(a) and a.dim() and a.shape[0] == q else a for a in args]
            dists, ids = _search(corpus, queries[:h], *args, **kwargs)
            return torch.cat([dists, dists])[:q], torch.cat([ids, ids])[:q]

        monkeypatch.setattr(topk2, name, half)
    line = verdict(tiny, workload)
    assert not line["correct"], line["checks"]


def test_training_step_returns_its_state(tiny, monkeypatch):
    from fenix_tpu_torch.ops import kmeans

    monkeypatch.setattr(kmeans, "lloyd_step", lambda codebooks, *args, **kwargs: codebooks)
    line = verdict(tiny, "glove100-ivf4096.serve-c32")
    assert not line["correct"], line["checks"]
    # the coder is judged against the reference's own
    assert line["checks"]["coder_gap"]["value"] > line["checks"]["coder_gap"]["limit"], line["checks"]
