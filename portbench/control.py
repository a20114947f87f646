"""The control: the reference put in the program's place one precision
down, and the untrained coder, judged as a run judges the program.

The configurations state fp32 with TF32 off, so the control computes
every product in TF32 (``torch.backends.cuda.matmul.allow_tf32``) from
the cell's own corpus and queries at the cell's own size: the exact
top-k for an exact cell; for an IVF cell its own coder (``LLOYD_STEPS``
Lloyd steps from the rows the seed draws), assignment, probe ranking and
top-k. Then the same ``reference.judge`` and ``reference.ReferenceIVF``
read it. Its readings set the upper end of each limit (``PERF.md``), and
a run of it must come out not correct.

``untrained_*``: the fault of a training step that returns its state
unchanged. Its coder is the rows training starts from, each row indexed
to its nearest such row, and each query searched exactly within its
probes; its ``coder_gap`` and ``recall_gap`` are that fault's readings.

    python3 -m portbench.control --workload <name> --seeds 1,2,3

prints one JSON line of readings a seed. It needs a card (TF32 is a
card's precision); ``portbench/tests/test_portbench_control.py`` runs it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import data, reference
from portbench import spec as spec_mod

LLOYD_STEPS = 10  # the control coder's full-batch steps


def _tf32_distance(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    """``[A, B]`` float32 distances with TF32 products."""
    if metric == "cosine":
        a = a / a.norm(dim=1, keepdim=True).clamp_min(1e-12)
        b = b / b.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return 0.5 - 0.5 * (a @ b.T)
    if metric == "l2":
        return ((a * a).sum(1, keepdim=True) - 2.0 * a @ b.T + (b * b).sum(1)[None, :]).clamp_min(0).sqrt()
    return -(a @ b.T)


def readings(spec: spec_mod.Spec, workload: str, seed: int, device: str = "cuda") -> dict:
    """The control's numbers for one seed of ``workload``, and whether a
    run judged by them would come out correct."""
    cell = spec.workload(workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    metric, k, probes = traffic.get("metric") or cfg["metric"], traffic["k"], traffic.get("probes")
    n_check = traffic["check_queries"] // traffic["queries_per_request"] * traffic["queries_per_request"]
    queries = data.queries(cfg, traffic["pool_queries"], seed, device)[: max(n_check, traffic["queries_per_request"])]
    vectors, tags = data.corpus(cfg, seed, device)
    keep = reference.filter_mask(traffic.get("filter"), {"tag": tags})
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        q = torch.from_numpy(queries).to(device)
        cells = centroids = None
        if probes:
            index = cfg["index"]
            centroids = reference.train_coder(vectors, index["codebook_size"], index["metric"], seed, LLOYD_STEPS,
                                              dist=_tf32_distance)
            cells, _ = reference.nearest(vectors, centroids, index["metric"], dist=_tf32_distance)
            probe = _tf32_distance(q, centroids, metric).topk(probes, dim=1, largest=False).indices
        ids, dists = [], []
        for s in range(0, q.shape[0], 64):
            d = _tf32_distance(q[s : s + 64], vectors, metric)
            if keep is not None:
                d = d.masked_fill(~keep[None, :], torch.inf)
            if probes:
                allowed = torch.zeros((d.shape[0], centroids.shape[0]), dtype=torch.bool, device=device)
                allowed.scatter_(1, probe[s : s + 64], True)
                d = d.masked_fill(~allowed[:, cells], torch.inf)
            top = d.topk(k, dim=1, largest=False)
            ids.append(top.indices.cpu().numpy())
            dists.append(top.values.cpu().numpy().astype(np.float64))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    oracle = reference.Oracle(vectors, device)
    del vectors
    ids = np.concatenate(ids)
    numbers = {"failed": 0}
    strict = loose = keep
    if probes:
        index = cfg["index"]
        ivf = reference.ReferenceIVF(oracle, index["codebook_size"], index["metric"], seed, queries, metric, k,
                                     probes, keep)
        numbers.update(ivf.judge(centroids, cells, ids))
        sure, maybe = reference.probe_sets(queries, centroids, metric, probes)
        strict, loose = reference.probed_rows(sure, cells, keep), reference.probed_rows(maybe, cells, keep)
        # the untrained coder: the rows training starts from, rows indexed and
        # searched exactly within its probes, in float64
        start = reference.train_coder(oracle.v, index["codebook_size"], index["metric"], seed, 0)
        own, _ = reference.nearest(oracle.v, start, index["metric"])
        near_sure, _ = reference.probe_sets(queries, start, metric, probes)
        untrained, _ = oracle.topk(queries, metric, k, mask=reference.probed_rows(near_sure, own, keep))
        numbers.update({f"untrained_{n}": v for n, v in ivf.judge(start, own, untrained).items()})
    numbers.update(reference.judge(oracle, queries, ids, np.concatenate(dists), metric, strict, loose))
    limits = cfg["limits"]
    return {"workload": workload, "seed": seed, "numbers": numbers, "limits": limits,
            "correct": reference.verdict(numbers, limits)}


def main() -> int:
    parser = argparse.ArgumentParser(description="the control's readings on a card")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    args = parser.parse_args()
    spec = spec_mod.Spec()
    for seed in args.seeds.split(","):
        print(json.dumps(readings(spec, args.workload, int(seed))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
