"""The streamed cell comes out not correct when the stream leaves the last
block of each chunk unscanned: the rows of that block get −inf on the
card, as padding does, so a query whose nearest rows lie there is served
the next ones. The run is the harness's own, at a tiny size on the CPU,
with the cache's row block cut to ``BLOCK`` and the budget to chunks of
two blocks, so the table streams in three chunks; the fault is planted
in the port in this process, where the server runs. Its ``dist_gap``
and ``rank_gap`` readings are the fault's end of the cell's limits
(``PERF.md`` §2). And the cell's metric readers, by hand."""

from __future__ import annotations

import functools
import json

import pytest

from portbench.tests.test_portbench_cells import run_cell

CELL = "laion768-l2-stream.batch-q2048"
BLOCK = 1024  # rows of the cache's row block in this test (6,000 rows: 6 blocks)
BUDGET = 30_000_000  # bytes: chunks of 2,048 rows of 768 fp32 (``residency._stream_chunk_rows``)


@pytest.mark.parametrize("seed", [977, 2**33 + 11])
def test_last_block_of_each_chunk_unscanned(tiny, monkeypatch, seed):
    from fenix_tpu_torch.engine import executor, session
    from fenix_tpu_torch.ops import distance, topk2

    monkeypatch.setattr(executor, "DeviceCache", functools.partial(session.DeviceCache, block=BLOCK))
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(BUDGET))
    search = topk2.topk_two_phase
    scanned = []

    def unscanned_tail(corpus, queries, aux_mul, aux_add, *args, **kwargs):
        aux_add = aux_add.clone()
        aux_add[-BLOCK:] = distance.NEG_INF
        scanned.append(corpus.shape[0])
        return search(corpus, queries, aux_mul, aux_add, *args, **kwargs)

    monkeypatch.setattr(topk2, "topk_two_phase", unscanned_tail)
    rc, out, err = run_cell(tiny, CELL, False, seed=seed)
    assert rc == 0, "\n".join(err)
    line = json.loads(out[-1])
    print(json.dumps(line["checks"]))
    counters = line["run"]["counters"]
    assert counters["search.stream_chunks"] == 3 * counters["batch.dispatches"]
    assert set(scanned) == {2 * BLOCK}
    assert not line["correct"], line["checks"]
    assert line["checks"]["rank_gap"]["value"] > line["checks"]["rank_gap"]["limit"], line["checks"]


def test_stream_readers_by_hand():
    """The cell's readers against hand-worked numbers, and nothing read
    (no error) from a program that counts none of their counters."""
    from portbench import roofline
    from portbench import spec as spec_mod
    from portbench.tests.test_portbench_arith import run_view

    spec = spec_mod.Spec()
    c = {"batch.dispatches": 4.0, "batch.queries": 8192.0, "transfer.stage_seconds": 1.6,
         "transfer.h2d_bytes": 4 * 3.2e9, "transfer.h2d_seconds": 0.25, "residency.stream_scan_seconds": 0.8,
         "residency.stream_merge_seconds": 0.4}
    v = run_view(counters=c)
    assert spec.reader("stream.stage_ms_per_dispatch").read(v) == pytest.approx(400.0)
    assert spec.reader("stream.h2d_link_share").read(v) == pytest.approx(100 * 51.2e9 / 64e9)
    assert spec.reader("residency.stream_scan_ms_per_dispatch").read(v) == pytest.approx(200.0)
    assert spec.reader("residency.stream_merge_ms_per_dispatch").read(v) == pytest.approx(100.0)
    tiled = "void fenix::(anonymous namespace)::tiled_kernel<float, 8, true>(float const*, float const*)"
    ev = [(tiled, "kernel", 0.0, 80_000.0), ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 80_000.0, 60_000.0),
          ("void fenix::(anonymous namespace)::tensor_kernel<signed char, 128, false>(CUtensorMap)", "kernel",
           140_000.0, 1_000.0)] * 4
    least = roofline.bound("f32", 2048, 1_000_000, 768, 100)["bound_s"]
    got = spec.reader("stream.phase1_roofline").read(run_view(counters=c, device_events=ev))
    assert got == pytest.approx(100 * 4 * least / 0.32)  # tiled alone: 4 × 80 ms
    bare = run_view(counters={"batch.dispatches": 4.0, "batch.queries": 8192.0})
    for name in ("stream.stage_ms_per_dispatch", "stream.h2d_link_share", "residency.stream_scan_ms_per_dispatch",
                 "residency.stream_merge_ms_per_dispatch", "stream.phase1_roofline"):
        assert spec.reader(name).read(bare) is None
