"""Fixtures of the benchmark's tests: a checkout-like root at a tiny size,
and the card check (made in a fixture, never at import)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from portbench import spec as spec_mod

REPO = spec_mod.ROOT


def tiny_root(dest: Path) -> Path:
    """``BENCHMARK.json`` and the benchmark's data files, cut to a size the
    CPU runs in seconds: the same keys, fewer rows, cells, clients and
    queries."""
    (dest / "portbench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "portbench" / sub, dest / "portbench" / sub)
    for path in (dest / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(rows=6000)
        cfg["mixture"]["centers"] = 64
        if cfg["index"]:
            cfg["index"].update(codebook_size=32, batch_size=2048, num_epochs=2)
        path.write_text(json.dumps(cfg))
    for path in (dest / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(processes=min(mix["processes"], 2), threads=min(mix["threads"], 2), pool_queries=512,
                   warmup_seconds=0.3, check_queries=64, queries_per_request=min(mix["queries_per_request"], 32))
        if mix.get("probes"):
            mix["probes"] = 4
        path.write_text(json.dumps(mix))
    return dest


@pytest.fixture
def tiny(tmp_path: Path) -> Path:
    return tiny_root(tmp_path / "root")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return "cuda"
