"""What the benchmark imports: no JAX and no JAX package in the process
that measures (top-level names compared whole: the port's name begins
with the JAX package's), and nothing of the port in the reference, the
control and the client processes."""

from __future__ import annotations

import subprocess
import sys
import types

from portbench import harness
from portbench import spec as spec_mod


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("fenix_tpu_torch", "fenix_tpu_torch.flight", "fenix_tpux", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    for name in ("fenix_tpu.ops", "jaxlib", "flax.linen", "jax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == ["fenix_tpu", "flax", "jax", "jaxlib"]


def _top_level_after(module: str) -> set[str]:
    code = (f"import sys; sys.path.insert(0, {str(spec_mod.ROOT)!r}); import {module}; "
            "print(' '.join(sorted({m.partition('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=120)
    return set(out.stdout.split())


def test_reference_control_and_clients_import_nothing_of_the_port():
    for module in ("portbench.reference", "portbench.control", "portbench.roofline", "portbench.devtrace"):
        assert not _top_level_after(module) & {"fenix_tpu_torch", "fenix_tpu", "jax", "jaxlib", "flax"}, module
    client = _top_level_after("portbench.client, portbench.wire")
    assert not client & {"fenix_tpu_torch", "fenix_tpu", "jax", "torch"}


def test_a_lone_benchmark_folder_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder (no port beside it), a run fails and prints no result."""
    import shutil

    shutil.copy(spec_mod.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec_mod.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload", "glove100-ivf4096.serve-c32", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0
    assert not any(line.startswith('{"correct"') for line in run.stdout.splitlines())
