"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout root names the cells, their
configurations and traffic mixes, and the metrics. Everything that
belongs to one of them lives in a file of its own, found by its name:

- a configuration: the ``file`` its entry names (``portbench/configs/``);
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a metric: ``portbench/metrics/<metric>.py``, a reader with one function
  ``read(run) -> float | None`` (``None``: nothing to read, the metric is
  left out of the line).

So a later change adds a cell, a mix or a metric by adding files and
entries alone. Standard library only: the client processes import it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any

# the checkout root: portbench/ lies directly under it
ROOT = Path(__file__).resolve().parent.parent


class Spec:
    """``BENCHMARK.json`` of ``root`` and the files it names."""

    def __init__(self, root: "str | Path" = ROOT) -> None:
        self.root = Path(root)
        self.bench: dict[str, Any] = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers: dict[str, ModuleType] = {}

    def workload(self, name: str) -> dict[str, Any]:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict[str, Any]:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict[str, Any]:
        return json.loads((self.root / "portbench" / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list[dict[str, Any]]:
        """The metrics a run of ``cell`` reports: the end-to-end ones with
        ``trace`` off, the per-layer ones with it on; a metric with a
        ``workloads`` list only in those cells."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> ModuleType:
        if metric not in self._readers:
            path = self.root / "portbench" / "metrics" / f"{metric}.py"
            spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(self._readers)}", path)
            if spec is None or spec.loader is None:
                raise FileNotFoundError(path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._readers[metric] = module
        return self._readers[metric]
