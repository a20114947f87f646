"""Every cell runs end to end at a tiny size on the CPU (the kernels'
plain twins) and prints a last line the contract accepts."""

from __future__ import annotations

import io
import json

import pytest

from portbench import harness
from portbench import spec as spec_mod

CELLS = [w["name"] for w in spec_mod.Spec().bench["workloads"]]


def run_cell(root, workload: str, trace: bool, seed: int = 2**33 + 7) -> tuple[int, list[str], list[str]]:
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, seed, 1.0, trace, root=root, device="cpu", out=out, err=err)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


def check_line(spec: spec_mod.Spec, workload: str, trace: bool, text: str) -> dict:
    line = json.loads(text)
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line, key
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and 0 <= line["failed"] <= line["attempted"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(line)[-1] == "checks"
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    declared = {m["name"]: m for m in spec.metrics(workload, trace)}
    assert set(line["metrics"]) <= set(declared)
    for name, m in line["metrics"].items():
        assert m["unit"] == declared[name]["unit"]
        assert isinstance(m["value"], float | int)
    # a CPU run reads no device trace: every other metric of the cell is there
    host = {n for n, m in declared.items() if m["source"] != "device_trace"}
    assert set(line["metrics"]) == host
    return line


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_prints_the_contract_line(tiny, workload, trace):
    rc, out, err = run_cell(tiny, workload, trace)
    assert rc == 0, "\n".join(err)
    line = check_line(spec_mod.Spec(tiny), workload, trace, out[-1])
    assert line["correct"], line["checks"]
    assert "bytes_written" in json.loads(out[-2])
    # the numbers compared are the last lines of standard error
    assert err[-1] == "correct = True"
    assert [e.split()[1] for e in err[-1 - len(line["checks"]) : -1]] == list(line["checks"])


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert harness.run(CELLS[0], 1, 1.0, False) == 3
    assert capsys.readouterr().out == ""
