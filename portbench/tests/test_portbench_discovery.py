"""A configuration, a traffic mix and a metric added as files are found
by name: no file of the harness is edited."""

from __future__ import annotations

import json

from portbench import spec as spec_mod
from portbench.tests.test_portbench_cells import check_line, run_cell


def test_new_config_mix_and_metric_are_found_by_name(tiny):
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny / "portbench" / "configs" / "cohere768-1m.json").read_text())
    cfg.update(name="narrow64", dim=64, rows=3000)
    (tiny / "portbench" / "configs" / "narrow64.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny / "portbench" / "traffic" / "cohere768-1m.serve-c32.json").read_text())
    mix.update(loop="open", rate=40.0, burst={"period_s": 0.5, "on_s": 0.1, "factor": 3.0}, k=5, threads=3)
    (tiny / "portbench" / "traffic" / "narrow64.open-r40.json").write_text(json.dumps(mix))
    (tiny / "portbench" / "metrics" / "clients.median_ms.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n    return float(np.median(run.latencies_s)) * 1e3\n"
    )
    bench["configs"].append({"name": "narrow64", "source": "https://example.org/narrow64",
                             "file": "portbench/configs/narrow64.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "narrow64.open-r40", "config": "narrow64", "traffic": "narrow64.open-r40",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "clients.median_ms", "unit": "ms", "better": "lower", "source": "host_clock",
                               "layer": "clients", "moves": "qps", "workloads": ["narrow64.open-r40"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))

    for trace in (False, True):
        rc, out, err = run_cell(tiny, "narrow64.open-r40", trace)
        assert rc == 0, "\n".join(err)
        line = check_line(spec_mod.Spec(tiny), "narrow64.open-r40", trace, out[-1])
        assert line["correct"], line["checks"]
        assert ("clients.median_ms" in line["metrics"]) == trace
        assert ("qps" in line["metrics"]) != trace


def test_client_cpus_split_the_machine():
    """A mix's ``client_cpus`` keeps the server's process off the last
    that many CPUs and gives them to the clients; a mix without it, or a
    machine with too few CPUs, splits nothing."""
    import subprocess
    import sys

    code = ("import json, os, runpy, sys; sys.argv = ['run.py']; "
            f"place = runpy.run_path({str(spec_mod.ROOT / 'portbench' / 'run.py')!r})['_place']; "
            "before = sorted(os.sched_getaffinity(0)); got = place(sys.argv_cell); "
            "print(json.dumps([before, got, sorted(os.sched_getaffinity(0))]))")
    for cell, want in (("glove100-ivf4096.serve-c32", 2), ("glove100-ivf4096.batch-q1024-p50", 0)):
        run = subprocess.run([sys.executable, "-c", code.replace("sys.argv_cell", repr(cell))], capture_output=True,
                             text=True, check=True, timeout=120)
        before, got, after = json.loads(run.stdout)
        if want and len(before) > want:
            assert got == before[-want:] and after == before[:-want]
        else:
            assert got is None and after == before
