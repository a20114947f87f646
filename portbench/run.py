"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the checkout root (see ``portbench/README.md``).
The last line of standard output is the result; the last lines of
standard error are the numbers compared, each beside its limit. Exits
with 3 and prints no result without the CUDA cards the cell asks for.
"""

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the checkout


def _environment() -> None:
    """Caches at fixed paths inside the checkout, and none of the port's
    per-request trace files or query log."""
    build = ROOT / "build"
    os.environ.setdefault("FENIX_TORCH_BUILD_DIR", str(build / "fenix_tpu_torch"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "portbench" / "cuda"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "portbench" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "portbench" / "torch_extensions"))
    os.environ.pop("FENIX_TRACE_DIR", None)
    os.environ.pop("FENIX_QUERY_LOG", None)


def _place(workload: str) -> "list[int] | None":
    """Split this machine's CPUs between the server and its clients, as
    the mix's ``client_cpus`` asks: the last that many for the client
    processes, the rest for this process, which runs the server. Made
    before numpy and torch size their thread pools. Returns the clients'
    CPUs, or None where the mix asks for no split or the machine has too
    few."""
    from portbench.spec import Spec

    spec = Spec(ROOT)
    want = int(spec.traffic(spec.workload(workload)["traffic"]).get("client_cpus", 0))
    cpus = sorted(os.sched_getaffinity(0))
    if want <= 0 or len(cpus) <= want:
        return None
    os.sched_setaffinity(0, cpus[:-want])
    return cpus[-want:]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()
    _environment()
    sys.path.insert(0, str(ROOT))
    client_cpus = _place(args.workload)
    from portbench import harness

    return harness.run(args.workload, args.seed, args.seconds, bool(args.trace), root=ROOT, client_cpus=client_cpus)


if __name__ == "__main__":
    sys.exit(main())
