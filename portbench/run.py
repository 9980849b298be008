"""The benchmark's command: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for.  It writes the cell's model and seeded weights under
``portbench/_work/``, builds the session (the program's kernel library
comes from, or is built into, its cache inside the checkout), warms the
cell's shapes, measures for ``--seconds`` (``--trace 1``: a stated number
of steps under ``torch.profiler`` with CUDA activity alone, then a short
span with CPU activity for the idle gaps), then checks the sampled answers
against the plain reference.  The last line of standard output is the
result's JSON object; the numbers compared, each beside its limit, are the
last lines of standard error.  Without a card (or with fewer than the cell asks for) it
prints no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

WORK = Path(__file__).resolve().parent / "_work"
# every compiler cache of the process at a fixed place inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(WORK / "cache" / sub)


def pin(name: str) -> int:
    """Where the cell's workload file sets ``cpus``: keep the process, and
    every thread it starts from here on (the card's and the thread pool's),
    on the last ``cpus`` CPUs it may use, so that a host-bound cell's
    latency does not move with the threads' placement; returns that count,
    or 0."""
    path = Path(__file__).resolve().parent / "workloads" / f"{name}.json"
    n = int(json.loads(path.read_text()).get("cpus", 0))
    if n > 0 and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-n:])
        return n
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads(Path("BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    allowed = os.sched_getaffinity(0)
    cpus = pin(args.workload)

    import torch

    from . import harness

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        os.sched_setaffinity(0, allowed)
        return 2
    if cpus:
        torch.set_num_threads(cpus)
    cell = harness.Cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda:0", T_START)
    run = harness.run_cell(cell, bench, WORK)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, (value, limit) in run.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(run.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
