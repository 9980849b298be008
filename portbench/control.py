"""The readings the check's limits are set from, for one cell on the card.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 ... --seconds 2

For each seed, in one process: a run of the cell as the benchmark makes it
(a short window of the cell's own load, ``--trace 0``), its sampled
answers judged against the float32 reference, and the control judged on the
same pairs: the reference itself with every convolution's and
InnerProduct's operands rounded to float8 e4m3 (per-tensor scale), the
precision below the configuration's bfloat16.  One JSON line a seed:
``program`` (the sound run's numbers) and ``control``, each number of
``check.NUMBERS``.  The lower reading of a
number is the largest ``program`` over the seeds, the upper the smallest
``control``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from . import check
from .reference.rife import Reference, fp8_e4m3


def control_numbers(pairs: Iterable[int], model_dir, cfg: dict, clip,
                    t: float, want: Tuple[str, ...] = check.NUMBERS,
                    device=None) -> Dict[str, float]:
    """The control's answers to ``pairs`` (pair p = clip[p], clip[p + 1])
    judged against the float32 reference, number by number."""
    device = clip.device if device is None else device
    ctl = Reference(model_dir, cfg["family"], cfg["nets"], device,
                    quant=fp8_e4m3)
    sample = [(p, ctl.pair(clip[p:p + 1], clip[p + 1:p + 2], t)[0][0])
              for p in sorted(set(pairs))]
    return program_numbers(sample, model_dir, cfg, clip, t, want, device)


def program_numbers(sample: List[Tuple[int, object]], model_dir, cfg: dict,
                    clip, t: float, want: Tuple[str, ...] = check.NUMBERS,
                    device=None) -> Dict[str, float]:
    """``sample``'s answers judged against the float32 reference."""
    device = clip.device if device is None else device
    ref = Reference(model_dir, cfg["family"], cfg["nets"], device)
    return check.compare(sample, ref, clip, t, want)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    from . import harness
    from .run import WORK

    bench = json.loads(Path("BENCHMARK.json").read_text())
    for seed in args.seeds:
        cell = harness.Cell(args.workload, seed, args.seconds, False,
                            "cuda:0", time.perf_counter())
        with contextlib.redirect_stdout(io.StringIO()):
            run = harness.run_cell(cell, bench, WORK)
        t = cell.wl.get("timestep", 0.5)
        prog = program_numbers(run.sample, run.model_dir, cell.cfg,
                               run.clip, t)
        ctl = control_numbers([p for p, _ in run.sample], run.model_dir,
                              cell.cfg, run.clip, t)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": prog, "control": ctl,
                          "checks": {k: v for k, (v, _) in
                                     run.checks.items()},
                          "flow_std_px": run.flow_std_px,
                          "weights": run.weights,
                          "metrics": run.result["metrics"],
                          "correct": run.result["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
