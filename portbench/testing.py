"""Helpers of the benchmark's CPU tests: mini cells (small frames, mini
widths) run on the CPU through the whole harness."""

from __future__ import annotations

import json
import time
from pathlib import Path

from . import harness

ROOT = harness.PKG.parent
MINI_WIDTHS = {"rife-v4.6-arch": [16, 16, 16, 16],
               "rife-v2.3-arch": [8, 8, 8, 8, 4]}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def mini_cell(name: str, traced: bool = False,
              dtype: str = None) -> harness.Cell:
    """``name`` at 64x96, 5 frames, B=2, mini widths, a 0.5 s window, on
    the CPU."""
    wl = harness.workload(name)
    wl.update(height=64, width=96, frames=5, trace_steps=3, trace_calls=4,
              trace_frames=8, sample_tasks=3, sample_calls=4,
              warmup_steps=2, warmup_calls=1, warmup_batches=[1, 1, 2])
    if "batch" in wl:
        wl["batch"] = 2
    cfg = harness.config(wl["config"])
    cfg["widths"] = MINI_WIDTHS[cfg["name"]]
    if dtype:
        cfg["dtype"] = dtype
    return harness.Cell(name, 2 ** 40 + 5, 0.5, traced, "cpu",
                        time.perf_counter(), wl=wl, cfg=cfg)


def run(cell: harness.Cell, work: Path):
    """(the result line's object, the numbers compared with their
    limits)."""
    r = harness.run_cell(cell, bench(), Path(work))
    return r.result, r.checks
