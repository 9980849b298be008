"""Helpers of the benchmark's CPU tests: mini cells (small frames, mini
widths) run on the CPU through the whole harness."""

from __future__ import annotations

import json
import time
from pathlib import Path

from . import harness

ROOT = harness.PKG.parent
MINI_WIDTHS = {"rife-v4.6-arch": [16, 16, 16, 16],
               "rife-v2.3-arch": [8, 8, 8, 8, 4],
               "v1_arch": [8, 8, 8, 4]}
# A throwaway v1 configuration (the benchmark has no v1 cell yet): the
# frozen v1 writer at its published widths, the program's baked scales of
# ``rife``; the tests cut it to mini widths.
V1_ARCH = {
    "name": "v1_arch",
    "source": "RIFE v1: github.com/hzwer/arXiv2020-RIFE model/IFNet.py + "
              "RIFE.py (arXiv 2011.06294 v1), ncnn graphs as in "
              "nihui/rife-ncnn-vulkan models/rife",
    "writer": "portbench.models.v1_arch", "write": "write_v1_params",
    "widths": [240, 150, 90, 16], "family": "v1",
    "nets": ["flownet", "contextnet", "fusionnet"],
    "frame_inputs": {"flownet": ["input0", "input1"],
                     "fusionnet": ["img0", "img1"]},
    "dtype": "bfloat16",
    "weight_scale": {"flownet": 0.9512, "contextnet": 1.0,
                     "fusionnet": 1.6218},
    "assumed": [], "reduced": [],
    "calibrate": {"net": "flownet", "target_std_px": 6.0},
}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


# The pair cell (``pair`` traffic, ``workloads/v46-1080p-b1-pair.json``) is
# out of BENCHMARK.json: its latencies follow the host machine's speed from
# run to run by more than the largest bound allows (PERF.md §2).  These are
# its entries as BENCHMARK.json listed them; ``bench_and_pair`` adds them
# back, so that the traffic, its readers and its check stay tested and the
# cell can be listed again as it stands.
PAIR = "v46-1080p-b1-pair"
_PAIR_LAYERS = (
    ("copy_ms.pair", "ms", "device_trace", "engine/session.py"),
    ("kernels_per_step.pair", "kernels", "device_trace",
     "graph/executor.py + ops/torch_ops.py"),
    ("device_idle_share.pair", "%", "device_trace", "device"),
    ("dispatch_ms.pair", "ms", "program_counter",
     "graph/executor.py + ops/torch_ops.py"),
    ("copy_host_ms.pair", "ms", "program_counter", "engine/session.py"),
    ("idle_under_dispatch_share.pair", "%", "device_trace",
     "graph/executor.py + ops/torch_ops.py"))
PAIR_ENTRIES = {
    "workloads": [{"name": PAIR, "config": "rife-v4.6-arch",
                   "traffic": "pair", "chips": 1,
                   "why": harness.workload(PAIR)["why"]}],
    "end_to_end": [{"name": f"latency_{q}_ms", "unit": "ms",
                    "better": "lower", "bound": 0.25, "source": "host_clock",
                    "workloads": [PAIR]} for q in ("p50", "p95")],
    "per_layer": [{"name": name, "unit": unit, "better": "lower",
                   "source": source, "layer": layer,
                   "moves": "latency_p50_ms", "workloads": [PAIR]}
                  for name, unit, source, layer in _PAIR_LAYERS],
}


def bench_and_pair() -> dict:
    """BENCHMARK.json with the pair cell's entries added back."""
    b = bench()
    for key, entries in PAIR_ENTRIES.items():
        b[key] = b[key] + entries
    return b


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


def v1_cell(limits=None, seed: int = 2 ** 40 + 5) -> harness.Cell:
    """The throwaway v1 configuration on the device cells' traffic at
    64x96, 5 frames, B=2, mini widths, float32, every pair sampled, on the
    CPU (``limits``: the check's, the v4.6 cells' by default)."""
    wl = harness.workload("v46-1080p-b8-device")
    wl.update(config="v1_arch", why="a throwaway v1 cell", height=64,
              width=96, frames=5, batch=2, warmup_steps=2, trace_steps=3,
              sample_steps=8)
    if limits is not None:
        wl["limits"] = dict(limits)
    cfg = dict(V1_ARCH, widths=MINI_WIDTHS["v1_arch"], dtype="float32")
    return harness.Cell("v1-tiny", seed, 0.5, False, "cpu",
                        time.perf_counter(), wl=wl, cfg=cfg)


def run(cell: harness.Cell, work: Path):
    """(the result line's object, the numbers compared with their
    limits)."""
    r = harness.run_cell(cell, bench_and_pair(), Path(work))
    return r.result, r.checks
