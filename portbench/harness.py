"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name:

* ``portbench/workloads/<cell>.json``: its configuration, traffic kind and
  the traffic's parameters, and the limits of its check;
* ``portbench/configs/<config>.json``: the model (graph writer, widths,
  dtype, weight scales);
* ``portbench/traffic/<kind>.py``: the one driver of that traffic kind;
* ``portbench/metrics/<metric>.py``: one reader a per-layer metric;
* ``portbench/kernels/*.json``: the kernel families of the trace;
* ``BENCHMARK.json``: which end-to-end and per-layer metrics a cell reports.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, counts, scene, trace, weights
from .seeds import derive

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rife_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def workload(name: str, pkg: Path = PKG) -> dict:
    return load_json(pkg / "workloads" / f"{name}.json")


def config(name: str, pkg: Path = PKG) -> dict:
    return load_json(pkg / "configs" / f"{name}.json")


def traffic_module(kind: str):
    return importlib.import_module(f"portbench.traffic.{kind}")


def metric_reader(name: str, pkg: Path = PKG):
    """The module of ``portbench/metrics/<name>.py`` (names may hold dots)."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole (``rife_tpu_torch`` is not ``rife_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclass
class Outcome:
    """What a traffic driver's window produced."""
    metrics: Dict[str, float]
    attempted: int
    failed: int = 0
    missing: int = 0
    sample: List[Tuple[int, object]] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)


class Cell:
    """One run of a cell: its files, seed, window and device."""

    def __init__(self, name: str, seed: int, seconds: float, traced: bool,
                 device, t_start: float, pkg: Path = PKG, wl=None, cfg=None):
        self.name, self.seed, self.seconds = name, int(seed), float(seconds)
        self.traced = bool(traced)
        self.device = torch.device(device)
        self.t_start = t_start
        self.pkg = pkg
        self.wl = wl if wl is not None else workload(name, pkg)
        self.cfg = cfg if cfg is not None else config(self.wl["config"], pkg)
        self.dtype = getattr(torch, self.cfg["dtype"])
        self.profiler = trace.Profiler(self.traced, self.device.type == "cuda")
        self.t_window: Optional[float] = None
        self.excluded_s = 0.0  # reference work before the window

    def rng(self, purpose: str) -> np.random.Generator:
        return np.random.default_rng(derive(self.seed, purpose))

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def done_marker(self):
        """An object whose ``synchronize()`` waits for the work queued so
        far (a CUDA event on the card; nothing to wait for on the CPU)."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            return ev
        return _Done()

    def start_window(self) -> float:
        """Called just before the first timed call: set-up ends here."""
        self.t_window = time.perf_counter()
        return self.t_window

    @property
    def setup_s(self) -> float:
        return self.t_window - self.t_start - self.excluded_s


class _Done:
    def synchronize(self):
        pass


def selected(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics of ``BENCHMARK.json`` that ``cell`` reports: its
    end-to-end metrics without a trace, its per-layer metrics with one (a
    per-layer metric without ``workloads`` goes with the end-to-end metric
    it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def model_dir_for(cell: Cell, work_root: Path, pair) -> Tuple[Path, dict]:
    """Write the configuration's graphs and the seed's weights under the
    checkout's ``portbench/_work`` (the flownet calibrated on ``pair``);
    the returned path is relative to the working directory where it can be
    (the program picks the pipeline from the directory's name)."""
    md, info = weights.write_model(cell.cfg, work_root / cell.cfg["name"],
                                   cell.seed, cell.device, pair)
    return Path(os.path.relpath(md)), info


@dataclass
class Run:
    """One run's result line, the numbers compared with their limits, and
    what was judged: the sampled answers, the clip and the model."""
    result: dict
    checks: Dict[str, Tuple[float, float]]
    sample: List[Tuple[int, object]]
    clip: torch.Tensor
    model_dir: Path
    flow_std_px: float
    weights: dict


def run_cell(cell: Cell, bench: dict, work_root: Path) -> Run:
    """Set up, measure, check."""
    from rife_tpu_torch import RIFE

    wl = cell.wl
    h, w = wl["height"], wl["width"]
    marks = [("start", cell.t_start), ("imports", time.perf_counter())]
    clip = scene.clip(derive(cell.seed, "clip"), wl["frames"], h, w,
                      wl["pan_px"], cell.device)
    model_dir, scales = model_dir_for(cell, work_root, clip[:2])
    # the flownet's scale search runs the reference: kept out of set-up,
    # as the check is
    cell.excluded_s += scales.get("calibration_s", 0.0)
    marks.append(("clip and weights", time.perf_counter()))
    sess = RIFE(str(model_dir), device=cell.device, dtype=cell.dtype)
    marks.append(("session", time.perf_counter()))
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    out = traffic_module(wl["traffic"]).run(cell, sess, clip)
    marks.append(("warm-up", cell.t_window))
    tr = cell.profiler.read(out.counters["window_s"])
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    del sess
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()

    metrics: Dict[str, dict] = {}
    values = dict(out.metrics, setup_s=cell.setup_s)
    view = None
    if cell.traced:
        work = counts.count(cell.cfg, model_dir, wl.get("batch", 1), h, w)
        view = MetricView(cell, out, tr, work)
    for m in selected(bench, cell.name, cell.traced):
        if cell.traced:
            v = metric_reader(m["name"], cell.pkg).read(view)
        else:
            v = values.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    ref = check.Reference(model_dir, cell.cfg["family"], cell.cfg["nets"],
                          cell.device)
    limits = wl.get("limits", {})
    want = tuple(k for k in check.NUMBERS if k in limits)
    numbers, flow_std = check.compare(out.sample, ref, clip,
                                      wl.get("timestep", 0.5), want)
    numbers["missing"] = float(out.missing)
    print(f"weights: {json.dumps(scales)}; reference flow std {flow_std!r} "
          f"px over the sampled pairs; {len(out.sample)} answers compared",
          flush=True)
    print("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks, marks[1:]))
        + f"; the scale search's {cell.excluded_s:.3f} s not counted",
        flush=True)
    for line in out.notes:
        print(line, flush=True)
    checks = {k: (numbers[k], float(v)) for k, v in limits.items()}
    correct = bool(checks) and all(v <= lim for v, lim in checks.values())
    device = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": device}
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return Run(result, checks, out.sample, clip, model_dir, flow_std, scales)


@dataclass
class MetricView:
    """What a per-layer metric's reader may read."""
    cell: Cell
    outcome: Outcome
    trace: Optional[trace.Trace]
    work: counts.Work
