"""The benchmark finds configurations, cells, metrics and kernel families
by name, and a new one of each is a new file alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness, trace
from portbench.testing import (MINI_WIDTHS, ROOT, V1_ARCH, bench,
                               bench_and_pair)

B = bench()
# with the pair cell, which BENCHMARK.json no longer lists (testing.py)
ALL = bench_and_pair()
CONTRACT_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
                 "end_to_end", "per_layer"}


def test_benchmark_json_shape():
    assert set(B) == CONTRACT_KEYS
    assert {m["name"] for m in B["end_to_end"]} >= {"setup_s"}
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("cell", [c["name"] for c in ALL["workloads"]])
def test_cell_files(cell):
    entry = next(c for c in ALL["workloads"] if c["name"] == cell)
    wl = harness.workload(cell)
    assert wl["config"] == entry["config"] and wl["traffic"] == entry["traffic"]
    assert wl["why"] == entry["why"] and len(wl["why"]) <= 200
    cfg = harness.config(wl["config"])
    assert cfg["name"] == wl["config"]
    assert harness.traffic_module(wl["traffic"]).run
    reported = {m["name"] for m in harness.selected(ALL, cell, False)}
    assert "setup_s" in reported and len(reported) >= 2
    per_layer = harness.selected(ALL, cell, True)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in reported
    assert set(wl["limits"]) <= set(
        ("worst_frame_mean_abs_u8", "mean_abs_u8", "worst_frame_off5_share",
         "duplicate_answers", "missing"))


@pytest.mark.parametrize("cfg", [c["name"] for c in B["configs"]])
def test_config_files(cfg):
    entry = next(c for c in B["configs"] if c["name"] == cfg)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == cfg and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"] == []
    assert data["dtype"] == "bfloat16"


@pytest.mark.parametrize("metric", [m["name"] for m in ALL["per_layer"]])
def test_metric_readers(metric):
    m = next(x for x in ALL["per_layer"] if x["name"] == metric)
    mod = harness.metric_reader(metric)
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"],
                                                m["moves"])
    kinds = {harness.workload(c)["traffic"] for c in m["workloads"]}
    assert kinds == set(mod.KINDS)


def test_kernel_families():
    fams = trace.families()
    assert {k for k, _ in fams} == {"conv", "warp"}
    assert trace.kind_of("void warp_gather_kernel<true>(...)", fams) == "warp"
    assert trace.kind_of("conv3x3_tc_kernel(TcArgs)", fams) == "conv"
    assert trace.kind_of(
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
        fams) == "conv"
    assert trace.kind_of("void at::native::vectorized_elementwise_kernel"
                         "<4, at::native::CUDAFunctor_add<c10::BFloat16>>",
                         fams) == "glue"


def test_new_files_alone_add_a_config_cell_metric_and_family(tmp_path,
                                                             monkeypatch):
    """A throwaway configuration, cell, per-layer metric and kernel family,
    added as files to a copy of the benchmark, are found with no edit of a
    file that was there; so are a v1 configuration and its cell, which run
    through the harness in the copy on the CPU, and a pipeline family."""
    pkg = tmp_path / "portbench"
    shutil.copytree(harness.PKG, pkg, ignore=shutil.ignore_patterns(
        "_work", "__pycache__"))
    cfg = json.loads((pkg / "configs" / "rife-v4.6-arch.json").read_text())
    cfg.update(name="tiny-v4", widths=[8, 8, 8, 8])
    (pkg / "configs" / "tiny-v4.json").write_text(json.dumps(cfg))
    wl = harness.workload("v46-1080p-b1-pair", pkg)
    wl.update(config="tiny-v4", why="a throwaway cell")
    (pkg / "workloads" / "tiny-pair.json").write_text(json.dumps(wl))
    (pkg / "metrics" / "calls_per_s.pair.py").write_text(
        'LAYER = "engine/session.py"\nUNIT = "calls/s"\n'
        'MOVES = "latency_p50_ms"\nKINDS = ("pair",)\n\n\n'
        'def read(view):\n    c = view.outcome.counters\n'
        '    return c["calls"] / c["window_s"]\n')
    (pkg / "kernels" / "zz_fused.json").write_text(json.dumps(
        {"kind": "fused", "patterns": ["fused_glue_kernel"]}))
    bench = dict(ALL)
    bench["workloads"] = ALL["workloads"] + [{
        "name": "tiny-pair", "config": "tiny-v4", "traffic": "pair",
        "chips": 1, "why": "a throwaway cell"}]
    bench["per_layer"] = ALL["per_layer"] + [{
        "name": "calls_per_s.pair", "unit": "calls/s", "better": "higher",
        "source": "host_clock", "layer": "engine/session.py",
        "moves": "latency_p50_ms", "workloads": ["tiny-pair"]}]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["tiny-pair"])
                           if m["name"].startswith("latency") else m
                           for m in ALL["end_to_end"]]
    assert harness.workload("tiny-pair", pkg)["config"] == "tiny-v4"
    assert harness.config("tiny-v4", pkg)["widths"] == [8, 8, 8, 8]
    names = [m["name"] for m in harness.selected(bench, "tiny-pair", True)]
    assert "calls_per_s.pair" in names and "copy_ms.pair" not in names
    mod = harness.metric_reader("calls_per_s.pair", pkg)
    view = harness.MetricView(None, harness.Outcome(
        metrics={}, attempted=4, counters={"calls": 4, "window_s": 2.0}),
        None, None)
    assert mod.read(view) == 2.0
    fams = trace.families(pkg / "kernels")
    assert trace.kind_of("fused_glue_kernel<1>", fams) == "fused"
    assert sys.modules  # the copy imported nothing new by name

    # v1: a configuration and a cell as files, and a pipeline family (here
    # v1's again under another name) as one more
    (pkg / "configs" / "v1_arch.json").write_text(json.dumps(dict(
        V1_ARCH, widths=MINI_WIDTHS["v1_arch"], dtype="float32")))
    wl = harness.workload("v46-1080p-b8-device", pkg)
    wl.update(config="v1_arch", why="a throwaway v1 cell", height=64,
              width=96, frames=5, batch=2, warmup_steps=2, sample_steps=8)
    (pkg / "workloads" / "v1-tiny.json").write_text(json.dumps(wl))
    (pkg / "reference" / "families" / "v1copy.py").write_text(
        "from .v1 import *  # noqa: F401,F403\n")
    v1 = dict(B, workloads=B["workloads"] + [{
        "name": "v1-tiny", "config": "v1_arch", "traffic": "device_batch",
        "chips": 1, "why": "a throwaway v1 cell"}])
    v1["end_to_end"] = [dict(m, workloads=m["workloads"] + ["v1-tiny"])
                        if m["name"] == "frames_per_s" else m
                        for m in B["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(v1))
    code = f"""
import json, time
from pathlib import Path
import numpy as np
from portbench import harness
from portbench.reference import families
from portbench.reference.rife import Reference
assert harness.PKG == Path({str(pkg)!r}), harness.PKG
assert families.load("v1copy").TAP == families.load("v1").TAP
cell = harness.Cell("v1-tiny", 2 ** 40 + 9, 0.5, False, "cpu",
                    time.perf_counter())
r = harness.run_cell(cell, json.loads(Path("BENCHMARK.json").read_text()),
                     Path("work"))
ref = Reference(r.model_dir, cell.cfg["family"], cell.cfg["nets"], "cpu")
d = np.concatenate([np.abs(np.asarray(f, np.int16) - ref.pair(
    r.clip[p:p + 1], r.clip[p + 1:p + 2], 0.5)[0][0].numpy().astype(
    np.int16)).ravel() for p, f in r.sample])
print(json.dumps({{"correct": r.result["correct"],
                  "metrics": sorted(r.result["metrics"]),
                  "pairs": len({{p for p, _ in r.sample}}),
                  "max": int(d.max()), "equal": float((d == 0).mean())}}))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] is True and got["pairs"] >= 2
    assert got["metrics"] == ["frames_per_s", "setup_s"]
    assert got["max"] <= 1 and got["equal"] >= 0.999


class _Ev:
    def __init__(self, name, t0, t1, cuda=False, annotation=False):
        self._n, self._t0, self._t1 = name, t0, t1
        self._cuda, self._ann = cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._ann


def test_trace_reading_by_hand():
    """Busy time is the union of device intervals (two streams overlapping
    count once), clipped to the window; gaps go to the innermost host
    event at their middle."""
    w = trace.WINDOW
    events = [
        _Ev(w, 1000, 11000, annotation=True),
        _Ev(w, 1000, 11000, cuda=True, annotation=True),
        _Ev("warp_gather_kernel<1>", 2000, 4000, cuda=True),
        _Ev("vectorized_elementwise_kernel", 3000, 5000, cuda=True),
        _Ev("Memcpy HtoD (Pageable -> Device)", 8000, 9000, cuda=True),
        _Ev("conv3x3_tc_kernel", 0, 1500, cuda=True),  # half outside
        _Ev("aten::copy_", 5000, 8000),
        _Ev("cudaMemcpyAsync", 6000, 7500),
    ]
    tr = trace.read(events, trace.families())
    assert tr.window_s == 10000 / 1e9
    assert tr.busy_s == (500 + 3000 + 1000) / 1e9
    assert tr.kernels == 3
    assert tr.device_by_kind["warp"] == 2000 / 1e9
    assert tr.device_by_kind["conv"] == 500 / 1e9
    assert tr.device_by_kind["glue"] == 2000 / 1e9
    assert tr.copies_s["HtoD"] == 1000 / 1e9
    # gaps: 1500-2000 (no host event), 5000-8000 (mid 6500: the memcpy
    # call inside the copy), 9000-11000 (none)
    assert tr.idle_by_host["cudaMemcpyAsync"] == 3000 / 1e9
    assert abs(tr.idle_by_host["(no traced host event)"] - 2500 / 1e9) < 1e-15
    assert abs(tr.busy_s + sum(tr.idle_by_host.values()) - tr.window_s) < 1e-15


def test_trace_window_without_span():
    """The measured window's profile has CUDA activity alone and no span:
    every device event counts, over the window's length by the host
    clock; the idle gaps come from the span after it."""
    events = [
        _Ev("warp_gather_kernel<1>", 2000, 4000, cuda=True),
        _Ev("vectorized_elementwise_kernel", 3000, 5000, cuda=True),
        _Ev("Memcpy DtoH (Device -> Pageable)", 8000, 9000, cuda=True),
        _Ev("cudaLaunchKernel", 1900, 1950),
    ]
    tr = trace.read(events, trace.families(), window_s=1e-5)
    assert tr.window_s == 1e-5 and tr.busy_s == 4000 / 1e9
    assert tr.kernels == 2 and tr.copies_s["DtoH"] == 1000 / 1e9
    assert tr.idle_by_host == {}
    with pytest.raises(RuntimeError):
        trace.read(events, trace.families())
