"""The port's profiling helpers (``rife_tpu_torch/utils/profiling.py``) on
the CPU: ``trace`` is a no-op without a log dir, writes a TensorBoard
Chrome trace under one given as an argument or through
``RIFE_TORCH_TRACE``, and refuses a trace without CUDA events where it was
asked to record the card; ``WallTimer`` reads as ``rife_tpu``'s does under
one clock."""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from rife_tpu.utils import profiling as jprof
from rife_tpu_torch.utils import profiling as prof

LABEL = "rife_test_section"


def traced_work():
    with torch.profiler.record_function(LABEL):
        return torch.ones(8, 8).matmul(torch.ones(8, 8)).sum()


def trace_files(root):
    return sorted(root.rglob("*.pt.trace.json"))


def test_trace_without_a_log_dir_is_a_no_op(monkeypatch, tmp_path):
    monkeypatch.delenv("RIFE_TORCH_TRACE", raising=False)
    monkeypatch.chdir(tmp_path)

    def no_profiler(*a, **k):
        raise AssertionError("the profiler started")
    monkeypatch.setattr(torch.profiler, "profile", no_profiler)
    with prof.trace():
        traced_work()
    with prof.trace(""):
        traced_work()
    assert not any(tmp_path.iterdir())


def names_in(path):
    return {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}


def test_trace_writes_a_chrome_trace(monkeypatch, tmp_path):
    monkeypatch.delenv("RIFE_TORCH_TRACE", raising=False)
    logdir = tmp_path / "trace"
    with prof.trace(str(logdir)):
        traced_work()
    files = trace_files(logdir)
    assert len(files) == 1
    assert LABEL in names_in(files[0])


def test_trace_from_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("RIFE_TORCH_TRACE", str(tmp_path))
    with prof.trace():
        traced_work()
    files = trace_files(tmp_path)
    assert len(files) == 1
    assert LABEL in names_in(files[0])


def test_device_events_required():
    cpu = SimpleNamespace(device_type=torch.autograd.DeviceType.CPU)
    cuda = SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA)
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        prof.require_device_events([cpu, cpu])
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        prof.require_device_events([])
    prof.require_device_events([cpu, cuda])


class FakeClock:
    """``time.perf_counter`` advancing by 0.25, 0.5, 0.75, ... a call."""

    def __init__(self):
        self.t, self.step = 0.0, 0.0

    def __call__(self):
        self.step += 0.25
        self.t += self.step
        return self.t


def drive(timer):
    """Nested and repeated sections, one left by an exception."""
    for _ in range(3):
        with timer.section("outer"):
            with timer.section("inner"):
                pass
            with timer.section("inner"):
                pass
    with pytest.raises(ValueError):
        with timer.section("raises"):
            raise ValueError
    with timer.section("a_first"):
        pass
    return timer


def test_wall_timer_reads_as_rife_tpus(monkeypatch):
    monkeypatch.setattr(time, "perf_counter", FakeClock())
    want = drive(jprof.WallTimer())
    monkeypatch.setattr(time, "perf_counter", FakeClock())
    got = drive(prof.WallTimer())
    assert got.totals == want.totals
    assert got.counts == want.counts == {"outer": 3, "inner": 6,
                                         "raises": 1, "a_first": 1}
    assert got.report() == want.report()
    assert got.report().splitlines()[0].startswith("a_first: ")
