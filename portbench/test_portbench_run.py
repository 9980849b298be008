"""Whole runs of mini cells on the CPU: the result line's keys, the refusal
without a card, and ``correct`` turning false under a broken timed path."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness, run, testing

CELLS = ["v46-1080p-b8-device", "v23-1080p-b8-device", "v46-1080p-b8-host",
         "v46-1080p-b1-pair"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tmp_path, cell, traced):
    c = testing.mini_cell(cell, traced=traced, dtype="float32")
    result, checks = testing.run(c, tmp_path)
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["checks"]) == set(c.wl["limits"])
    for v, lim in checks.values():
        assert v <= lim
    expect = {m["name"] for m in harness.selected(testing.bench(), cell,
                                                  traced)}
    if traced:
        # no device on the CPU: only the host's counters have a reading
        assert set(result["metrics"]) <= expect
        assert result["device"]["window_s"] > 0 and "breakdown" in result
    else:
        assert set(result["metrics"]) == expect
        assert result["metrics"]["setup_s"]["value"] > 0
        # the scale search's reference passes are not set-up
        assert c.excluded_s > 0
        assert abs(result["metrics"]["setup_s"]["value"] - (
            c.t_window - c.t_start - c.excluded_s)) < 1e-9
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(result)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(testing.ROOT)
    rc = run.main(["--workload", "v46-1080p-b1-pair", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_no_card_subprocess():
    """The command as the driver runs it, on a host without a card."""
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "v46-1080p-b8-device", "--seed", str(2 ** 33 + 1), "--seconds", "1",
         "--trace", "0"], cwd=testing.ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": "/nonexistent"} | {k: v for k, v in
                                         __import__("os").environ.items()
                                         if k.startswith("PYTHON")},
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


class _Broken:
    """The program's session with its timed path broken underneath:
    ``altered``: the first answer of every call comes out with its colour
    channels reversed; ``half_batch``: the second half of every batch is
    left out, its rows keeping what the previous call left there (zeros
    at first)."""

    def __init__(self, sess, fault):
        self._s, self.fault = sess, fault
        self._last = None

    def __getattr__(self, k):
        return getattr(self._s, k)

    def _break(self, out):
        out = torch.as_tensor(out).clone()
        if self.fault == "altered":
            out[0] = out[0].flip(-1)
        elif self.fault == "half_batch":
            n = out.shape[0]
            stale = (torch.zeros_like(out) if self._last is None
                     else self._last)
            out[n - n // 2:] = stale[n - n // 2:]
            self._last = out.clone()
        return out

    def process_batch_device(self, a, b, ts):
        return self._break(self._s.process_batch_device(a, b, ts))

    def process_batch(self, a, b, ts):
        return self._break(self._s.process_batch(a, b, ts)).numpy()

    def process(self, a, b, t=0.5):
        return self.process_batch(a[None], b[None],
                                  np.asarray([t], np.float32))[0]


@pytest.mark.parametrize("cell,fault", [
    ("v46-1080p-b8-device", "altered"), ("v46-1080p-b8-device", "half_batch"),
    ("v23-1080p-b8-device", "altered"), ("v23-1080p-b8-device", "half_batch"),
    ("v46-1080p-b8-host", "altered"), ("v46-1080p-b8-host", "half_batch"),
    ("v46-1080p-b1-pair", "altered")])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    import rife_tpu_torch

    real = rife_tpu_torch.RIFE
    monkeypatch.setattr(rife_tpu_torch, "RIFE",
                        lambda *a, **k: _Broken(real(*a, **k), fault))
    c = testing.mini_cell(cell, dtype="float32")
    if "batch" in c.wl:
        c.wl["sample_steps"] = 8
        c.wl["sample_tasks"] = 8
    result, checks = testing.run(c, tmp_path)
    assert result["correct"] is False
    assert any(v > lim for v, lim in checks.values())


class _TapFault:
    """``torch.nn.functional`` as the program's ops see it, with every
    convolution's taps broken: ``centre``: the off-centre taps left out;
    ``flipped``: the kernel flipped in both directions; ``transposed``:
    the kernel transposed."""

    def __init__(self, fault):
        self.fault = fault

    def __getattr__(self, k):
        return getattr(torch.nn.functional, k)

    def _taps(self, w):
        if self.fault == "centre":
            keep = torch.zeros_like(w)
            c = w.shape[-1] // 2
            keep[..., c, c] = 1
            return w * keep
        if self.fault == "flipped":
            return w.flip(-1, -2)
        return w.transpose(-1, -2)

    def conv2d(self, x, w, *a, **k):
        return torch.nn.functional.conv2d(x, self._taps(w), *a, **k)

    def conv_transpose2d(self, x, w, *a, **k):
        return torch.nn.functional.conv_transpose2d(x, self._taps(w), *a,
                                                    **k)


@pytest.mark.parametrize("fault", ["centre", "flipped", "transposed"])
@pytest.mark.parametrize("cell", ["v46-1080p-b8-device",
                                  "v23-1080p-b8-device"])
def test_off_centre_tap_fault_is_not_correct(tmp_path, monkeypatch, cell,
                                             fault):
    """A convolution that reads its taps wrong (the off-centre taps left
    out, the kernel flipped or transposed) in the program's timed path
    turns ``correct`` false: the benchmark's weights weight every tap."""
    from rife_tpu_torch.ops import torch_ops

    monkeypatch.setattr(torch_ops, "F", _TapFault(fault))
    c = testing.mini_cell(cell, dtype="float32")
    result, checks = testing.run(c, tmp_path)
    assert result["correct"] is False
    assert any(v > lim for v, lim in checks.values())
