"""The v1 family through the whole harness on the CPU, with the throwaway v1
configuration (``testing.V1_ARCH``; the benchmark has no v1 cell yet): the
program in float32 agrees with the reference, the squeeze-excitation gates
are not saturated, and faults planted in the program's timed path turn
``correct`` false.

A float32 run agrees with the float32 reference to ~1e-4 u8 levels a frame,
so these runs are held to float32 limits (``F32_LIMITS``): they show that
the reference computes what the program should, gate by gate and net by
net.  Which of these faults a bfloat16 cell's limits catch is a reading on
the card (PERF.md)."""

import numpy as np
import pytest
import torch

from portbench import testing
from portbench.reference.rife import Reference

F32_LIMITS = {"worst_frame_mean_abs_u8": 0.05, "mean_abs_u8": 0.05,
              "duplicate_answers": 0, "missing": 0}


def test_v1_sound_run(tmp_path):
    c = testing.v1_cell(F32_LIMITS)
    r = testing.harness.run_cell(c, testing.bench(), tmp_path)
    assert r.result["correct"] is True and r.result["failed"] == 0
    assert len({p for p, _ in r.sample}) >= 2  # a whole step judged
    assert 0.8 <= r.weights["se_gate_share"] <= 1.0
    ref = Reference(r.model_dir, "v1", c.cfg["nets"], "cpu")
    d = np.concatenate([
        np.abs(np.asarray(frame, np.int16)
               - ref.pair(r.clip[p:p + 1], r.clip[p + 1:p + 2],
                          0.5)[0][0].numpy().astype(np.int16)).ravel()
        for p, frame in r.sample])
    assert d.max() <= 1 and (d == 0).mean() >= 0.999
    assert r.flow_std_px > 0.5


def _se_dropped(monkeypatch):
    """The gate's multiply left out: the map passes ungated."""
    from rife_tpu_torch.ops import torch_ops

    real = torch_ops.OP_TABLE["BinaryOp"]

    def op(node, inputs, w, ctx):
        if (int(node.p(0, 0)) == 2 and len(inputs) == 2
                and min(x.ndim for x in inputs) == 2):
            return [max(inputs, key=lambda x: x.ndim)]
        return real(node, inputs, w, ctx)

    monkeypatch.setitem(torch_ops.OP_TABLE, "BinaryOp", op)


def _ip_transposed(monkeypatch):
    """Every InnerProduct's stored (out, in) weight read as (in, out)."""
    from rife_tpu_torch.ops import torch_ops

    real = torch_ops.OP_TABLE["InnerProduct"]

    def op(node, inputs, w, ctx):
        p = ctx["w"][node.name]
        o, i = p["weight"].shape
        moved = dict(p, weight=p["weight"].reshape(i, o).t())
        return real(node, inputs, w, dict(ctx, w={node.name: moved}))

    monkeypatch.setitem(torch_ops.OP_TABLE, "InnerProduct", op)


def _flow_unnegated(monkeypatch):
    """Frame 1's contextnet fed the flow as ``flow.0``: the graph's
    negation skipped."""
    from rife_tpu_torch.engine import pipelines

    real = pipelines._v1v2_render

    def render(run, family, *args):
        def run1(net, inputs, outputs):
            if net == "contextnet" and "flow.1" in inputs:
                inputs = {"input.1": inputs["input.1"],
                          "flow.0": inputs["flow.1"]}
            return run(net, inputs, outputs)
        return real(run1, family, *args)

    monkeypatch.setattr(pipelines, "_v1v2_render", render)


@pytest.mark.parametrize("plant", [_se_dropped, _ip_transposed,
                                   _flow_unnegated],
                         ids=["se_dropped", "ip_transposed",
                              "flow_unnegated"])
def test_v1_fault_is_not_correct(tmp_path, monkeypatch, plant):
    plant(monkeypatch)
    result, checks = testing.run(testing.v1_cell(F32_LIMITS), tmp_path)
    assert result["correct"] is False
    assert any(v > lim for v, lim in checks.values())


def test_v1_contextnet_runs_negate_frame_1s_flow(tmp_path):
    """The reference's frame-1 contextnet run warps by -flow: fed the
    negated flow as ``flow.0`` it gives the same features."""
    from portbench import scene, weights

    cfg = dict(testing.V1_ARCH, widths=testing.MINI_WIDTHS["v1_arch"])
    clip = scene.clip(3, 2, 64, 96, 2, "cpu")
    md, _ = weights.write_model(cfg, tmp_path, 3, "cpu", clip)
    ref = Reference(md, "v1", cfg["nets"], "cpu")
    img = clip[:1].permute(0, 3, 1, 2).float() / 255
    flow = torch.randn(1, 2, 32, 48,
                       generator=torch.Generator().manual_seed(1))
    feats = ["f1", "f2", "f3", "f4"]
    with torch.no_grad():
        a = ref._run("contextnet", {"input.1": img, "flow.1": flow}, feats)
        b = ref._run("contextnet", {"input.1": img, "flow.0": -flow}, feats)
        c = ref._run("contextnet", {"input.1": img, "flow.0": flow}, feats)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
