"""Forward pipelines, plain branches (port of the no-TTA, no-UHD branches of
``rife_tpu/engine/pipelines.py``: ``forward_v4`` and the v2 path of
``forward_v1v2``)."""

from __future__ import annotations

import torch

from ..ops import frame


def forward_v4(ex, weights, in0_u8: torch.Tensor, in1_u8: torch.Tensor,
               timestep: torch.Tensor, pad_h: int, pad_w: int,
               dtype: torch.dtype) -> torch.Tensor:
    """u8 frames (B,H,W,3) + per-item timestep (B,) -> u8 frame (B,H,W,3).

    With the fused render node (``ex.render_planar``) ``out0`` comes back as
    (B,H,3,W) planes and is finished by ``frame.postprocess_planar``."""
    h, w = in0_u8.shape[1], in0_u8.shape[2]
    b = in0_u8.shape[0]
    img0 = frame.preprocess(in0_u8, pad_h, pad_w, dtype)
    img1 = frame.preprocess(in1_u8, pad_h, pad_w, dtype)
    t = frame.timestep_plane(timestep, b, pad_h, pad_w, dtype)
    ctx = {"w": weights}
    planar = getattr(ex, "render_planar", False)
    if planar:
        ctx["planar_outputs"] = frozenset(("out0",))
    out = ex.run({"in0": img0, "in1": img1, "in2": t}, ["out0"], ctx)[0]
    if planar:
        return frame.postprocess_planar(out, h, w)
    return frame.postprocess(out, h, w)


def forward_v2(nets, weights, in0_u8: torch.Tensor, in1_u8: torch.Tensor,
               pad_h: int, pad_w: int, dtype: torch.dtype) -> torch.Tensor:
    """u8 frames (B,H,W,3) -> the u8 midpoint frame (B,H,W,3), v2 family.

    ``flownet`` gives the flow at half resolution (B,4,H/2,W/2); its two
    halves feed ONE batched ``contextnet`` run over ``cat([img0, img1])``
    (both extractions use input slot ``flow.0`` and the same subgraph,
    ``pipelines.py:119-131``); ``fusionnet`` takes the frames, the flow and
    the context features as inputs ``"3".."10"`` (frame 0's f1..f4, then
    frame 1's)."""
    h, w = in0_u8.shape[1], in0_u8.shape[2]
    b = in0_u8.shape[0]
    img0 = frame.preprocess(in0_u8, pad_h, pad_w, dtype)
    img1 = frame.preprocess(in1_u8, pad_h, pad_w, dtype)

    def run(net, inputs, outputs):
        return nets[net].run(inputs, outputs, {"w": weights[net]})

    flow = run("flownet", {"input0": img0, "input1": img1}, ["flow"])[0]
    feats = run("contextnet", {
        "input.1": torch.cat([img0, img1]),
        "flow.0": torch.cat([flow[:, 0:2], flow[:, 2:4]]),
    }, ["f1", "f2", "f3", "f4"])
    inputs = {"img0": img0, "img1": img1, "flow": flow}
    for i, f in enumerate([f[:b] for f in feats] + [f[b:] for f in feats]):
        inputs[str(3 + i)] = f
    out = run("fusionnet", inputs, ["output"])[0]
    return frame.postprocess(out, h, w)
