"""v4 forward pipeline, plain branch (port of the no-TTA branch of
``rife_tpu/engine/pipelines.py:forward_v4``)."""

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
