"""The reference's frame pipelines: u8 frames in, u8 frame out.

* pre: u8 -> float32 / 255, (B,3,H,W), zero-padded bottom and right to
  multiples of 32;
* v4 family (one net): ``out0`` of the flownet on ``in0``, ``in1`` and the
  constant timestep plane ``in2``;
* v2 family (three nets, midpoint only): the flownet's half-resolution flow
  (4 channels: frame 0's flow, then frame 1's), the contextnet once a frame
  with that frame's flow as ``flow.0``, and the fusionnet on the frames, the
  flow and the features as inputs ``"3".."10"`` (frame 0's f1..f4, then
  frame 1's);
* post: crop the pad, floor(v * 255 + 0.5) saturated to u8, (B,H,W,3).

``Reference.pair`` also returns the flownet's flow tap (v4: ``flow3``, the
last block's; v2: ``flow``, at half resolution), the tap whose std the
weights' calibration sets, so that a run states its fixtures' flow.

The control: ``quant=fp8_e4m3`` stores the whole reference in float8 e4m3,
the precision below the configurations' bfloat16, as the program stores its
activations in bfloat16: the frames, every node's output and every
convolution's weights are rounded (a per-tensor scale), and every
operation computes in float32 on the rounded values.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import ncnn
from . import graph

PAD = 32


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` scaled per tensor onto float8 e4m3's range (largest magnitude
    to 448), rounded to e4m3 and scaled back."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    s = 448.0 / amax
    return ((x * s).to(torch.float8_e4m3fn).to(x.dtype)) / s


@contextlib.contextmanager
def no_tf32():
    """float32 stays float32: TF32 off, and the convolutions on PyTorch's
    own im2col + GEMM rather than cuDNN, whose float32 heuristics pick an
    FFT algorithm for some of these shapes that launches ~200,000 small
    kernels a frame (1.2-1.5 s a v2.3 pair on the H100)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.enabled)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.enabled) = prev


def _pad(v: int) -> int:
    return (v + PAD - 1) // PAD * PAD


def preprocess(u8: torch.Tensor) -> torch.Tensor:
    b, h, w, _ = u8.shape
    x = u8.permute(0, 3, 1, 2).float() / 255.0
    return F.pad(x, (0, _pad(w) - w, 0, _pad(h) - h))


def postprocess(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    v = torch.floor(x[:, :, :h, :w] * 255.0 + 0.5).clamp(0, 255)
    return v.to(torch.uint8).permute(0, 2, 3, 1).contiguous()


class Reference:
    """One model directory's nets, read from its ``.param`` and ``.bin``
    files, on ``device`` in float32 (``quant``: the control's rounding of
    every convolution's operands)."""

    def __init__(self, model_dir, family: str, nets, device,
                 quant: Optional[graph.Quant] = None):
        self.family, self.device, self.quant = family, device, quant
        self.model_dir = model_dir
        self.nets: Dict[str, Tuple[list, dict]] = {}
        for net in nets:
            nodes = ncnn.parse_param(Path(model_dir) / f"{net}.param")
            lw = ncnn.read_bin(nodes, Path(model_dir) / f"{net}.bin")
            self.nets[net] = (nodes, graph.tensors(lw, device))

    def _run(self, net, inputs, outputs):
        nodes, w = self.nets[net]
        return graph.run(nodes, w, inputs, outputs, self.quant)

    @torch.no_grad()
    def pair(self, in0: torch.Tensor, in1: torch.Tensor, t: float):
        """(B,H,W,3) u8 pairs -> ((B,H,W,3) u8 frames, the (B,4,H',W')
        flow tap)."""
        h, w = in0.shape[1], in0.shape[2]
        with no_tf32():
            i0 = preprocess(in0.to(self.device))
            i1 = preprocess(in1.to(self.device))
            if self.family == "v4":
                tp = torch.full_like(i0[:, :1], float(t))
                out, flow = self._run("flownet", {"in0": i0, "in1": i1,
                                                  "in2": tp},
                                      ["out0", "flow3"])
                return postprocess(out.float(), h, w), flow[:, :4]
            if t != 0.5:
                raise ValueError("the v2 family interpolates the midpoint")
            flow, = self._run("flownet", {"input0": i0, "input1": i1},
                              ["flow"])
            feats = ["f1", "f2", "f3", "f4"]
            c0 = self._run("contextnet", {"input.1": i0,
                                          "flow.0": flow[:, 0:2]}, feats)
            c1 = self._run("contextnet", {"input.1": i1,
                                          "flow.0": flow[:, 2:4]}, feats)
            inputs = {"img0": i0, "img1": i1, "flow": flow}
            for k, f in enumerate(c0 + c1):
                inputs[str(3 + k)] = f
            out, = self._run("fusionnet", inputs, ["output"])
            return postprocess(out.float(), h, w), flow
