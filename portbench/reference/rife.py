"""The reference's frame pipelines: u8 frames in, u8 frame out.

* pre: u8 -> float32 / 255, (B,3,H,W), zero-padded bottom and right to
  multiples of 32;
* the family's pipeline (``families/<family>.py``, found by the
  configuration's ``family``): its nets on the padded frames;
* post: crop the pad, floor(v * 255 + 0.5) saturated to u8, (B,H,W,3).

``Reference.pair`` also returns the flownet's flow tap (the family's
``TAP``), the tap whose std the weights' calibration sets, so that a run
states its fixtures' flow.

The control: ``quant=fp8_e4m3`` stores the whole reference in float8 e4m3,
the precision below the configurations' bfloat16, as the program stores its
activations in bfloat16: the frames, every node's output and every
convolution's weights are rounded (a per-tensor scale), and every
operation computes in float32 on the rounded values (InnerProduct weights
are rounded as convolution weights are).
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import ncnn
from . import families, graph

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
    every convolution's operands; ``hook``: ``graph.run``'s, on every node
    of every net)."""

    def __init__(self, model_dir, family: str, nets, device,
                 quant: Optional[graph.Quant] = None, hook=None):
        self.family, self.device, self.quant = family, device, quant
        self.pipeline = families.load(family)
        self.model_dir, self.hook = model_dir, hook
        self.nets: Dict[str, Tuple[list, dict]] = {}
        for net in nets:
            nodes = ncnn.parse_param(Path(model_dir) / f"{net}.param")
            lw = ncnn.read_bin(nodes, Path(model_dir) / f"{net}.bin")
            self.nets[net] = (nodes, graph.tensors(lw, device))

    def _run(self, net, inputs, outputs):
        nodes, w = self.nets[net]
        return graph.run(nodes, w, inputs, outputs, self.quant, self.hook)

    @torch.no_grad()
    def forward(self, i0: torch.Tensor, i1: torch.Tensor, t: float):
        """Preprocessed frames -> (the float output, padded; the flow
        tap)."""
        with no_tf32():
            return self.pipeline.pair(self._run, i0, i1, t)

    @torch.no_grad()
    def pair(self, in0: torch.Tensor, in1: torch.Tensor, t: float):
        """(B,H,W,3) u8 pairs -> ((B,H,W,3) u8 frames, the flow tap)."""
        h, w = in0.shape[1], in0.shape[2]
        with no_tf32():
            out, flow = self.forward(preprocess(in0.to(self.device)),
                                     preprocess(in1.to(self.device)), t)
            return postprocess(out.float(), h, w), flow
