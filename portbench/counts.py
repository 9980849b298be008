"""The work of one step, counted from the benchmark's own graphs.

The configuration's graphs, as its writer emits them and before any
rewrite, are walked on the meta device by the reference's interpreter, which
gives every node's shapes at the cell's frame size and batch.  From them:

* every Convolution / Deconvolution site: multiply-adds (a convolution's
  k*k taps at every output; a deconvolution's taps that land inside its
  output, never the zeros of a phase form) and bytes (bf16 input, weights
  and output once, the f32 bias);
* every ``rife.Warp`` node: the bytes of the work it needs, once: its source
  (u8 where it is a copy of an input frame, bf16 otherwise), its bf16 flow
  and its bf16 output.  A warp whose output only feeds a concat that a 1/s
  bilinear downscale reads is needed at that downscale's taps alone: two
  taps an axis in every s (its source and flow at (2/s)^2 of the pixels,
  its output at 1/s^2);
* the least time of each site on the card's published peaks, the larger of
  2 * MACs over the bf16 rate and bytes over the memory rate.

The counts never read the program's plan, so they stay the same whatever
implements the work.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import torch

from . import ncnn, peaks
from .reference import graph

BF16 = 2


@dataclass
class Site:
    net: str
    name: str
    kind: str          # conv | deconv | warp
    macs: float
    bytes: float

    @property
    def least_s(self) -> float:
        return max(2.0 * self.macs / peaks.BF16_FLOP_S,
                   self.bytes / peaks.HBM_BYTES_S)


@dataclass
class Work:
    """One step of ``batch`` frames of ``h`` x ``w``."""
    batch: int
    sites: List[Site] = field(default_factory=list)

    def of(self, kind: str) -> List[Site]:
        return [s for s in self.sites if s.kind in kind.split("|")]

    @property
    def flop(self) -> float:
        return 2.0 * sum(s.macs for s in self.sites)

    @property
    def flop_per_frame(self) -> float:
        return self.flop / self.batch

    def least_s(self, kind: str) -> float:
        return sum(s.least_s for s in self.of(kind))


def _pad(v: int) -> int:
    return (v + 31) // 32 * 32


def _frame_blobs(nodes, inputs) -> set:
    """Blobs that hold values of the input frames: the inputs, their
    Split copies, and Crop / Concat of such blobs."""
    frames = set(inputs)
    for n in nodes:
        if n.type in ("Split", "Crop") and n.bottoms[0] in frames:
            frames.update(n.tops)
        elif n.type == "Concat" and all(b in frames for b in n.bottoms):
            frames.update(n.tops)
    return frames


def _downscale_after(nodes, top) -> int:
    """s where ``top`` only feeds one Concat read only by a 1/s Interp."""
    users = [n for n in nodes if top in n.bottoms]
    if len(users) != 1 or users[0].type != "Concat":
        return 1
    readers = [n for n in nodes if users[0].tops[0] in n.bottoms]
    if len(readers) != 1 or readers[0].type != "Interp":
        return 1
    scale = float(readers[0].p(1, 1.0))
    return int(round(1.0 / scale)) if scale < 1.0 else 1


def _net_inputs(cfg: dict, net: str, b: int, h: int, w: int) -> Dict[str, tuple]:
    """Input shapes of one net run, as the reference's pipelines feed it."""
    hp, wp = _pad(h), _pad(w)
    if cfg["family"] == "v4":
        return {"in0": (b, 3, hp, wp), "in1": (b, 3, hp, wp),
                "in2": (b, 1, hp, wp)}
    half = (hp // 2, wp // 2)
    if net == "flownet":
        return {"input0": (b, 3, hp, wp), "input1": (b, 3, hp, wp)}
    if net == "contextnet":  # once a frame
        return {"input.1": (2 * b, 3, hp, wp), "flow.0": (2 * b, 2, *half)}
    c = cfg["widths"][4]
    ctx = {}
    for k, (ch, div) in enumerate(((c, 4), (2 * c, 8), (4 * c, 16),
                                   (8 * c, 32))):
        for side in (0, 4):
            ctx[str(3 + k + side)] = (b, ch, hp // div, wp // div)
    return {"img0": (b, 3, hp, wp), "img1": (b, 3, hp, wp),
            "flow": (b, 4, *half), **ctx}


def count(cfg: dict, model_dir, b: int, h: int, w: int) -> Work:
    """The work of one step of the configuration's graphs in
    ``model_dir`` at batch ``b`` and frames of ``h`` x ``w``."""
    work = Work(batch=b)
    for net in cfg["nets"]:
        nodes = ncnn.parse_param(Path(model_dir) / f"{net}.param")
        frames = _frame_blobs(nodes, cfg["frame_inputs"].get(net, ()))
        meta = {}
        for n in nodes:
            shape = ncnn.weight_shape(n)
            if shape is not None:
                meta[n.name] = {"weight": torch.empty(shape, device="meta"),
                                "bias": None, "slope": None}
            elif n.type == "PReLU":
                meta[n.name] = {"weight": None, "bias": None,
                                "slope": torch.empty(int(n.p(0)),
                                                     device="meta")}
        inputs = {k: torch.empty(s, device="meta")
                  for k, s in _net_inputs(cfg, net, b, h, w).items()}

        def hook(node, xs, ys, nodes=nodes, frames=frames, net=net):
            if node.type in ("Convolution", "Deconvolution"):
                o, i, k = ncnn.conv_shape(node)
                x, y = xs[0].shape, ys[0].shape
                if node.type == "Convolution":
                    macs = y[0] * o * y[2] * y[3] * i * k * k
                else:
                    # taps landing inside the output, an axis at a time
                    s, p = int(node.p(3, 1)), int(node.p(4, 0))
                    rows = _inside(x[2], k, s, p, y[2])
                    cols = _inside(x[3], k, s, p, y[3])
                    macs = x[0] * i * o * rows * cols
                nbytes = BF16 * (xs[0].numel() + o * i * k * k + ys[0].numel())
                if int(node.p(5, 0)) == 1:
                    nbytes += 4 * o
                kind = "conv" if node.type == "Convolution" else "deconv"
                work.sites.append(Site(net, node.name, kind, float(macs),
                                       float(nbytes)))
            elif node.type == "rife.Warp":
                img, flow = xs
                src = (1 if node.bottoms[0] in frames else BF16) * img.numel()
                s = _downscale_after(nodes, node.tops[0])
                need = min(1.0, (2.0 / s) ** 2) if s > 1 else 1.0
                nbytes = (src + BF16 * flow.numel()) * need \
                    + BF16 * ys[0].numel() / (s * s)
                work.sites.append(Site(net, node.name, "warp", 0.0,
                                       float(nbytes)))

        outs = [t for n in nodes for t in n.tops if n.type != "Input"]
        graph.run(nodes, meta, inputs, outs[-1:], hook=hook)
    return work


def _inside(n: int, k: int, s: int, p: int, n_out: int) -> int:
    """Taps of a transposed conv along one axis that land in [0, n_out)."""
    return sum(1 for i in range(n) for t in range(k)
               if 0 <= i * s + t - p < n_out)
