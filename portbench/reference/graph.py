"""A plain interpreter of the ncnn layers of the RIFE graphs, NCHW, on
``torch.nn.functional``.

Semantics, layer by layer (the ncnn definitions the model format fixes):

* ``Convolution`` / ``Deconvolution``: ``F.conv2d`` / ``F.conv_transpose2d``
  with the stored (out, in, k, k) / (in, out, k, k) weights, stride ``3=``,
  padding ``4=``, bias when ``5=1``, then the fused activation ``9=`` (2: leaky
  relu with slope ``-23310[0]``);
* ``Interp`` ``0=2``: half-pixel bilinear (``align_corners=False``, no
  antialiasing) to round(size * scale);
* ``rife.Warp``: backward bilinear warp of the image at (x + u, y + v),
  corners clamped to the border;
* ``Crop`` / ``Slice`` on the channel axis, ``Concat`` on channels,
  ``BinaryOp`` (with a scalar when ``1=1``), ``Eltwise`` weighted sums,
  ``PixelShuffle``, ``Sigmoid``, ``PReLU``, ``Clip``.

``quant`` (the control's storage precision) rounds the graph's inputs, every
node's outputs and every convolution's weights.  ``hook(node, inputs, outputs)`` sees every node (the work
counts run the interpreter on the meta device with one).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..ncnn import Node

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward bilinear warp: out[y, x] samples ``img`` at
    (x + flow[0], y + flow[1]), each corner index clamped into the image;
    positions and sums in float32, the result in ``img``'s dtype."""
    b, c, h, w = img.shape
    if img.device.type == "meta":
        return torch.empty_like(img)
    dtype, img, flow = img.dtype, img.float(), flow.float()
    gx = torch.arange(w, device=img.device, dtype=img.dtype).view(1, 1, w)
    gy = torch.arange(h, device=img.device, dtype=img.dtype).view(1, h, 1)
    sx = gx + flow[:, 0]
    sy = gy + flow[:, 1]
    x0 = torch.floor(sx).clamp(0, w - 1)
    y0 = torch.floor(sy).clamp(0, h - 1)
    a = (sx - x0).clamp(0, 1).unsqueeze(1)
    bb = (sy - y0).clamp(0, 1).unsqueeze(1)
    x0, y0 = x0.long(), y0.long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    flat = img.reshape(b, c, h * w)

    def at(yy, xx):
        idx = (yy * w + xx).view(b, 1, h * w).expand(b, c, h * w)
        return flat.gather(2, idx).view(b, c, h, w)

    return ((at(y0, x0) * (1 - a) + at(y0, x1) * a) * (1 - bb)
            + (at(y1, x0) * (1 - a) + at(y1, x1) * a) * bb).to(dtype)


def _act(node: Node, y: torch.Tensor) -> torch.Tensor:
    act = int(node.p(9, 0))
    if act == 0:
        return y
    params = node.p(-23310, [])
    params = params if isinstance(params, list) else [params]
    if act == 1:
        return F.relu(y)
    if act == 2:
        return F.leaky_relu(y, float(params[0]))
    raise NotImplementedError(f"{node.name}: activation {act}")


def _conv(node: Node, x, p, quant: Quant):
    w = p["weight"] if quant is None else quant(p["weight"])
    stride, pad = int(node.p(3, 1)), int(node.p(4, 0))
    if node.type == "Convolution":
        y = F.conv2d(x, w, p["bias"], stride=stride, padding=pad)
    else:
        y = F.conv_transpose2d(x, w, p["bias"], stride=stride, padding=pad)
    return _act(node, y)


def _channels(node: Node, x, starts, ends):
    return x[:, int(starts[0]):int(ends[0])]


_BINARY = {
    0: lambda a, b: a + b, 1: lambda a, b: a - b, 2: lambda a, b: a * b,
    3: lambda a, b: a / b, 4: torch.maximum, 5: torch.minimum,
    7: lambda a, b: b - a, 8: lambda a, b: b / a,
}


def _node(node: Node, xs: List[torch.Tensor], p, quant: Quant):
    t = node.type
    if t == "Split":
        return [xs[0]] * len(node.tops)
    if t in ("Convolution", "Deconvolution"):
        return [_conv(node, xs[0], p, quant)]
    if t == "Concat":
        if int(node.p(0, 0)) != 0:
            raise NotImplementedError(f"{node.name}: concat axis")
        return [torch.cat(xs, dim=1)]
    if t == "Interp":
        if int(node.p(0, 0)) != 2:
            raise NotImplementedError(f"{node.name}: resize type")
        h, w = xs[0].shape[2:]
        size = (int(round(h * float(node.p(1, 1.0)))),
                int(round(w * float(node.p(2, 1.0)))))
        return [F.interpolate(xs[0], size=size, mode="bilinear",
                              align_corners=False)]
    if t == "rife.Warp":
        return [warp(xs[0], xs[1])]
    if t == "Crop":
        if list(node.p(-23311, [])) != [0]:
            raise NotImplementedError(f"{node.name}: crop axes")
        return [_channels(node, xs[0], node.p(-23309), node.p(-23310))]
    if t == "Slice":
        if int(node.p(1, 0)) != 0:
            raise NotImplementedError(f"{node.name}: slice axis")
        sizes = [int(s) for s in node.p(-23300)]
        return list(torch.split(xs[0], sizes, dim=1))
    if t == "BinaryOp":
        op = _BINARY[int(node.p(0, 0))]
        if int(node.p(1, 0)) == 1:
            return [op(xs[0], float(node.p(2, 0.0)))]
        return [op(xs[0], xs[1])]
    if t == "Eltwise":
        if int(node.p(0, 0)) != 1:
            raise NotImplementedError(f"{node.name}: eltwise op")
        coeffs = [float(c) for c in node.p(-23301, [])] or [1.0] * len(xs)
        acc = xs[0] * coeffs[0]
        for x, cf in zip(xs[1:], coeffs[1:]):
            acc = acc + x * cf
        return [acc]
    if t == "PixelShuffle":
        return [F.pixel_shuffle(xs[0], int(node.p(0, 1)))]
    if t == "Sigmoid":
        return [torch.sigmoid(xs[0])]
    if t == "PReLU":
        return [F.prelu(xs[0], p["slope"])]
    if t == "Clip":
        return [xs[0].clamp(float(node.p(0)), float(node.p(1)))]
    raise NotImplementedError(f"layer kind {t} ({node.name})")


def run(nodes: List[Node], weights: Dict[str, dict],
        inputs: Dict[str, torch.Tensor], outputs: List[str],
        quant: Quant = None, hook=None) -> List[torch.Tensor]:
    """Run the graph on ``inputs`` and return the ``outputs`` blobs; blobs
    no later node needs are dropped as it goes."""
    last_use = {}
    for i, node in enumerate(nodes):
        for b in node.bottoms:
            last_use[b] = i
    blobs = {k: v if quant is None else quant(v) for k, v in inputs.items()}
    for i, node in enumerate(nodes):
        if node.type == "Input":
            continue
        xs = [blobs[b] for b in node.bottoms]
        ys = _node(node, xs, weights.get(node.name), quant)
        if quant is not None:
            ys = [quant(y) for y in ys]
        if hook is not None:
            hook(node, xs, ys)
        for top, y in zip(node.tops, ys):
            blobs[top] = y
        for b in node.bottoms:
            if last_use[b] == i and b not in outputs:
                blobs.pop(b, None)
    return [blobs[o] for o in outputs]


def tensors(weights, device) -> Dict[str, dict]:
    """``ncnn.read_bin``'s arrays as float32 tensors on ``device``."""
    out = {}
    for name, lw in weights.items():
        out[name] = {k: (None if v is None else
                         torch.as_tensor(v).to(device=device,
                                               dtype=torch.float32))
                     for k, v in (("weight", lw.weight), ("bias", lw.bias),
                                  ("slope", lw.slope))}
    return out
