"""Synthetic weights drawn from the run's seed, calibrated, written as
ncnn ``.bin``.

The construction starts from the program's "mix" synthesis
(``graph/weights.py`` ``synthesize_weights``) and weights every tap, so
that the check sees each tap of every convolution:

* a convolution's taps are a random channel mix, normal with std
  sqrt(2 / in) x the net's scale, times a kxk envelope of its own drawn
  from the seed: every tap uniform in [ENV_LOW, 1), normalised to sum 1
  (on a smooth input the gain of the program's centre delta), asymmetric,
  so a kernel flipped, transposed or shifted by a tap, a halo read wrong
  or a tap left out changes the answer;
* a deconvolution's taps are such a mix times a 4x4 envelope drawn the
  same way (it replaces the program's symmetric binomial stencil, which a
  flipped kernel leaves unchanged), its output channels tied in groups of
  4;
* biases 0, PReLU slopes 0.25.

The mixes and envelopes are drawn on the run's device by one
``torch.Generator`` in two calls a net.  Gain compounds through the
unnormalised trunks, so one draw's flow can be ten times another's at the
same scale.  So the flownet's scale is calibrated a draw, as the program's
``models/calibrate.py`` calibrates it: a geometric bisection of one
multiplier on every flownet weight, on the reference's float32 flownet at
half the cell's frame size (on the run's first pair), until the flow tap's
std is ``calibrate.target_std_px`` (the program's realistic 6 px); the run
keeps the search's seconds out of its set-up time, as it keeps the check
out.  The other nets keep the configuration's scale.  The weights are then
rounded to fp16 (the zoo's weight format) and written once; the program
loads the file through its ``.bin`` reader, as it loads real weights, and
the reference reads the same file.
"""

from __future__ import annotations

import importlib
import math
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import ncnn
from .seeds import derive

SEARCH_STEPS = 14
SEARCH_SPAN = 4.0  # the bracket: the configuration's scale / 4 .. x 4
ENV_LOW = 0.25  # the least tap of an envelope before normalising


def envelope(u: torch.Tensor) -> torch.Tensor:
    """A kxk tap envelope from uniform [0, 1) draws ``u``: every tap in
    [ENV_LOW, 1), normalised to sum 1 (the centre delta's gain on a smooth
    input)."""
    e = ENV_LOW + (1.0 - ENV_LOW) * u
    return e / e.sum()


def draw(nodes, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every conv / deconv weight of the net at scale 1, float32 on
    ``device``, in its stored layout."""
    convs = [n for n in nodes if n.type in ("Convolution", "Deconvolution")]
    shapes = [ncnn.conv_shape(n) for n in convs]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draws = torch.randn(sum(o * i for o, i, _ in shapes), generator=gen,
                        device=device)
    taps = torch.rand(sum(k * k for _, _, k in shapes), generator=gen,
                      device=device)
    out, offset, toff = {}, 0, 0
    for node, (o, i, k) in zip(convs, shapes):
        mix = draws[offset:offset + o * i].view(o, i) * math.sqrt(2.0 / i)
        offset += o * i
        env = envelope(taps[toff:toff + k * k].view(k, k))
        toff += k * k
        if node.type == "Convolution":
            out[node.name] = mix[:, :, None, None] * env
        else:
            if o % 4 == 0:
                mix = mix[::4].repeat_interleave(4, dim=0)
            out[node.name] = (mix[:, :, None, None] * env).transpose(0, 1)
    return out


def layer_weights(nodes, drawn, scale: float) -> Dict[str, ncnn.LayerWeights]:
    """The drawn weights times ``scale``, fp16-rounded, as host arrays,
    with the biases and slopes."""
    names = [n.name for n in nodes if n.name in drawn]
    flat = torch.cat([(drawn[n] * scale).to(torch.float16).reshape(-1)
                      for n in names]).cpu().numpy().astype(np.float32) \
        if names else np.zeros(0, np.float32)
    out, offset = {}, 0
    for node in nodes:
        shape = ncnn.weight_shape(node)
        if shape is not None:
            size = int(np.prod(shape))
            bias = (np.zeros(ncnn.conv_shape(node)[0], np.float32)
                    if int(node.p(5)) == 1 else None)
            out[node.name] = ncnn.LayerWeights(
                weight=flat[offset:offset + size].reshape(shape), bias=bias)
            offset += size
        elif node.type == "PReLU":
            out[node.name] = ncnn.LayerWeights(
                slope=np.full(int(node.p(0)), 0.25, np.float32))
    return out


def calibration_inputs(family: str, pair: torch.Tensor):
    """The flownet's inputs for (2,H,W,3) u8 frames: float32 in [0, 1],
    padded to 32, halved where the halved frame still covers the net."""
    x = pair.permute(0, 3, 1, 2).float() / 255.0
    h, w = x.shape[2:]
    x = F.pad(x, (0, -w % 32, 0, -h % 32))
    if x.shape[2] % 128 == 0 and x.shape[3] % 128 == 0:
        x = F.avg_pool2d(x, 2)
    i0, i1 = x[:1], x[1:2]
    if family == "v4":
        return {"in0": i0, "in1": i1,
                "in2": torch.full_like(i0[:, :1], 0.5)}, "flow3"
    return {"input0": i0, "input1": i1}, "flow"


def flow_tap(nodes, drawn, scale: float, inputs, tap: str,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The flow tap's 4 flow channels, float32, with every weight times
    ``scale`` (the reference's graph in ``dtype``, TF32 off)."""
    from .reference import graph
    from .reference.rife import no_tf32

    dev = next(iter(inputs.values())).device
    w = {}
    for n in nodes:
        if n.name in drawn:
            o = ncnn.conv_shape(n)[0]
            w[n.name] = {"weight": (drawn[n.name] * scale).to(dtype),
                         "slope": None,
                         "bias": (torch.zeros(o, device=dev, dtype=dtype)
                                  if int(n.p(5)) == 1 else None)}
        elif n.type == "PReLU":
            w[n.name] = {"weight": None, "bias": None,
                         "slope": torch.full((int(n.p(0)),), 0.25,
                                             device=dev, dtype=dtype)}
    with no_tf32(), torch.no_grad():
        flow, = graph.run(nodes, w, {k: v.to(dtype) for k, v in
                                     inputs.items()}, [tap])
    return flow[:, :4].float()


def flow_std_at(nodes, drawn, scale: float, inputs, tap: str) -> float:
    """The std of the flow tap's 4 flow channels with every weight times
    ``scale`` (the reference's float32 graph, TF32 off)."""
    return float(flow_tap(nodes, drawn, scale, inputs, tap).std())


def bf16_flow_error(nodes, drawn, scale: float, inputs, tap: str) -> float:
    """How far rounding the reference's flownet to bfloat16 moves the flow
    tap: mean |bf16 tap - float32 tap| over the float32 tap's std."""
    ref = flow_tap(nodes, drawn, scale, inputs, tap)
    low = flow_tap(nodes, drawn, scale, inputs, tap, torch.bfloat16)
    return float((low - ref).abs().mean() / ref.std())


def calibrate(nodes, drawn, scale: float, target: float, inputs,
              tap: str) -> Tuple[float, float]:
    """(the multiplier whose flow std is ``target``, that std): geometric
    bisection of [scale / SPAN, scale * SPAN] on the flownet's ``inputs``
    (``calibration_inputs``)."""
    lo, hi = scale / SEARCH_SPAN, scale * SEARCH_SPAN
    for _ in range(SEARCH_STEPS):
        mid = math.sqrt(lo * hi)
        if flow_std_at(nodes, drawn, mid, inputs, tap) > target:
            hi = mid
        else:
            lo = mid
    found = math.sqrt(lo * hi)
    return found, flow_std_at(nodes, drawn, found, inputs, tap)


def calibrated_draw(nodes, cfg: dict, net: str, seed: int, device,
                    pair: torch.Tensor) -> Tuple[Dict[str, torch.Tensor],
                                                 dict]:
    """The calibrated net's weights: a draw from ``seed`` at the multiplier
    of ``calibrate``.  Where the configuration sets ``max_bf16_flow_err``,
    a draw whose flow that error exceeds is drawn again from the next
    sub-seed, up to ``draws`` times (the draw with the least error is kept
    if none passes).  Returns (the draw, what the search found)."""
    cal = cfg["calibrate"]
    inputs, tap = calibration_inputs(cfg["family"], pair.to(device))
    limit = cal.get("max_bf16_flow_err")
    best = None
    for k in range(int(cal.get("draws", 1))):
        key = f"weights:{cfg['name']}:{net}" + (f":{k}" if k else "")
        drawn = draw(nodes, derive(seed, key), device)
        scale, std = calibrate(nodes, drawn,
                               float(cfg["weight_scale"].get(net, 1.0)),
                               float(cal["target_std_px"]), inputs, tap)
        err = (bf16_flow_error(nodes, drawn, scale, inputs, tap)
               if limit is not None else None)
        found = {"flow_std_px": std, net: scale, "draw": k}
        if err is not None:
            found["bf16_flow_err"] = err
        if best is None or (err is not None
                            and err < best[1]["bf16_flow_err"]):
            best = (drawn, found)
        if limit is None or err <= float(limit):
            break
    return best


def write_model(cfg: dict, root: Path, seed: int, device,
                pair: Optional[torch.Tensor] = None) -> Tuple[Path, dict]:
    """Write the configuration's graphs with its writer and each net's
    weights from ``seed`` (the calibrated net's scale searched on ``pair``,
    (2,H,W,3) u8, where given); returns (the model directory, the scale of
    each net, what the search found and its seconds)."""
    writer = importlib.import_module(cfg["writer"])
    model_dir = Path(getattr(writer, cfg["write"])(root, tuple(cfg["widths"])))
    info = {}
    for net in cfg["nets"]:
        nodes = ncnn.parse_param(model_dir / f"{net}.param")
        if pair is not None and cfg.get("calibrate", {}).get("net") == net:
            t0 = time.perf_counter()
            drawn, found = calibrated_draw(nodes, cfg, net, seed, device,
                                           pair)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            info.update(found, calibration_s=time.perf_counter() - t0)
        else:
            drawn = draw(nodes, derive(seed, f"weights:{cfg['name']}:{net}"),
                         device)
            info[net] = float(cfg["weight_scale"].get(net, 1.0))
        path = model_dir / f"{net}.bin"
        tmp = path.with_suffix(".bin.tmp")
        tmp.write_bytes(ncnn.bin_bytes(nodes, layer_weights(nodes, drawn,
                                                            info[net])))
        tmp.replace(path)
    return model_dir, info
