"""Calibration of synthetic-weight scales (dev tool; port of
``rife_tpu/models/calibrate.py``).

Models without ``.bin`` weights run on synthetic ones.  Per-layer gain
compounds through ~20 unnormalized layers, so an uncalibrated forward either
collapses to ~0 or explodes to unphysical ~1e4 px "flows"; ``calibrate``
bisects a single global multiplier on the flownet's conv/deconv/dense
weights so the final flow std lands at a realistic ~6 px, and
``calibrate_fusionnet`` sweeps the fusionnet's multiplier so the u8 output
std is image-like.  The results are the tables
``graph.weights.SYNTHETIC_FLOWNET_SCALE`` / ``SYNTHETIC_FUSIONNET_SCALE``,
which this tool prints and never writes: they stay equal to the JAX
package's, against which the port's synthetic weights are held bit for bit.

Calibration runs at 544x960 — near the bench resolution, because gain is
mildly input-smoothness-dependent even in ``mix`` synthesis mode (inputs
are real frames, resized).  The frames are an argument: (1,H,W,3) float32
in [0, 1].  Each evaluation prepares the scaled weights once and runs one
f32 forward on ``device`` ("cuda" by default; "cpu" only when asked), with
TF32 off for cuDNN and matmuls while it runs.

A model is named as ``load_model`` takes it (a dir, or a name under the
zoo root); its synthetic weights are tagged, and its baked scale looked up,
by the resolved dir's name, as ``load_model`` tags them.  That equals the
JAX package's ``_make_eval`` given the zoo name.

Run:  python -m rife_tpu_torch.models.calibrate [all|flownet|fusionnet]
          --frames A.png B.png [model dir ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..engine.session import RIFE
from ..graph.executor import Executor
from ..graph.weights import (SYNTHETIC_FUSIONNET_SCALE, _weight_scale_for,
                             synthesize_weights)
from ..ops import torch_ops
from ..ops.conv import full_f32
from .zoo import MODEL_NAMES, load_model

TARGET_FLOW_STD = 6.0
TEST_HW = (544, 960)
TARGET_OUT_STD = 60.0  # image-like u8 output contrast

SEARCH_RANGE = (0.05, 1.5)  # the flownet bisection's bracket
SEARCH_STEPS = 12

Frames = Tuple[np.ndarray, np.ndarray]


def load_frames(path0: str, path1: str, hw: Tuple[int, int]) -> Frames:
    """Two images as (1,H,W,3) float32 in [0, 1], resized to ``hw`` with
    PIL bilinear; a missing file raises ``FileNotFoundError``."""
    from PIL import Image

    h, w = hw

    def load(path):
        with Image.open(path) as im:
            return (np.asarray(im.convert("RGB").resize((w, h),
                                                        Image.BILINEAR),
                               np.float32) / 255.0)

    return load(path0)[None], load(path1)[None]


def _scaled(raw, s: float):
    """Layer weights with every conv/deconv/dense weight times ``s``
    (biases and slopes untouched)."""
    return {k: lw if lw.weight is None
            else dataclasses.replace(lw, weight=lw.weight * s)
            for k, lw in raw.items()}


def _nchw(frame: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(frame, np.float32)).permute(
        0, 3, 1, 2).contiguous().to(device)


def make_flownet_tap(model: str, frames: Frames, device="cuda",
                     model_root=None) -> Callable[[float], torch.Tensor]:
    """(flow_at: scale -> the flow tap, NCHW on ``device``) for the model's
    raw flownet: the un-rewritten graph on ``torch_ops.OP_TABLE`` with an
    empty ctx, in f32, its synthetic weights at the absolute multiplier
    ``scale`` (the baked scale divided out); the tap is ``flow3`` (v4) or
    ``flow`` (v1/v2), the v4 timestep a 0.5 plane."""
    dev = resolve_device(device)
    m = load_model(model, model_root)
    net = m.nets["flownet"]
    tag = f"{m.name}/flownet"
    base = synthesize_weights(net.graph, tag)
    # neutralize the baked global scale so flow_at(s) measures the
    # ABSOLUTE multiplier one would bake, not a delta on top of it
    baked = _weight_scale_for(tag)
    ex = Executor(net.graph, torch_ops.OP_TABLE, base, ctx={})
    i0, i1 = (_nchw(f, dev) for f in frames)
    if m.family == "v4":
        tap = "flow3"
        inputs = {"in0": i0, "in1": i1,
                  "in2": torch.full((1, 1, *i0.shape[2:]), 0.5, device=dev)}
    else:
        tap = "flow"
        inputs = {"input0": i0, "input1": i1}

    def flow_at(scale: float) -> torch.Tensor:
        prep = torch_ops.prepare_weights(
            net.graph, _scaled(base, scale / baked), torch.float32, dev)
        with full_f32(), torch.inference_mode():
            return ex.run(inputs, [tap], {"w": prep})[0]

    return flow_at


def flow_std(flow: torch.Tensor) -> float:
    """The std of a flow tap's first 4 channels, taken in NHWC order as the
    JAX package takes it."""
    flow = flow[:, :4].permute(0, 2, 3, 1).cpu().numpy()
    return float(np.ascontiguousarray(flow, np.float32).std())


def make_flownet_eval(model: str, frames: Frames, device="cuda",
                      model_root=None) -> Callable[[float], float]:
    """(eval_scale: scale -> flow std) for the model's raw flownet: the
    ``flow_std`` of ``make_flownet_tap``'s tap."""
    flow_at = make_flownet_tap(model, frames, device, model_root)
    return lambda scale: flow_std(flow_at(scale))


def search_flownet_scale(eval_scale: Callable[[float], float]):
    """Geometric bisection of ``SEARCH_RANGE`` for the scale whose flow std
    is ``TARGET_FLOW_STD``: (scale rounded to 4 places, its std)."""
    lo, hi = SEARCH_RANGE
    for _ in range(SEARCH_STEPS):
        mid = (lo * hi) ** 0.5
        std = eval_scale(mid)
        if std > TARGET_FLOW_STD:
            hi = mid
        else:
            lo = mid
    final = round((lo * hi) ** 0.5, 4)
    return final, eval_scale(final)


def at_search_edge(scale: float) -> bool:
    """Whether a found scale lies within one final bisection interval of an
    end of ``SEARCH_RANGE`` (the target may lie outside the bracket)."""
    lo, hi = SEARCH_RANGE
    width = math.log(hi / lo) / 2 ** SEARCH_STEPS
    return (math.log(scale / lo) <= width or math.log(hi / scale) <= width)


def calibrate(model: str, frames: Frames, device="cuda", model_root=None):
    """(flownet scale, its flow std) for ``model``."""
    return search_flownet_scale(
        make_flownet_eval(model, frames, device, model_root))


def make_fusionnet_step(model: str, frames: Frames, device="cuda",
                        model_root=None):
    """(step: s -> the u8 output frame on ``device``, the baked fusionnet
    scale) for one f32 session step with the rewritten fusionnet's conv,
    deconv and InnerProduct weights times ``s`` on top of the baked scale;
    (None, None) for the v4 family (no fusionnet)."""
    session = RIFE(model, device=device, dtype=torch.float32,
                   model_root=model_root)
    if session.model.family == "v4":
        return None, None
    i0, i1 = frames
    a = torch.from_numpy((i0 * 255).astype(np.uint8)).to(session.device)
    b = torch.from_numpy((i1 * 255).astype(np.uint8)).to(session.device)
    ts = np.full((1,), 0.5, np.float32)
    fusion = session.executors["fusionnet"]

    def step(s: float) -> torch.Tensor:
        # re-prepared from the raw weights: ``_entry`` derives several
        # tensors a layer, so scaling prepared entries could miss one
        weights = {**session.weights, "fusionnet": torch_ops.prepare_weights(
            fusion.graph, _scaled(fusion.raw_weights, s), torch.float32,
            session.device)}
        with full_f32():
            return session.forward(a, b, ts, session.executors, weights)

    return step, SYNTHETIC_FUSIONNET_SCALE.get(session.model.name, 1.0)


def make_fusionnet_eval(model: str, frames: Frames, device="cuda",
                        model_root=None):
    """(eval_scale: s -> u8 output std, the baked fusionnet scale) over
    ``make_fusionnet_step``; (None, None) for the v4 family."""
    step, baked = make_fusionnet_step(model, frames, device, model_root)
    if step is None:
        return None, None
    return (lambda s: float(step(s).cpu().numpy().std())), baked


def search_fusionnet_scale(eval_scale: Callable[[float], float]):
    """(multiplier, its output std) nearest ``TARGET_OUT_STD``: the response
    is NON-monotone (a tiny scale collapses to the black clip(residual-1)
    frame, a huge one saturates to a constant frame, std~0 both), so sweep
    a log grid and refine around the best point."""

    def sweep(points):
        best_s, best_err, best_std = None, float("inf"), 0.0
        for s in points:
            std = eval_scale(float(s))
            err = abs(std - TARGET_OUT_STD)
            if err < best_err:
                best_s, best_err, best_std = float(s), err, std
        return best_s, best_std

    coarse, _ = sweep(np.geomspace(0.05, 32.0, 14))
    return sweep(np.geomspace(coarse / 1.6, coarse * 1.6, 7))


def calibrate_fusionnet(model: str, frames: Frames, device="cuda",
                        model_root=None):
    """(fusionnet scale, its u8 output std), or (None, None) for v4."""
    eval_scale, baked = make_fusionnet_eval(model, frames, device, model_root)
    if eval_scale is None:
        return None, None
    fine, std = search_fusionnet_scale(eval_scale)
    # the session's weights already hold the baked scale: the searched
    # value is a multiplier on top of it
    return round(baked * fine, 4), std


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rife_tpu_torch.models.calibrate",
        description="Search the synthetic-weight scales and print the "
                    "tables found (nothing is written).")
    p.add_argument("targets", nargs="*", metavar="[all|flownet|fusionnet] "
                   "[model ...]", help="what to calibrate (default all), "
                   "then model dirs (default: the zoo's names under "
                   "./models)")
    p.add_argument("--frames", nargs=2, required=True, metavar=("A", "B"),
                   help="two frames, resized to TEST_HW")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    which, models = "all", args.targets
    if models and models[0] in ("all", "flownet", "fusionnet"):
        which, models = models[0], models[1:]
    models = models or MODEL_NAMES
    frames = load_frames(*args.frames, TEST_HW)
    if which in ("all", "flownet"):
        results = {}
        for name in models:
            scale, std = calibrate(name, frames, args.device)
            results[Path(name).name] = scale
            print(f"{name}: scale={scale} -> flow std {std:.1f}px", flush=True)
        print("\nSYNTHETIC_FLOWNET_SCALE =", results)
    if which in ("all", "fusionnet"):
        results = {}
        for name in models:
            scale, std = calibrate_fusionnet(name, frames, args.device)
            if scale is None:
                continue
            results[Path(name).name] = scale
            print(f"{name}: fusion scale={scale} -> out std {std:.1f}",
                  flush=True)
        print("\nSYNTHETIC_FUSIONNET_SCALE =", results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
