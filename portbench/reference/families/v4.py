"""The v4 family (one net): ``out0`` of the flownet on ``in0``, ``in1`` and
the constant timestep plane ``in2``.  The tap is ``flow3``, the last
block's flow (its first 4 channels)."""

from __future__ import annotations

import torch

from . import Tap

TAP = Tap("flow3", 4)


def flownet_inputs(i0: torch.Tensor, i1: torch.Tensor, t: float = 0.5):
    return {"in0": i0, "in1": i1,
            "in2": torch.full_like(i0[:, :1], float(t))}


def pair(run, i0, i1, t: float):
    out, flow = run("flownet", flownet_inputs(i0, i1, t), ["out0", TAP.blob])
    return out, flow[:, :TAP.channels]


def net_inputs(cfg: dict, net: str, b: int, hp: int, wp: int):
    return {"in0": (b, 3, hp, wp), "in1": (b, 3, hp, wp),
            "in2": (b, 1, hp, wp)}
