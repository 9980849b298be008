"""The v2 family (three nets, the midpoint only): the flownet's
half-resolution flow (4 channels: frame 0's flow, then frame 1's), the
contextnet once a frame with that frame's flow as ``flow.0``, and the
fusionnet on the frames, the flow and the features as inputs ``"3".."10"``
(frame 0's f1..f4, then frame 1's).  The tap is that flow."""

from __future__ import annotations

from . import Tap

TAP = Tap("flow", 4)
FEATURES = ["f1", "f2", "f3", "f4"]


def flownet_inputs(i0, i1):
    return {"input0": i0, "input1": i1}


def pair(run, i0, i1, t: float):
    if t != 0.5:
        raise ValueError("the v2 family interpolates the midpoint")
    flow, = run("flownet", flownet_inputs(i0, i1), [TAP.blob])
    c0 = run("contextnet", {"input.1": i0, "flow.0": flow[:, 0:2]}, FEATURES)
    c1 = run("contextnet", {"input.1": i1, "flow.0": flow[:, 2:4]}, FEATURES)
    inputs = {"img0": i0, "img1": i1, "flow": flow}
    for k, f in enumerate(c0 + c1):
        inputs[str(3 + k)] = f
    out, = run("fusionnet", inputs, ["output"])
    return out, flow


def net_inputs(cfg: dict, net: str, b: int, hp: int, wp: int):
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
