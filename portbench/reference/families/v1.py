"""The v1 family (``rife``, ``rife-anime``; hzwer/arXiv2020-RIFE v1,
``RIFE.predict``; three nets, the midpoint only):

1. the flownet on ``input0``, ``input1``: ``flow``, one 2-channel flow at
   half resolution;
2. the contextnet on frame 0 (``input.1``) with that flow as ``flow.0``;
3. the contextnet on frame 1 with the same flow as ``flow.1``, which the
   graph negates into ``flow.0`` (``contextnet(img1, -flow)``);
4. the fusionnet on the frames, the flow and the features as inputs
   ``"3".."10"`` (frame 0's f1..f4, then frame 1's): ``output``.

The tap is the flow.
"""

from __future__ import annotations

from . import Tap

TAP = Tap("flow", 2)
FEATURES = ["f1", "f2", "f3", "f4"]


def flownet_inputs(i0, i1):
    return {"input0": i0, "input1": i1}


def pair(run, i0, i1, t: float):
    if t != 0.5:
        raise ValueError("the v1 family interpolates the midpoint")
    flow, = run("flownet", flownet_inputs(i0, i1), [TAP.blob])
    c0 = run("contextnet", {"input.1": i0, "flow.0": flow}, FEATURES)
    c1 = run("contextnet", {"input.1": i1, "flow.1": flow}, FEATURES)
    inputs = {"img0": i0, "img1": i1, "flow": flow}
    for k, f in enumerate(c0 + c1):
        inputs[str(3 + k)] = f
    out, = run("fusionnet", inputs, ["output"])
    return out, flow


def net_inputs(cfg: dict, net: str, b: int, hp: int, wp: int):
    half = (hp // 2, wp // 2)
    if net == "flownet":
        return {"input0": (b, 3, hp, wp), "input1": (b, 3, hp, wp)}
    if net == "contextnet":  # once a frame; frame 1's run negates its flow
        return {"input.1": (2 * b, 3, hp, wp), "flow.1": (2 * b, 2, *half)}
    c = cfg["widths"][3]
    ctx = {}
    for k, (ch, div) in enumerate(((c, 2), (2 * c, 4), (4 * c, 8),
                                   (8 * c, 16))):
        for side in (0, 4):
            ctx[str(3 + k + side)] = (b, ch, hp // div, wp // div)
    return {"img0": (b, 3, hp, wp), "img1": (b, 3, hp, wp),
            "flow": (b, 2, *half), **ctx}
