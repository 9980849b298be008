"""Forward pipelines (port of ``rife_tpu/engine/pipelines.py``: ``forward_v4``
and ``forward_v1v2``, plain and with the ``-x``/``-z`` TTA modes and UHD
``-u``).

Spatial TTA (``-x``) runs the 8 dihedral views as two batch groups of 4B,
canonical (H,W) and transposed (W,H) (``frame.expand_views8``); temporal TTA
(``-z``) runs every net a second time on the swapped pair and merges flows
and renders (``frame.flow_temporal_avg_*``, ``frame.out_temporal_avg``).
Only the plain v4 branch asks the render for planes; the TTA renders come
out NCHW, as in the JAX package (``planar_out=False`` there).
"""

from __future__ import annotations

import torch

from ..ops import frame
from ..ops.torch_ops import resize2d

V4_TAPS = ("flow0", "flow1", "flow2", "flow3")
CONTEXT_FEATS = ("f1", "f2", "f3", "f4")


def _flatten(g: torch.Tensor) -> torch.Tensor:
    """(B,4,C,H,W) view group -> (4B,C,H,W)."""
    return g.reshape(-1, *g.shape[2:])


def _unflatten(x: torch.Tensor, b: int) -> torch.Tensor:
    return x.reshape(b, -1, *x.shape[1:])


# ---------------------------------------------------------------------------
# v4
# ---------------------------------------------------------------------------

def _v4_flow_pyramid(ex, weights, i0, i1, tplane, pinned):
    """Extract tap ``len(pinned)`` with the earlier taps pinned (the
    Executor stops at provided blobs, as ncnn's Extractor does)."""
    inputs = {"in0": i0, "in1": i1, "in2": tplane, **pinned}
    return ex.run(inputs, [V4_TAPS[len(pinned)]], {"w": weights})[0]


def _v4_out(ex, weights, i0, i1, tplane, pinned, planar_out=False):
    ctx = {"w": weights}
    if planar_out:
        ctx["planar_outputs"] = frozenset(("out0",))
    inputs = {"in0": i0, "in1": i1, "in2": tplane, **pinned}
    return ex.run(inputs, ["out0"], ctx)[0]


def forward_v4(ex, weights, in0_u8: torch.Tensor, in1_u8: torch.Tensor,
               timestep: torch.Tensor, pad_h: int, pad_w: int,
               dtype: torch.dtype, tta: bool = False,
               temporal: bool = False) -> torch.Tensor:
    """u8 frames (B,H,W,3) + per-item timestep (B,) -> u8 frame (B,H,W,3).

    Plain: with the fused render node (``ex.render_planar``) ``out0`` comes
    back as (B,H,3,W) planes and is finished by ``frame.postprocess_planar``.
    """
    h, w = in0_u8.shape[1], in0_u8.shape[2]
    b = in0_u8.shape[0]
    img0 = frame.preprocess(in0_u8, pad_h, pad_w, dtype)
    img1 = frame.preprocess(in1_u8, pad_h, pad_w, dtype)
    t = frame.timestep_plane(timestep, b, pad_h, pad_w, dtype)

    if not tta and not temporal:
        planar = getattr(ex, "render_planar", False)
        out = _v4_out(ex, weights, img0, img1, t, {}, planar_out=planar)
        if planar:
            return frame.postprocess_planar(out, h, w)
        return frame.postprocess(out, h, w)

    if not tta:
        # temporal only: tap by tap, forward and reverse, merging each level
        t_rev = frame.timestep_plane(1.0 - timestep, b, pad_h, pad_w, dtype)
        pinned, pinned_rev = {}, {}
        for tap in V4_TAPS:
            f = _v4_flow_pyramid(ex, weights, img0, img1, t, pinned)
            fr = _v4_flow_pyramid(ex, weights, img1, img0, t_rev, pinned_rev)
            pinned[tap], pinned_rev[tap] = frame.flow_temporal_avg_v4(f, fr)
        out = _v4_out(ex, weights, img0, img1, t, pinned)
        out_rev = _v4_out(ex, weights, img1, img0, t_rev, pinned_rev)
        return frame.postprocess(frame.out_temporal_avg(out, out_rev), h, w)

    # spatial TTA (with or without temporal): two view groups of 4B
    g0a, g0b = (_flatten(g) for g in frame.expand_views8(img0))
    g1a, g1b = (_flatten(g) for g in frame.expand_views8(img1))
    t4 = timestep.repeat_interleave(4)
    # the transposed group's plane is (pad_w, pad_h)
    groups = [(g0a, g1a, frame.timestep_plane(t4, 4 * b, pad_h, pad_w, dtype)),
              (g0b, g1b, frame.timestep_plane(t4, 4 * b, pad_w, pad_h, dtype))]
    rev_groups = [
        (g1a, g0a, frame.timestep_plane(1.0 - t4, 4 * b, pad_h, pad_w, dtype)),
        (g1b, g0b, frame.timestep_plane(1.0 - t4, 4 * b, pad_w, pad_h, dtype)),
    ] if temporal else []
    pins, pins_rev = [{}, {}], [{}, {}]

    def taps(runs, pinned):
        return [_unflatten(_v4_flow_pyramid(ex, weights, *run, p), b)
                for run, p in zip(runs, pinned)]

    def pin(pinned, tap, fa, fb):
        for p, f in zip(pinned, frame.flow_views_avg(fa, fb, n_pairs=2,
                                                     has_mask=True)):
            p[tap] = _flatten(f)

    for tap in V4_TAPS:
        fa, fb = taps(groups, pins)
        if temporal:
            fra, frb = taps(rev_groups, pins_rev)
            fa, fra = frame.flow_temporal_avg_v4(fa, fra)
            fb, frb = frame.flow_temporal_avg_v4(fb, frb)
            pin(pins_rev, tap, fra, frb)
        pin(pins, tap, fa, fb)

    outs = [_v4_out(ex, weights, *run, p) for run, p in zip(groups, pins)]
    if temporal:
        outs = [frame.out_temporal_avg(o, _v4_out(ex, weights, *run, p))
                for o, run, p in zip(outs, rev_groups, pins_rev)]
    merged = frame.merge_views8_mean(*(_unflatten(o, b) for o in outs))
    return frame.postprocess(merged, h, w)


# ---------------------------------------------------------------------------
# v1 / v2
# ---------------------------------------------------------------------------

def _v1v2_render(run, family, img0, img1, flow, flow_rev):
    """Contextnet + fusionnet on one geometry (``_v1v2_render``).  v2: both
    context extractions ride one batched contextnet run over
    ``cat([img0, img1])`` (same input slot ``flow.0``, the flow's halves).
    v1: two runs, frame 0 feeding the whole flow as ``flow.0`` and frame 1
    as ``flow.1`` (which the graph negates); they take different input
    slots, and a frame's bf16 bytes depend on the B of its run, so they
    are not batched.  The fusionnet takes the frames, the flow and the
    features as inputs ``"3".."10"`` (frame 0's f1..f4, then frame 1's).
    With a reverse flow (``-z``) the fusionnet also runs on the swapped pair
    and the two renders are averaged."""
    feat_names = list(CONTEXT_FEATS)
    if family == "v2":
        b = img0.shape[0]
        feats = run("contextnet", {
            "input.1": torch.cat([img0, img1]),
            "flow.0": torch.cat([flow[:, 0:2], flow[:, 2:4]]),
        }, feat_names)
        ctx0, ctx1 = [f[:b] for f in feats], [f[b:] for f in feats]
    else:
        ctx0 = run("contextnet", {"input.1": img0, "flow.0": flow},
                   feat_names)
        ctx1 = run("contextnet", {"input.1": img1, "flow.1": flow},
                   feat_names)

    def fusion(i0, i1, fl, c0, c1):
        inputs = {"img0": i0, "img1": i1, "flow": fl}
        for i, f in enumerate(list(c0) + list(c1)):
            inputs[str(3 + i)] = f
        return run("fusionnet", inputs, ["output"])[0]

    out = fusion(img0, img1, flow, ctx0, ctx1)
    if flow_rev is not None:
        out = frame.out_temporal_avg(
            out, fusion(img1, img0, flow_rev, ctx1, ctx0))
    return out


def forward_v1v2(nets, weights, family: str, in0_u8: torch.Tensor,
                 in1_u8: torch.Tensor, pad_h: int, pad_w: int,
                 dtype: torch.dtype, tta: bool = False,
                 temporal: bool = False, uhd: bool = False) -> torch.Tensor:
    """u8 frames (B,H,W,3) -> the u8 midpoint frame (B,H,W,3), v1 or v2
    family (``family``).

    ``flownet`` gives the flow at half resolution, (B,4,H/2,W/2) for v2 and
    (B,2,H/2,W/2) for v1; with ``-z`` it also runs on the swapped pair and
    ``flow_temporal_avg_v2`` / ``_v1`` merges the two; with ``-x`` each view
    group runs as a batch of 4B and ``flow_views_avg`` (2 flow pairs for v2,
    1 for v1) merges the 8 views' flows before the render.  With ``-u``
    every flownet run takes the frames halved by ``resize2d`` and its ctx
    sets ``no_u8_warp`` (the resized frames are not u8-valued); its flow is
    resized x2 and then scaled by 2 in its own dtype (``_run_flownet``).
    The contextnet and fusionnet run as without ``-u``."""
    h, w = in0_u8.shape[1], in0_u8.shape[2]
    b = in0_u8.shape[0]
    img0 = frame.preprocess(in0_u8, pad_h, pad_w, dtype)
    img1 = frame.preprocess(in1_u8, pad_h, pad_w, dtype)
    v2 = family == "v2"

    def run(net, inputs, outputs, **ctx):
        return nets[net].run(inputs, outputs, {"w": weights[net], **ctx})

    def flownet(i0, i1):
        if not uhd:
            return run("flownet", {"input0": i0, "input1": i1}, ["flow"])[0]
        hh, hw = i0.shape[2] // 2, i0.shape[3] // 2
        flow = run("flownet", {"input0": resize2d(i0, hh, hw),
                               "input1": resize2d(i1, hh, hw)}, ["flow"],
                   no_u8_warp=True)[0]
        flow = resize2d(flow, flow.shape[2] * 2, flow.shape[3] * 2)
        return flow * 2.0  # exact in every float dtype, as a tensor's 2.0

    merge = frame.flow_temporal_avg_v2 if v2 else frame.flow_temporal_avg_v1

    def flows(i0, i1):
        flow = flownet(i0, i1)
        if not temporal:
            return flow, None
        return merge(flow, flownet(i1, i0))

    if not tta:
        out = _v1v2_render(run, family, img0, img1, *flows(img0, img1))
        return frame.postprocess(out, h, w)

    g0a, g0b = (_flatten(g) for g in frame.expand_views8(img0))
    g1a, g1b = (_flatten(g) for g in frame.expand_views8(img1))
    groups = [(g0a, g1a), (g0b, g1b)]
    per_group = [flows(i0, i1) for i0, i1 in groups]

    def views_avg(k):
        """Consensus of flow k (0 forward, 1 reverse) over both groups."""
        fa, fb = frame.flow_views_avg(
            *(_unflatten(f[k], b) for f in per_group),
            n_pairs=2 if v2 else 1, has_mask=False)
        return _flatten(fa), _flatten(fb)

    fwd = views_avg(0)
    rev = views_avg(1) if temporal else (None, None)
    outs = [_unflatten(_v1v2_render(run, family, i0, i1, f, fr), b)
            for (i0, i1), f, fr in zip(groups, fwd, rev)]
    return frame.postprocess(frame.merge_views8_mean(*outs), h, w)
