"""Which kernels one step of a session launches, worked out from its
rewritten graphs, the blob shapes and the site gates, without running it.

``kernel_sites(session, h, w)`` walks each net's rewritten graph as the
pipeline feeds it (``engine/pipelines.py``: every run of the session's TTA
schedule, in both view geometries), propagating (C, H, W) shapes through
every layer kind the port runs, and applies the dispatch rules of
``ops/torch_ops.py``: the pair kernels for paired u8-origin warps, K3 for a
``rife.WarpDs2`` of a frame copy, the single-warp kernel in its u8 or float
mode for the rest (float only in a run whose ctx sets ``no_u8_warp``: the UHD
flownet, walked at its halved geometry), ``conv3x3`` where the gates of
``ops/conv.py`` take a conv site, ``conv3x3_ps`` where they take a
``rife.ConvPS`` site (on its pre-shuffle channels), and for a deconv site
its route (``ops/conv.py`` ``deconv_route``, for the session's device and
dtype): ``deconv4x4`` wherever the deconv kernel runs (bf16 on the card:
the planar sites and every other 4x4 stride-2 one), else, at a planar
site, the ``conv3x3`` (``conv3x3_ps`` for a DeconvPS) that runs its phase
conv.  Every other conv and deconv site runs on the library; on the card
(``epilogue_on_kernel``) each that has a bias or an activation the kernel
takes launches ``bias_act`` once.
Rank-2 blobs (the v1 SE gates: global ``Pooling``, ``InnerProduct``) have
shape (C,).  The result, launches per kernel per step, does not depend on
the batch size.  ``n_spatial`` > 1 counts a step height-sharded over that
many shards (``graph/spatial.py``): each non-empty shard runs each net,
its warps all unfused into sharded warps (``warp_spatial``;
``ShardedRIFE.kernel_sites`` multiplies by the data shards).
``chip_smoke.py`` holds the card's launch counters to it, and times
``conv3x3`` / ``conv3x3_ps`` / ``deconv4x4`` at each site ``conv_sites``
lists.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import torch

from ..graph.spatial import shard_bounds
from ..ops import common as C
from ..ops import conv as CV
from .pipelines import CONTEXT_FEATS, V4_TAPS
from .session import pad_to

Shape = Tuple[int, ...]  # (C, H, W) of one batch item, (C,) for a vector


def _conv_out(node, h, w, transposed: bool):
    _, k, dilation, stride, pad, _ = C.conv_hyperparams(node)
    span = dilation * (k - 1)
    if transposed:
        return ((h - 1) * stride - 2 * pad + span + 1,
                (w - 1) * stride - 2 * pad + span + 1)
    return ((h + 2 * pad - span - 1) // stride + 1,
            (w + 2 * pad - span - 1) // stride + 1)


def _cut(shape: Shape, axis: int, start: int, end: int) -> Shape:
    dims = list(shape)
    end = min(end, dims[axis])
    dims[axis] = end - start
    return tuple(dims)


def _walk(ex, inputs: Dict[str, Shape], outputs, run_ctx=None,
          sharded=False, device="cpu", dtype=torch.float32):
    """(kernel launches, blob shapes, conv sites) of one run of ``ex`` with
    ``run_ctx`` over its ctx, as ``Executor.run`` merges them, in a session
    on ``device`` in ``dtype``; a conv site is (kernel, site), the site the
    kernel call's (part channels, cout, stride, activation code, input H, W,
    deconv): a deconv site's cout counts its four output phases, a
    PixelShuffle site's the channels before the shuffle; a ``deconv4x4``
    site is ((cin,), O, PixelShuffle factor, activation code, input H, W,
    XLA order).  ``sharded``: the launches of one shard of a height-sharded
    run, where no warp fuses (sharded warps, ``warp_spatial``)."""
    g, ctx = ex.graph, {**ex.ctx, **(run_ctx or {})}
    u8 = () if ctx.get("no_u8_warp") else ctx.get("u8_image_blobs", ())
    planar = ctx.get("planar_convs", False)
    shapes = dict(inputs)
    sites: Counter = Counter()
    convs: List[tuple] = []

    def single(blob, shape):
        if sharded:
            sites["warp_spatial"] += 1
            return
        sites["warp_u8" if shape[0] == 3 and blob in u8 else "warp_feat"] += 1

    def library(node):
        # a library conv site's epilogue (``torch_ops._library_site``)
        if CV.epilogue_on_kernel(device, C.activation_of(node)[0],
                                 C.conv_hyperparams(node)[5]):
            sites["bias_act"] += 1

    def pair_ok(node, a, b, fa, fb):
        return (not sharded and a == b and fa == fb and a[0] == 3
                and node.bottoms[0] in u8 and node.bottoms[2] in u8)

    for idx in g.required_nodes(outputs, list(inputs)):
        node = g.nodes[idx]
        # the Executor skips a node whose tops are all pinned
        if node.type == "Input" or all(t in inputs for t in node.tops):
            continue
        ins = [shapes[b] for b in node.bottoms]
        x = ins[0]
        kind = node.type
        if kind in ("Convolution", "ConvolutionCat", "rife.ConvPS"):
            cin = sum(s[0] for s in ins)
            cout = int(node.p(0))
            _, _, _, stride, _, _ = C.conv_hyperparams(node)
            act = CV.ACT_MAP.get(C.activation_of(node)[0])
            parts = [s[0] for s in ins]
            if len(parts) > CV.MAX_PARTS:
                parts[CV.MAX_PARTS - 1:] = [sum(parts[CV.MAX_PARTS - 1:])]
            name = "conv3x3_ps" if kind == "rife.ConvPS" else "conv3x3"
            if planar and kind == "ConvolutionCat" and \
                    CV.cat_conv_wants_planar(node, x[1], x[2], cin, cout,
                                             len(ins), ctx):
                convs.append((name, (tuple(parts), cout, stride, act, x[1],
                                     x[2], False)))
            elif planar and CV.conv_wants_planar(node, x[1], x[2], cin, cout,
                                                 ctx):
                convs.append((name, ((cin,), cout, stride, act, x[1], x[2],
                                     False)))
            else:
                library(node)
            oh, ow = _conv_out(node, x[1], x[2], False)
            if kind == "rife.ConvPS":
                r = int(node.p(25, 2))
                outs = [(cout // (r * r), r * oh, r * ow)]
            else:
                outs = [(cout, oh, ow)]
        elif kind in ("Deconvolution", "rife.DeconvPS"):
            cout = int(node.p(0))
            route = CV.deconv_route(node, x[1], x[2], x[0], cout, ctx, device,
                                    dtype)
            ps = 2 if kind == "rife.DeconvPS" and int(node.p(25, 2)) == 2 \
                else 1
            act = CV.ACT_MAP.get(C.activation_of(node)[0])
            if route != "library" and CV.deconv_on_kernel(device, dtype):
                convs.append(("deconv4x4", ((x[0],), cout, ps, act, x[1],
                                            x[2], route == "xla")))
            elif route == "planar":
                name = ("conv3x3_ps" if kind == "rife.DeconvPS"
                        else "conv3x3")
                convs.append((name, ((x[0],), 4 * cout, 1, act, x[1], x[2],
                                     True)))
            else:
                library(node)
            oh, ow = _conv_out(node, x[1], x[2], True)
            if kind == "rife.DeconvPS":
                outs = [(cout // 4, 2 * oh, 2 * ow)]
            else:
                outs = [(cout, oh, ow)]
        elif kind == "PixelShuffle":
            r = int(node.p(0, 1))
            outs = [(x[0] // (r * r), x[1] * r, x[2] * r)]
        elif kind == "Interp":
            _, oh, ow = C.interp_out_size(x[1], x[2], node)
            outs = [(x[0], oh, ow)]
        elif kind == "Concat":
            axis = int(node.p(0, 0))
            dims = list(x)
            dims[axis] = sum(s[axis] for s in ins)
            outs = [tuple(dims)]
        elif kind == "Crop":
            y = x
            for s, e, a in zip(node.p(-23309, []), node.p(-23310, []),
                               node.p(-23311, [])):
                y = _cut(y, int(a), int(s), int(e))
            outs = [y]
        elif kind == "Slice":
            axis = int(node.p(1, 0))
            sizes = C.slice_sizes(node, x[axis], len(node.tops))
            outs, off = [], 0
            for n in sizes:
                outs.append(_cut(x, axis, off, off + int(n)))
                off += int(n)
        elif kind == "Split":
            outs = [x] * len(node.tops)
        elif kind == "BinaryOp":
            # a (C,) vector broadcasts into a (C, H, W) map
            big = max(ins, key=len)
            outs = [tuple(max(s[k] for s in ins if len(s) == len(big))
                          for k in range(len(big)))]
        elif kind == "Pooling":
            outs = [(x[0],)]
        elif kind == "InnerProduct":
            outs = [(int(node.p(0)),)]
        elif kind in ("Eltwise", "Sigmoid", "Clip", "PReLU", "ReLU",
                      "UnaryOp"):
            outs = [x]
        elif kind == "rife.Warp":
            single(node.bottoms[0], x)
            outs = [x]
        elif kind == "rife.WarpDs4":
            single(node.bottoms[0], x)
            outs = [(x[0], x[1] // 4, x[2] // 4)]
        elif kind == "rife.WarpDs2":
            if (not sharded and x[0] == 3 and node.bottoms[0] in u8
                    and not (x[1] % 2 or x[2] % 2)):
                sites["warp_ds2"] += 1
            else:
                single(node.bottoms[0], x)
            outs = [(x[0], round(x[1] * 0.5), round(x[2] * 0.5))]
        elif kind in ("rife.WarpPair", "rife.WarpDs4Pair"):
            a, fa, b, fb = ins
            ds4 = kind == "rife.WarpDs4Pair"
            if pair_ok(node, a, b, fa, fb) and not (
                    ds4 and (a[1] % 4 or a[2] % 4)):
                sites["warp_ds4_pair" if ds4 else "warp_pair"] += 1
            else:
                single(node.bottoms[0], a)
                single(node.bottoms[2], b)
            outs = [(s[0], s[1] // 4, s[2] // 4) if ds4 else s
                    for s in (a, b)]
        elif kind == "rife.RenderBlend":
            a, fa, b, fb, _ = ins
            if pair_ok(node, a, b, fa, fb):
                sites["warp_render"] += 1
            else:
                single(node.bottoms[0], a)
                single(node.bottoms[2], b)
            outs = [a]
        else:
            raise NotImplementedError(f"layer type {kind!r}")
        for top, shape in zip(node.tops, outs):
            shapes[top] = shape
    sites.update(name for name, _ in convs)
    return sites, shapes, convs


def _plan(session, h: int, w: int, n_spatial: int = 1):
    """(launches per kernel, [(batch factor, site), ...] of ``conv3x3``,
    the same of ``conv3x3_ps``, the same of ``deconv4x4``) of one step.
    The batch factor is the run's batch over the session's: 4 for a
    spatial-TTA view group, for v2 twice
    that for the contextnet, which runs on both frames at once (v1 runs it
    once per frame, fed ``flow.0`` and ``flow.1``).  Spatial TTA runs each
    net once per view geometry, canonical and transposed; temporal TTA runs
    the flownet (v4: every tap and the render; v1/v2: the flownet and the
    fusionnet) once more, on the swapped pair.  UHD (v1/v2): the flownet
    runs on the frames halved, without u8-origin warps, and its flow comes
    back at the usual half resolution."""
    ph, pw = pad_to(h), pad_to(w)
    tta, temporal = session.tta_mode, session.tta_temporal_mode
    geoms = [(ph, pw), (pw, ph)] if tta else [(ph, pw)]
    views = 4 if tta else 1
    sweeps = 2 if temporal else 1
    ex = session.executors
    sites: Counter = Counter()
    convs: Dict[str, List[tuple]] = {"conv3x3": [], "conv3x3_ps": [],
                                     "deconv4x4": []}

    def walk(net, inputs, outputs, factor, runs=1, run_ctx=None):
        more, shapes, found = _walk(ex[net], inputs, outputs, run_ctx,
                                    sharded=n_spatial > 1,
                                    device=session.device,
                                    dtype=session.dtype)
        if n_spatial > 1:  # every non-empty shard runs the net
            rows = max(s[1] for s in inputs.values() if len(s) == 3)
            runs *= len(shard_bounds(rows, n_spatial)) - 1
        for _ in range(runs):
            sites.update(more)
            for name, site in found:
                convs[name].append((factor, site))
        return shapes

    for gh, gw in geoms:
        img = (3, gh, gw)
        if session.model.family == "v4":
            feed = {"in0": img, "in1": img, "in2": (1, gh, gw)}
            if tta or temporal:  # tap by tap, the earlier taps pinned
                for tap in V4_TAPS:
                    feed[tap] = walk("flownet", feed, [tap], views,
                                     sweeps)[tap]
            walk("flownet", feed, ["out0"], views, sweeps)
            continue
        if session.uhd_mode:
            half = (3, gh // 2, gw // 2)
            c, fh, fw = walk("flownet", {"input0": half, "input1": half},
                             ["flow"], views, sweeps,
                             {"no_u8_warp": True})["flow"]
            flow = (c, 2 * fh, 2 * fw)
        else:
            flow = walk("flownet", {"input0": img, "input1": img}, ["flow"],
                        views, sweeps)["flow"]
        if session.model.family == "v2":
            runs = [(2 * views, "flow.0")]
        else:
            runs = [(views, "flow.0"), (views, "flow.1")]
        for factor, slot in runs:
            shapes = walk("contextnet", {"input.1": img, slot: (2, *flow[1:])},
                          list(CONTEXT_FEATS), factor)
        feats = {str(3 + i + k): shapes[f] for k in (0, 4)
                 for i, f in enumerate(CONTEXT_FEATS)}
        walk("fusionnet", {"img0": img, "img1": img, "flow": flow, **feats},
             ["output"], views, sweeps)
    return sites, convs["conv3x3"], convs["conv3x3_ps"], convs["deconv4x4"]


def kernel_sites(session, h: int, w: int,
                 n_spatial: int = 1) -> Dict[str, int]:
    """Kernel launches of one ``process_batch`` step of a ``RIFE`` session
    on (h, w) frames, or (``n_spatial`` > 1) of one data shard's step
    height-sharded over ``n_spatial`` shards: each non-empty shard runs each
    net, its warps single warps at absolute positions and its conv sites
    gated on the whole blob."""
    return dict(_plan(session, h, w, n_spatial)[0])


def conv_sites(session, h: int, w: int,
               kernel: str = "conv3x3") -> List[tuple]:
    """The distinct calls of ``kernel`` (``conv3x3``; ``conv3x3_ps``: the
    PixelShuffle sites; ``deconv4x4``: the deconv kernel's) in one step on
    (h, w) frames, as (batch factor, part channels, cout, stride, activation
    code, H, W, deconv): a deconv site on ``conv3x3`` has cout = 4 x its
    channels, a PixelShuffle site the channels before the shuffle; a
    ``deconv4x4`` site is (batch factor, (cin,), O, PixelShuffle factor,
    activation code, H, W, XLA order)."""
    return [site for site, _ in conv_site_counts(session, h, w, kernel)]


def conv_site_counts(session, h: int, w: int,
                     kernel: str = "conv3x3") -> List[Tuple[tuple, int]]:
    """``conv_sites`` with each distinct call's launches in the step:
    [(site, launches), ...] in the order the step first calls them."""
    plan = _plan(session, h, w)
    counts: Dict[tuple, int] = {}
    names = ("conv3x3", "conv3x3_ps", "deconv4x4")
    for factor, site in plan[1 + names.index(kernel)]:
        key = (factor, *site)
        counts[key] = counts.get(key, 0) + 1
    return list(counts.items())
