"""PyTorch implementations of the ncnn layer kinds the rife-v4.6 plain path
runs (port of ``rife_tpu/ops/jax_ops.py``), driven by ``rife_tpu``'s
``Executor``.

Tensors are NCHW; an ncnn CHW axis ``a`` of a rank-4 blob is torch dim
``a + 1``.  Every kind outside ``OP_TABLE`` raises ``NotImplementedError``
in ``Executor.run``.  Parity traps handled here (ROADMAP queue C):

* resize is phase-decomposed ``a*(1-f) + b*f`` in the storage dtype and a
  downsample is ``0.5*a + 0.5*b`` (``jax_ops.py:183-261``), not
  ``F.interpolate``, which rounds differently;
* deconvolution uses ncnn's raw (I,O,kh,kw) weights with
  ``F.conv_transpose2d``, not the spatially flipped ones ``jax_ops``
  prepares for its lhs-dilated conv;
* PixelShuffle is ``F.pixel_shuffle`` (channel c*r*r + i*r + j, as
  ``jax_ops.pixel_shuffle``);
* scalar constants are cast to the storage dtype before they multiply, as
  ``jnp.asarray(c, x.dtype)`` does.

Plain convolutions go to ``F.conv2d`` (cuDNN on the card): the JAX package
leaves them to XLA, outside any Pallas kernel.  The warps dispatch into
``ops/warp.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rife_tpu.ops import common as C

from . import warp as W


def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def _dim(axis: int, rank: int) -> int:
    """ncnn CHW axis -> torch dim of a (B,C,H,W) or (B,C) blob."""
    if rank == 4:
        return axis + 1
    if rank == 2 and axis == 0:
        return 1
    raise ValueError(f"axis {axis} invalid for a rank-{rank} blob")


# ---------------------------------------------------------------------------
# functional primitives
# ---------------------------------------------------------------------------

def apply_activation(y: torch.Tensor, act: int, params):
    """The fused activations of the v4.6 convs: none or leaky relu."""
    if act == C.ACT_NONE:
        return y
    if act == C.ACT_LEAKY:
        return torch.where(y >= 0, y, y * _const(y, params[0]))
    raise NotImplementedError(f"fused activation {act} is not ported")


def _upsample_axis(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Half-pixel bilinear x``n`` upsample along ``dim``:
    out[n*m+p] = (1-f_p)*in[m+d_p] + f_p*in[m+d_p+1], edge-clamped."""
    size = x.shape[dim]
    ar = torch.arange(size, device=x.device)
    phases = []
    for p in range(n):
        src = (p + 0.5) / n - 0.5
        d = int(math.floor(src))
        f = src - d
        a = x.index_select(dim, (ar + d).clamp(0, size - 1))
        b = x.index_select(dim, (ar + d + 1).clamp(0, size - 1))
        phases.append(a * _const(x, 1.0 - f) + b * _const(x, f))
    shape = list(x.shape)
    shape[dim] = size * n
    return torch.stack(phases, dim=dim + 1).reshape(shape)


def _downsample_axis(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Half-pixel bilinear 1/``n`` downsample (even n): the source position
    lands halfway between taps n/2-1 and n/2 of each block."""
    size = x.shape[dim]
    idx = [slice(None)] * x.ndim

    def take(start):
        idx[dim] = slice(start, size, n)
        return x[tuple(idx)]

    half = _const(x, 0.5)
    return take(n // 2 - 1) * half + take(n // 2) * half


def resize2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize (align_corners=False, no antialiasing) for
    integer and 1/even-integer factors, H first then W, as
    ``jax_ops.resize2d``; other ratios raise."""
    h, w = x.shape[2], x.shape[3]
    for dim, src, dst in ((2, h, out_h), (3, w, out_w)):
        if dst == src:
            continue
        if dst % src == 0:
            x = _upsample_axis(x, dst // src, dim)
        elif src % dst == 0 and (src // dst) % 2 == 0:
            x = _downsample_axis(x, src // dst, dim)
        else:
            raise NotImplementedError(
                f"resize {h}x{w} -> {out_h}x{out_w}: only integer and "
                f"1/even-integer factors are ported")
    return x


# ---------------------------------------------------------------------------
# layer table
# ---------------------------------------------------------------------------

def _conv_act(node, y):
    return apply_activation(y, *C.activation_of(node))


def _op_convolution(node, inputs, w, ctx):
    _, _, dilation, stride, pad, _ = C.conv_hyperparams(node)
    p = ctx["w"][node.name]
    y = F.conv2d(inputs[0], p["weight"], p["bias"], stride=stride,
                 padding=pad, dilation=dilation)
    return [_conv_act(node, y)]


def _op_convolution_cat(node, inputs, w, ctx):
    """ConvolutionCat (rewrite fuse_concat_into_convs): the concat is
    re-materialized, identical semantics."""
    return _op_convolution(node, [torch.cat(inputs, dim=1)], w, ctx)


def _op_deconvolution(node, inputs, w, ctx):
    _, k, dilation, stride, pad, _ = C.conv_hyperparams(node)
    p = ctx["w"][node.name]
    y = F.conv_transpose2d(inputs[0], p["weight"], p["bias"], stride=stride,
                           padding=pad, dilation=dilation)
    return [_conv_act(node, y)]


def _op_deconv_ps(node, inputs, w, ctx):
    """rife.DeconvPS (rewrite fuse_pixelshuffle_into_convs): deconv, then
    PixelShuffle by params[25]."""
    y = _op_deconvolution(node, inputs, w, ctx)[0]
    return [F.pixel_shuffle(y, int(node.p(25, 2)))]


def _op_pixelshuffle(node, inputs, w, ctx):
    return [F.pixel_shuffle(inputs[0], int(node.p(0, 1)))]


def _op_interp(node, inputs, w, ctx):
    x = inputs[0]
    rtype, oh, ow = C.interp_out_size(x.shape[2], x.shape[3], node)
    if rtype != 2:
        raise NotImplementedError(f"Interp resize_type {rtype}: only "
                                  f"bilinear is ported")
    return [resize2d(x, oh, ow)]


def _op_concat(node, inputs, w, ctx):
    return [torch.cat(inputs, dim=_dim(int(node.p(0, 0)), inputs[0].ndim))]


def _op_crop(node, inputs, w, ctx):
    x = inputs[0]
    starts = node.p(-23309, [])
    ends = node.p(-23310, [])
    axes = node.p(-23311, [])
    for s, e, a in zip(starts, ends, axes):
        d = _dim(int(a), x.ndim)
        x = x[(slice(None),) * d + (slice(int(s), int(e)),)]
    return [x]


def _op_slice(node, inputs, w, ctx):
    x = inputs[0]
    d = _dim(int(node.p(1, 0)), x.ndim)
    sizes = C.slice_sizes(node, x.shape[d], len(node.tops))
    return list(torch.split(x, [int(s) for s in sizes], dim=d))


def _op_split(node, inputs, w, ctx):
    return [inputs[0]] * len(node.tops)


# the op types the v4.6 graph uses
_BINARY = {
    C.BINARY_ADD: lambda a, b: a + b,
    C.BINARY_MUL: lambda a, b: a * b,
    C.BINARY_RSUB: lambda a, b: b - a,
}


def _op_binaryop(node, inputs, w, ctx):
    op = _BINARY.get(int(node.p(0, 0)))
    if op is None:
        raise NotImplementedError(f"BinaryOp op_type {node.p(0, 0)} is not "
                                  f"ported")
    a = inputs[0]
    if int(node.p(1, 0)) == 1:
        return [op(a, _const(a, float(node.p(2, 0.0))))]
    if inputs[1].ndim != a.ndim:
        raise NotImplementedError("BinaryOp broadcast across ranks")
    return [op(a, inputs[1])]


def _op_eltwise(node, inputs, w, ctx):
    if int(node.p(0, 0)) != 1:
        raise NotImplementedError("only Eltwise SUM is used by the zoo")
    coeffs = C.eltwise_coeffs(node, len(inputs))
    acc = inputs[0] * _const(inputs[0], coeffs[0])
    for x, cf in zip(inputs[1:], coeffs[1:]):
        acc = acc + x * _const(x, cf)
    return [acc]


def _op_sigmoid(node, inputs, w, ctx):
    return [torch.sigmoid(inputs[0])]


# --- warps -------------------------------------------------------------------

def _is_u8(blob: str, image: torch.Tensor, ctx) -> bool:
    """Only 3-channel value-copies of the input frames take the u8-origin
    kernels (ROADMAP queue C #6)."""
    return image.shape[1] == 3 and blob in ctx.get("u8_image_blobs", ())


def _pair_ok(node, img_a, img_b, flow_a, flow_b, ctx) -> bool:
    return (img_a.shape == img_b.shape and flow_a.shape == flow_b.shape
            and _is_u8(node.bottoms[0], img_a, ctx)
            and _is_u8(node.bottoms[2], img_b, ctx))


def _unpaired(kind: str, node, image, flow, blob, ctx, ds4: bool):
    """A single warp outside the pair kernels: plain PyTorch on the CPU;
    on CUDA it waits for the single-warp kernel (K4), so it raises instead of
    falling back to plain torch unnoticed."""
    if image.device.type != "cpu":
        raise NotImplementedError(
            f"{kind} {node.name}: the single u8 warp kernel (K4, "
            f"warp_pallas._warp_pallas_u8_impl_any) is not ported to CUDA "
            f"yet (ROADMAP queue B); the pair kernels' gates failed here")
    if not _is_u8(blob, image, ctx):
        raise NotImplementedError(
            f"{kind} {node.name}: float-image warps (K1/K2) are not ported "
            f"yet (ROADMAP queue B)")
    fn = W.warp_ds4_u8_ref if ds4 else W.warp_u8_ref
    return fn(image, flow)


def _op_warp(node, inputs, w, ctx):
    return [_unpaired("rife.Warp", node, inputs[0], inputs[1],
                      node.bottoms[0], ctx, ds4=False)]


def _op_warp_ds4(node, inputs, w, ctx):
    return [_unpaired("rife.WarpDs4", node, inputs[0], inputs[1],
                      node.bottoms[0], ctx, ds4=True)]


def _op_warp_pair(node, inputs, w, ctx):
    img_a, flow_a, img_b, flow_b = inputs
    if _pair_ok(node, img_a, img_b, flow_a, flow_b, ctx):
        return list(W.warp_pair(img_a, flow_a.contiguous(),
                                img_b, flow_b.contiguous()))
    return [
        _unpaired("rife.WarpPair", node, img_a, flow_a, node.bottoms[0],
                  ctx, ds4=False),
        _unpaired("rife.WarpPair", node, img_b, flow_b, node.bottoms[2],
                  ctx, ds4=False),
    ]


def _op_warp_ds4_pair(node, inputs, w, ctx):
    img_a, flow_a, img_b, flow_b = inputs
    h, wid = img_a.shape[2], img_a.shape[3]
    if (h % 4 == 0 and wid % 4 == 0
            and _pair_ok(node, img_a, img_b, flow_a, flow_b, ctx)):
        return list(W.warp_ds4_pair(img_a, flow_a.contiguous(),
                                    img_b, flow_b.contiguous()))
    return [
        _unpaired("rife.WarpDs4Pair", node, img_a, flow_a, node.bottoms[0],
                  ctx, ds4=True),
        _unpaired("rife.WarpDs4Pair", node, img_b, flow_b, node.bottoms[2],
                  ctx, ds4=True),
    ]


def _op_render_blend(node, inputs, w, ctx):
    """rife.RenderBlend (rewrite fuse_render_blend):
    ``warp(img_m, flow_m)*mask + warp(img_inv, flow_inv)*(1-mask)``.
    Emits (B,H,3,W) planes when the top is in ctx['planar_outputs'] (the v4
    pipeline then finishes with frame.postprocess_planar), NCHW otherwise."""
    img_m, flow_m, img_i, flow_i, mask = inputs
    planar = node.tops[0] in ctx.get("planar_outputs", ())
    if _pair_ok(node, img_m, img_i, flow_m, flow_i, ctx):
        out = W.warp_render(img_m, flow_m.contiguous(), img_i,
                            flow_i.contiguous(), mask[:, 0].contiguous())
        return [out if planar else out.permute(0, 2, 1, 3)]
    wm = _unpaired("rife.RenderBlend", node, img_m, flow_m, node.bottoms[0],
                   ctx, ds4=False)
    wi = _unpaired("rife.RenderBlend", node, img_i, flow_i, node.bottoms[2],
                   ctx, ds4=False)
    out = wm * mask + wi * (1 - mask)
    return [out.permute(0, 2, 1, 3) if planar else out]


OP_TABLE = {
    "Convolution": _op_convolution,
    "ConvolutionCat": _op_convolution_cat,
    "Deconvolution": _op_deconvolution,
    "rife.DeconvPS": _op_deconv_ps,
    "PixelShuffle": _op_pixelshuffle,
    "Interp": _op_interp,
    "Concat": _op_concat,
    "Crop": _op_crop,
    "Slice": _op_slice,
    "Split": _op_split,
    "BinaryOp": _op_binaryop,
    "Eltwise": _op_eltwise,
    "Sigmoid": _op_sigmoid,
    "rife.Warp": _op_warp,
    "rife.WarpDs4": _op_warp_ds4,
    "rife.WarpPair": _op_warp_pair,
    "rife.WarpDs4Pair": _op_warp_ds4_pair,
    "rife.RenderBlend": _op_render_blend,
}


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

_CONV_KINDS = ("Convolution", "ConvolutionCat")
_DECONV_KINDS = ("Deconvolution", "rife.DeconvPS")


def _entry(weight, bias, dtype, device) -> Dict[str, Optional[torch.Tensor]]:
    def t(a):
        return None if a is None else torch.from_numpy(
            np.array(a, np.float32)).to(device=device, dtype=dtype)

    return {"weight": t(weight), "bias": t(bias)}


def prepare_weights(graph, raw, dtype=torch.float32, device="cpu"):
    """ncnn-layout numpy weights -> torch tensors in the activation dtype.

    Convolution keeps ncnn's (O,I,kh,kw) = torch OIHW; Deconvolution keeps
    ncnn's raw (I,O,kh,kw), which ``F.conv_transpose2d`` takes as it is."""
    out = {}
    for node in graph.nodes:
        lw = raw.get(node.name)
        if lw is None:
            continue
        if node.type in _CONV_KINDS + _DECONV_KINDS:
            out[node.name] = _entry(lw.weight, lw.bias, dtype, device)
    return out


def weights_from_jax(graph, tree, dtype=torch.float32, device="cpu"):
    """The JAX package's prepared weights (``jax_ops.prepare_weights``, as
    numpy arrays) -> this module's: HWIO convs become OIHW, the spatially
    flipped HWIO deconvs become ncnn's (I,O,kh,kw)."""
    out = {}
    for node in graph.nodes:
        e = tree.get(node.name)
        if e is None or node.type not in _CONV_KINDS + _DECONV_KINDS:
            continue
        hwio = np.asarray(e["hwio"], np.float32)
        if node.type in _CONV_KINDS:
            weight = hwio.transpose(3, 2, 0, 1)
        else:
            weight = hwio[::-1, ::-1].transpose(2, 3, 0, 1)
        out[node.name] = _entry(weight, e["bias"], dtype, device)
    return out
