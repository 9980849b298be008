"""PyTorch implementations of the ncnn layer kinds the v4.6, v2.3 and v1
paths run (port of ``rife_tpu/ops/jax_ops.py``), driven by the ``Executor``
of ``graph/executor.py``.

Tensors are NCHW; an ncnn CHW axis ``a`` of a rank-4 blob is torch dim
``a + 1``, and the v1 SE gates carry (B,C) vectors (global ``Pooling``,
``InnerProduct``), which a ``BinaryOp`` broadcasts into a (B,C,H,W) map.
Every kind outside ``OP_TABLE`` raises ``NotImplementedError`` in
``Executor.run``.  Parity traps handled here (ROADMAP queue C):

* resize is phase-decomposed ``a*(1-f) + b*f`` in the storage dtype and a
  downsample is ``0.5*a + 0.5*b`` (``jax_ops.py:183-261``), not
  ``F.interpolate``, which rounds differently;
* deconvolution uses ncnn's raw (I,O,kh,kw) weights with
  ``F.conv_transpose2d``, not the spatially flipped ones ``jax_ops``
  prepares for its lhs-dilated conv;
* PixelShuffle is ``F.pixel_shuffle`` (channel c*r*r + i*r + j, as
  ``jax_ops.pixel_shuffle``);
* scalar constants are cast to the storage dtype before they multiply, as
  ``jnp.asarray(c, x.dtype)`` does (``scalar``; no op of a step copies a
  constant from the host: from pageable memory that copy waits for every
  op queued before it);
* ``InnerProduct`` rounds its f32 product to the storage dtype before it
  adds the bias in that dtype, and global ``Pooling`` sums in f32 and
  divides before its one rounding, as ``jnp.dot`` / ``jnp.mean`` do.

Convolutions go to ``F.conv2d`` / ``F.conv_transpose2d`` (cuDNN on the
card), as the JAX package leaves them to XLA, except at the sites that the
TPU's planar executor sends to its Pallas convs: in a net run with ctx
``planar_convs`` (the v1/v2/v3 nets), the gates of ``ops/conv.py`` route a
site to the ``conv3x3`` kernel (K9-K12), a ``rife.ConvPS`` site to its
PixelShuffle form (B4, ``conv3x3_ps``) and a deconv site to ``deconv4x4``.
In a bf16 run on the card every other 4x4 stride-2 pad-1 deconv site
(``Deconvolution``, ``rife.DeconvPS``) takes the deconv kernel too, in XLA's
rounding order (``ops/conv.py`` ``deconv_route``): cuDNN gave a window of
rows, or another batch size, other bytes.  At every other site on the card
the library conv runs without its bias and one pass of ``ops/conv.py``
``bias_act`` applies the bias and the fused activation (``_library_site``),
with the bits of the library's bias add and ``apply_activation``.  The
warps dispatch into ``ops/warp.py``: the pair kernels for paired u8-origin
warps, the fused warp + 1/2 downsample (K3) for ``rife.WarpDs2`` of a frame
copy, the single-warp kernel for the rest (u8-origin mode K4, float mode
K1/K2).  A run whose ctx sets ``no_u8_warp`` (the UHD flownet) sends every
warp to the float mode.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Hashable

import numpy as np
import torch
import torch.nn.functional as F

from . import common as C
from . import conv as CV
from . import warp as W


def scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float.  A ``dtype`` tensor
    times (plus, minus) it computes the bits it does with the 0-dim
    ``torch.tensor(v, dtype=dtype)``: the op's opmath (f32) on the two
    values, rounded once.  The scalar travels in the kernel's arguments,
    so the op needs no host-to-device copy."""
    v = float(v)
    return _rounded(v, math.copysign(1.0, v), dtype)


@functools.lru_cache(maxsize=None)
def _rounded(v: float, sign: float, dtype: torch.dtype) -> float:
    # ``sign`` keeps -0.0 and 0.0 apart: they are equal as keys
    return float(torch.tensor(v, dtype=dtype))


# Tensors built on the host and copied to their device once, at a step's
# first use; immutable, shared by every session of the process.
_ONCE: Dict[Hashable, torch.Tensor] = {}


def _once(key: Hashable, make: Callable[[], torch.Tensor]) -> torch.Tensor:
    t = _ONCE.get(key)
    if t is None:
        t = _ONCE.setdefault(key, make())
    return t


def device_const(v: float, dtype: torch.dtype, device) -> torch.Tensor:
    """The 0-dim ``torch.tensor(v, dtype=dtype, device=device)``, made once
    per (value, dtype, device): for the ops whose arithmetic a host scalar
    changes (CUDA divides by a host scalar as a multiply by its
    reciprocal; ``c / x`` is then ``reciprocal(x) * c``; ``pow`` takes
    special cases for a host exponent; ``maximum`` / ``minimum`` take no
    scalar)."""
    v = float(v)
    return _once(("const", v, math.copysign(1.0, v), dtype, device),
                 lambda: torch.tensor(v, dtype=dtype, device=device))


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

def apply_activation(y: torch.Tensor, act: int, params, slope=None):
    """The fused activations of the zoo's convs and inner products, in the
    storage dtype: none, ReLU, leaky relu, clip, sigmoid (``sigmoid``) and
    per-channel PReLU (``slope`` broadcastable to (1,C,1,1), already in that
    dtype; ``jax_ops._prelu_ch``)."""
    if act == C.ACT_NONE:
        return y
    if act == C.ACT_RELU:
        return torch.clamp_min(y, 0)
    if act == C.ACT_LEAKY:
        return torch.where(y >= 0, y, y * scalar(params[0], y.dtype))
    if act == C.ACT_CLIP:
        return torch.clamp(y, params[0], params[1])
    if act == C.ACT_SIGMOID:
        return sigmoid(y)
    if act == C.ACT_PRELU_CH:
        return torch.where(y >= 0, y, y * slope)
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
        phases.append(a * scalar(1.0 - f, x.dtype)
                      + b * scalar(f, x.dtype))
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

    half = scalar(0.5, x.dtype)
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


def _nearest_index(src: int, dst: int, device) -> torch.Tensor:
    pos = (torch.arange(dst, dtype=torch.float32) + 0.5) * src / dst
    return torch.floor(pos).long().to(device)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize as ``jax.image.resize(..., "nearest")`` computes it:
    output index i of an axis of n reads input floor((i + 0.5) * m / n),
    the product and quotient in f32; an axis whose size stays is left as
    it is."""
    for dim, dst in ((2, out_h), (3, out_w)):
        src = x.shape[dim]
        if dst == src:
            continue
        x = x.index_select(dim, _once(("nearest", src, dst, x.device),
                                      lambda: _nearest_index(src, dst,
                                                             x.device)))
    return x


# ---------------------------------------------------------------------------
# layer table
# ---------------------------------------------------------------------------

def _site_rows(x: torch.Tensor, ctx) -> int:
    """The rows the site gates of ``ops/conv.py`` see: the input's, or under
    height sharding the whole blob's (ctx ``site_rows``, set per node by
    ``graph/spatial.py``), so that a site takes the same path on every
    shard as it does unsharded."""
    return int(ctx.get("site_rows", x.shape[2]))


def _kernel_act(node):
    """(kernel activation code, leaky alpha) of a conv node; an activation
    the kernels do not take raises."""
    act, params = C.activation_of(node)
    if act not in CV.ACT_MAP:
        raise NotImplementedError(f"{node.type} {node.name}: fused activation "
                                  f"{act} is not one the conv kernels take")
    alpha = float(params[0]) if act == C.ACT_LEAKY else 0.2
    return CV.ACT_MAP[act], alpha


def _conv_kernel(node, parts, p, stride, **kw):
    act, alpha = _kernel_act(node)
    return CV.conv3x3([x.contiguous() for x in parts], p["weight"],
                      p["bias_f32"], p.get("slope_f32"), stride=stride,
                      act=act, alpha=alpha, weight_tc=p.get("weight_tc"), **kw)


def _library_site(node, conv, x, p):
    """A conv site on the library: ``conv(x, weight, bias)``
    (``F.conv2d`` / ``F.conv_transpose2d`` with the site's hyperparameters),
    then the fused activation.  Where ``ops/conv.py``
    ``epilogue_on_kernel`` says so (the card) the conv runs without its bias
    and one ``bias_act`` pass applies the bias and the activation, with the
    bits of the library's bias add and ``apply_activation``."""
    act, params = C.activation_of(node)
    if not CV.epilogue_on_kernel(x.device, act, p["bias"] is not None):
        return apply_activation(conv(x, p["weight"], p["bias"]), act, params,
                                p.get("slope"))
    alpha = float(params[0]) if act == C.ACT_LEAKY else 0.2
    return CV.bias_act(conv(x, p["weight"], None), p.get("bias_q"),
                       p.get("slope_q"), CV.ACT_MAP[act], alpha)


def _op_convolution(node, inputs, w, ctx):
    _, _, dilation, stride, pad, _ = C.conv_hyperparams(node)
    p = ctx["w"][node.name]
    x = inputs[0]
    cout, cin = p["weight"].shape[0], p["weight"].shape[1]
    if ctx.get("planar_convs") and CV.conv_wants_planar(
            node, _site_rows(x, ctx), x.shape[3], cin, cout, ctx):
        return [_conv_kernel(node, [x], p, stride)]
    conv = functools.partial(F.conv2d, stride=stride, padding=pad,
                             dilation=dilation)
    return [_library_site(node, conv, x, p)]


def _op_convolution_cat(node, inputs, w, ctx):
    """ConvolutionCat (rewrite fuse_concat_into_convs): at a gated site the
    kernel reads the parts (more than four: the tail is concatenated into
    the fourth); elsewhere the concat is re-materialized, identical
    semantics."""
    _, _, _, stride, _, _ = C.conv_hyperparams(node)
    p = ctx["w"][node.name]
    cout, cin = p["weight"].shape[0], p["weight"].shape[1]
    h, wid = _site_rows(inputs[0], ctx), inputs[0].shape[3]
    if ctx.get("planar_convs") and CV.cat_conv_wants_planar(
            node, h, wid, cin, cout, len(inputs), ctx):
        parts = list(inputs)
        if len(parts) > CV.MAX_PARTS:
            tail = torch.cat(parts[CV.MAX_PARTS - 1:], dim=1)
            parts = parts[:CV.MAX_PARTS - 1] + [tail]
        return [_conv_kernel(node, parts, p, stride)]
    return _op_convolution(node, [torch.cat(inputs, dim=1)], w, ctx)


def _deconv_site(node, x, p, ctx, ps=1):
    """A deconv site on its route (``ops/conv.py`` ``deconv_route``): the
    planar site's ``deconv4x4``, or ``deconv4x4_xla``; with ``ps`` = 2 the
    PixelShuffle(2) of the result.  None on the library route."""
    cin, cout = p["weight"].shape[0], p["weight"].shape[1]
    route = CV.deconv_route(node, _site_rows(x, ctx), x.shape[3], cin, cout,
                            ctx, x.device, x.dtype)
    if route == "library":
        return None
    act, alpha = _kernel_act(node)
    if route == "planar":
        return CV.deconv4x4(x.contiguous(), p["phase_weight"],
                            p["phase_bias_f32"], p.get("phase_slope_f32"),
                            act=act, alpha=alpha, weight_t4=p["weight_t4"],
                            ps=ps)
    return CV.deconv4x4_xla(x.contiguous(), p["weight_t4"], p["bias_q"],
                            p.get("slope_q"), act=act, alpha=alpha, ps=ps)


def _op_deconvolution(node, inputs, w, ctx):
    _, k, dilation, stride, pad, _ = C.conv_hyperparams(node)
    p = ctx["w"][node.name]
    x = inputs[0]
    y = _deconv_site(node, x, p, ctx)
    if y is not None:
        return [y]
    conv = functools.partial(F.conv_transpose2d, stride=stride, padding=pad,
                             dilation=dilation)
    return [_library_site(node, conv, x, p)]


def _op_conv_ps(node, inputs, w, ctx):
    """rife.ConvPS / rife.DeconvPS (rewrite fuse_pixelshuffle_into_convs):
    the conv (a 4x4 stride-2 deconv), then PixelShuffle by params[25].  At a
    planar site (the gates on the pre-shuffle channels, as
    ``planar_ops._op_conv_ps`` asks them) and at a DeconvPS site of a bf16
    run on the card the kernel writes the shuffled tensor itself (B4:
    ``conv3x3(..., ps=r)``, ``deconv4x4(..., ps=2)``,
    ``deconv4x4_xla(..., ps=2)``); elsewhere the two ops are composed
    (``jax_ops._op_conv_ps``)."""
    p = ctx["w"][node.name]
    x = inputs[0]
    r = int(node.p(25, 2))
    h, wid = _site_rows(x, ctx), x.shape[3]
    if node.type == "rife.DeconvPS":
        ps = 2 if r == 2 else 1
        y = _deconv_site(node, x, p, ctx, ps=ps)
        if y is not None:
            return [y if ps == r else F.pixel_shuffle(y, r)]
        y = _op_deconvolution(node, inputs, w, ctx)[0]
    else:
        cout, cin = p["weight"].shape[0], p["weight"].shape[1]
        if ctx.get("planar_convs") and CV.conv_wants_planar(
                node, h, wid, cin, cout, ctx):
            _, _, _, stride, _, _ = C.conv_hyperparams(node)
            return [_conv_kernel(node, [x], p, stride, ps=r)]
        y = _op_convolution(node, inputs, w, ctx)[0]
    return [F.pixel_shuffle(y, r)]


def _op_pixelshuffle(node, inputs, w, ctx):
    return [F.pixel_shuffle(inputs[0], int(node.p(0, 1)))]


def _op_interp(node, inputs, w, ctx):
    x = inputs[0]
    rtype, oh, ow = C.interp_out_size(x.shape[2], x.shape[3], node)
    if rtype == 1:
        return [resize_nearest(x, oh, ow)]
    if rtype != 2:
        raise NotImplementedError(f"Interp resize_type {rtype}: only "
                                  f"nearest and bilinear are ported")
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


def _op_prelu(node, inputs, w, ctx):
    """Standalone PReLU (one slope per channel, or one shared), in the
    storage dtype (``jax_ops._op_prelu``)."""
    x = inputs[0]
    slope = ctx["w"][node.name]["slope"]
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return [torch.where(x >= 0, x, x * slope.reshape(shape))]


def _op_relu(node, inputs, w, ctx):
    slope = float(node.p(0, 0.0))
    x = inputs[0]
    if slope == 0.0:
        return [torch.clamp_min(x, 0)]
    return [torch.where(x >= 0, x, x * scalar(slope, x.dtype))]


def _op_clip(node, inputs, w, ctx):
    return [torch.clamp(inputs[0], float(node.p(0)), float(node.p(1)))]


_BINARY = {
    C.BINARY_ADD: lambda a, b: a + b,
    C.BINARY_SUB: lambda a, b: a - b,
    C.BINARY_MUL: lambda a, b: a * b,
    C.BINARY_DIV: lambda a, b: a / b,
    C.BINARY_MAX: torch.maximum,
    C.BINARY_MIN: torch.minimum,
    C.BINARY_POW: torch.pow,
    C.BINARY_RSUB: lambda a, b: b - a,
    C.BINARY_RDIV: lambda a, b: b / a,
}
# the kinds whose bits a Python scalar keeps (``scalar``); ``c - x`` is one
# ``torch.rsub``
_HOST_SCALAR = (C.BINARY_ADD, C.BINARY_SUB, C.BINARY_MUL, C.BINARY_RSUB)


def _broadcast_pair(a: torch.Tensor, b: torch.Tensor):
    """A (B,C) vector against a (B,C,H,W) map, either side
    (``jax_ops._broadcast_pair``): the vector becomes (B,C,1,1)."""
    if a.ndim == b.ndim:
        return a, b
    if a.ndim == 2 and b.ndim == 4:
        return a[:, :, None, None], b
    if a.ndim == 4 and b.ndim == 2:
        return a, b[:, :, None, None]
    raise ValueError(f"cannot broadcast ranks {a.ndim} vs {b.ndim}")


def _op_binaryop(node, inputs, w, ctx):
    op = _BINARY.get(int(node.p(0, 0)))
    if op is None:
        raise NotImplementedError(f"BinaryOp op_type {node.p(0, 0)} is not "
                                  f"ported")
    a = inputs[0]
    if int(node.p(1, 0)) == 1:
        v = float(node.p(2, 0.0))
        if int(node.p(0, 0)) in _HOST_SCALAR:
            return [op(a, scalar(v, a.dtype))]
        return [op(a, device_const(v, a.dtype, a.device))]
    return [op(*_broadcast_pair(a, inputs[1]))]


_UNARY = {
    C.UNARY_ABS: torch.abs,
    C.UNARY_NEG: torch.neg,
    C.UNARY_FLOOR: torch.floor,
    C.UNARY_CEIL: torch.ceil,
    C.UNARY_SQUARE: torch.square,
    C.UNARY_SQRT: torch.sqrt,
    C.UNARY_RSQRT: torch.rsqrt,
    C.UNARY_EXP: torch.exp,
    C.UNARY_LOG: torch.log,
    C.UNARY_SIN: torch.sin,
    C.UNARY_COS: torch.cos,
    C.UNARY_TAN: torch.tan,
}


def _op_unaryop(node, inputs, w, ctx):
    op = _UNARY.get(int(node.p(0, 0)))
    if op is None:
        raise NotImplementedError(f"UnaryOp op_type {node.p(0, 0)} is not "
                                  f"ported")
    return [op(inputs[0])]


def _op_pooling(node, inputs, w, ctx):
    """Global average pooling (``0=1 4=1``), the only kind the zoo uses:
    (B,C,H,W) -> (B,C), summed in f32 and divided before one rounding to
    the storage dtype, as ``jnp.mean`` computes it."""
    if int(node.p(4, 0)) != 1 or int(node.p(0, 0)) != 1:
        raise NotImplementedError("only global average pooling is used by "
                                  "the zoo")
    x = inputs[0]
    n = x.shape[2] * x.shape[3]
    return [(torch.sum(x, dim=(2, 3), dtype=torch.float32) / n).to(x.dtype)]


def _op_innerproduct(node, inputs, w, ctx):
    """(B,in) -> (B,out) (``jax_ops._op_innerproduct``): the product in f32
    (bf16 operands are exact in f32), rounded to the storage dtype, then the
    bias added in that dtype (ROADMAP queue C #7's trap), then the fused
    activation."""
    x = inputs[0]
    p = ctx["w"][node.name]
    y = (x.float() @ p["weight"].float().t()).to(x.dtype)
    if p["bias"] is not None:
        y = y + p["bias"]
    act, params = C.activation_of(node)
    return [apply_activation(y, act, params)]


def _op_eltwise(node, inputs, w, ctx):
    if int(node.p(0, 0)) != 1:
        raise NotImplementedError("only Eltwise SUM is used by the zoo")
    coeffs = C.eltwise_coeffs(node, len(inputs))
    acc = inputs[0] * scalar(coeffs[0], inputs[0].dtype)
    for x, cf in zip(inputs[1:], coeffs[1:]):
        acc = acc + x * scalar(cf, x.dtype)
    return [acc]


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA:CPU computes it: in bf16 it evaluates
    ``1 / (1 + exp(-x))`` with each step rounded to bf16, while
    ``torch.sigmoid`` rounds once and differs by 1 ulp on about half of a
    mask's values.  Whether XLA on the TPU rounds stepwise too is not known
    (its bf16 elementwise ops may run in f32 and round once, as
    ``torch.sigmoid`` does).  f32 keeps ``torch.sigmoid``."""
    if x.dtype == torch.bfloat16:
        return torch.reciprocal(torch.exp(-x) + 1)
    return torch.sigmoid(x)


def _op_sigmoid(node, inputs, w, ctx):
    return [sigmoid(inputs[0])]


# --- warps -------------------------------------------------------------------

def _is_u8(blob: str, image: torch.Tensor, ctx) -> bool:
    """Only 3-channel value-copies of the input frames take the u8-origin
    kernels (ROADMAP queue C #6), and none in a run whose ctx sets
    ``no_u8_warp``: the UHD flownet's resized frames are no longer u8-valued
    (``jax_ops._is_u8_warp``)."""
    return (not ctx.get("no_u8_warp") and image.shape[1] == 3
            and blob in ctx.get("u8_image_blobs", ()))


def _same_grid(node, image: torch.Tensor, flow: torch.Tensor) -> None:
    """A warp's flow lies on its image's grid.  The JAX ops raise on any
    other flow (a broadcast error); the kernels' twins would sample at the
    flow's grid instead, so the check is made here.  (The v2.3
    reconstruction's flownet meets it on a frame whose sides the 1/32 level
    does not divide, as with ``-u`` on frames padded to 32 but not to 64.)"""
    if image.shape[2:] != flow.shape[2:]:
        raise ValueError(
            f"{node.type} {node.name}: flow {tuple(flow.shape)} is not on the "
            f"grid of image {tuple(image.shape)}")


def _pair_ok(node, img_a, img_b, flow_a, flow_b, ctx) -> bool:
    return (img_a.shape == img_b.shape and flow_a.shape == flow_b.shape
            and _is_u8(node.bottoms[0], img_a, ctx)
            and _is_u8(node.bottoms[2], img_b, ctx))


def _single(node, image, flow, blob, ctx, ds4: bool):
    """One warp outside the pair kernels: the single-warp kernel in its
    u8-origin mode (K4) for 3-channel value copies of the frames, in its
    float mode (K1/K2) otherwise.  ``ds4``: the fused warp + 1/4 downsample
    of ``rife.WarpDs4`` (``jax_ops._op_warp_ds4``), sampled at the absolute
    positions of the downsample's taps."""
    _same_grid(node, image, flow)
    fn = W.warp_u8 if _is_u8(blob, image, ctx) else W.warp_feat
    image = image.contiguous()
    if not ds4:
        return fn(image, flow.contiguous())
    h, wid = image.shape[2], image.shape[3]
    if h % 4 or wid % 4:
        return resize2d(fn(image, flow.contiguous()), round(h * 0.25),
                        round(wid * 0.25))
    return W.half_sum2(fn(image, W.ds4_positions(flow), abs_pos=True))


def _op_warp(node, inputs, w, ctx):
    return [_single(node, inputs[0], inputs[1], node.bottoms[0], ctx,
                    ds4=False)]


def _op_warp_ds4(node, inputs, w, ctx):
    return [_single(node, inputs[0], inputs[1], node.bottoms[0], ctx,
                    ds4=True)]


def _pair_inputs(node, inputs):
    """Contiguous operands for the pair kernels (a v2 flownet warps channel
    crops of Concat(input0, input1), which are strided views), each flow on
    its image's grid."""
    _same_grid(node, inputs[0], inputs[1])
    _same_grid(node, inputs[2], inputs[3])
    return [t.contiguous() for t in inputs]


def _op_warp_pair(node, inputs, w, ctx):
    img_a, flow_a, img_b, flow_b = inputs
    if _pair_ok(node, img_a, img_b, flow_a, flow_b, ctx):
        return list(W.warp_pair(*_pair_inputs(node, inputs)))
    return [
        _single(node, img_a, flow_a, node.bottoms[0], ctx, ds4=False),
        _single(node, img_b, flow_b, node.bottoms[2], ctx, ds4=False),
    ]


def _op_warp_ds4_pair(node, inputs, w, ctx):
    img_a, flow_a, img_b, flow_b = inputs
    h, wid = img_a.shape[2], img_a.shape[3]
    if (h % 4 == 0 and wid % 4 == 0
            and _pair_ok(node, img_a, img_b, flow_a, flow_b, ctx)):
        return list(W.warp_ds4_pair(*_pair_inputs(node, inputs)))
    return [
        _single(node, img_a, flow_a, node.bottoms[0], ctx, ds4=True),
        _single(node, img_b, flow_b, node.bottoms[2], ctx, ds4=True),
    ]


def _op_warp_ds2(node, inputs, w, ctx):
    """rife.WarpDs2 (rewrite fuse_quarter_downscaled_warps with
    ``fuse_half``): a warp followed by the exact 1/2 downsample.  A
    u8-eligible frame copy with even H and W takes K3 (``warp_ds2``); any
    other image the warp, then ``resize2d`` to (H/2, W/2): the unfused
    branch of ``jax_ops._op_warp_ds2`` itself."""
    image, flow = inputs[0], inputs[1]
    h, wid = image.shape[2], image.shape[3]
    if h % 2 == 0 and wid % 2 == 0 and _is_u8(node.bottoms[0], image, ctx):
        _same_grid(node, image, flow)
        return [W.warp_ds2(image.contiguous(), flow.contiguous())]
    y = _single(node, image, flow, node.bottoms[0], ctx, ds4=False)
    return [resize2d(y, round(h * 0.5), round(wid * 0.5))]


def _op_render_blend(node, inputs, w, ctx):
    """rife.RenderBlend (rewrite fuse_render_blend):
    ``warp(img_m, flow_m)*mask + warp(img_inv, flow_inv)*(1-mask)``.
    Emits (B,H,3,W) planes when the top is in ctx['planar_outputs'] (the v4
    pipeline then finishes with frame.postprocess_planar), NCHW otherwise."""
    img_m, flow_m, img_i, flow_i, mask = inputs
    planar = node.tops[0] in ctx.get("planar_outputs", ())
    if _pair_ok(node, img_m, img_i, flow_m, flow_i, ctx):
        img_m, flow_m, img_i, flow_i = _pair_inputs(node, inputs[:4])
        out = W.warp_render(img_m, flow_m, img_i, flow_i,
                            mask[:, 0].contiguous())
        return [out if planar else out.permute(0, 2, 1, 3)]
    wm = _single(node, img_m, flow_m, node.bottoms[0], ctx, ds4=False)
    wi = _single(node, img_i, flow_i, node.bottoms[2], ctx, ds4=False)
    out = wm * mask + wi * (1 - mask)
    return [out.permute(0, 2, 1, 3) if planar else out]


OP_TABLE = {
    "Convolution": _op_convolution,
    "ConvolutionCat": _op_convolution_cat,
    "Deconvolution": _op_deconvolution,
    "InnerProduct": _op_innerproduct,
    "Pooling": _op_pooling,
    "UnaryOp": _op_unaryop,
    "rife.ConvPS": _op_conv_ps,
    "rife.DeconvPS": _op_conv_ps,
    "PixelShuffle": _op_pixelshuffle,
    "Interp": _op_interp,
    "Concat": _op_concat,
    "Crop": _op_crop,
    "Slice": _op_slice,
    "Split": _op_split,
    "PReLU": _op_prelu,
    "ReLU": _op_relu,
    "Clip": _op_clip,
    "BinaryOp": _op_binaryop,
    "Eltwise": _op_eltwise,
    "Sigmoid": _op_sigmoid,
    "rife.Warp": _op_warp,
    "rife.WarpDs4": _op_warp_ds4,
    "rife.WarpDs2": _op_warp_ds2,
    "rife.WarpPair": _op_warp_pair,
    "rife.WarpDs4Pair": _op_warp_ds4_pair,
    "rife.RenderBlend": _op_render_blend,
}


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

_CONV_KINDS = ("Convolution", "ConvolutionCat", "rife.ConvPS")
_DECONV_KINDS = ("Deconvolution", "rife.DeconvPS")


def _tensor(a, dtype, device):
    return None if a is None else torch.from_numpy(
        np.array(a, np.float32)).to(device=device, dtype=dtype)


def _entry(node, weight, bias, slope, dtype, device) -> Dict[str, torch.Tensor]:
    """One conv's tensors: ``weight``, ``bias`` and the (1,C,1,1) ``slope``
    in the storage dtype for the cuDNN sites (the XLA form); ``bias_f32``
    and the per-channel ``slope_f32`` for the ``conv3x3`` sites (the
    planar kernels' form) and, for a 3x3 conv, ``weight_tc``, the weights
    packed once for the tensor-core kernel (``ops/conv.py``
    ``pack_weight_tc``); ``bias_q`` / ``slope_q``, the storage-dtype bias
    and per-channel slope as float32 (what the kernels that keep the XLA
    order read: the epilogue kernel ``bias_act`` and the deconv kernel);
    for a 4x4 stride-2 pad-1 Deconvolution (or ``rife.DeconvPS``)
    ``weight_t4``, the weights packed once for the deconv kernel
    (``pack_weight_t4``); where the gates can send it to the planar route,
    also its phase weights and the 4x tiled f32 bias and slope
    (``deconv_phase_weights``: the twin's and the f32 kernel's form)."""
    out_ch = weight.shape[1] if node.type in _DECONV_KINDS else weight.shape[0]
    e = {"weight": _tensor(weight, dtype, device),
         "bias": _tensor(bias, dtype, device)}
    if node.type in _CONV_KINDS and tuple(weight.shape[2:]) == (3, 3):
        e["weight_tc"] = CV.pack_weight_tc(e["weight"])
    bias_f32 = None if bias is None else np.asarray(bias, np.float32)
    e["bias_f32"] = _tensor(bias_f32, torch.float32, device)
    slope_f32 = None
    if slope is not None:
        slope_f32 = np.broadcast_to(np.asarray(slope, np.float32).reshape(-1),
                                    (out_ch,))
        e["slope"] = _tensor(np.asarray(slope, np.float32).reshape(1, -1, 1, 1),
                             dtype, device)
        e["slope_f32"] = _tensor(slope_f32, torch.float32, device)
    if bias is not None:
        e["bias_q"] = e["bias"].float()
    if slope is not None:
        e["slope_q"] = e["slope_f32"].to(dtype).float()
    if node.type in _DECONV_KINDS and CV.is_deconv4x4(node):
        e["weight_t4"] = CV.pack_weight_t4(e["weight"])
        _, k, _, stride, pad, _ = C.conv_hyperparams(node)
        if CV.planar_deconv_ok(weight.shape[0], out_ch, k, stride, pad):
            w3 = CV.deconv_phase_weights(torch.from_numpy(
                np.array(weight, np.float32)))
            e["phase_weight"] = w3.to(device=device, dtype=dtype)
            tile = lambda a: None if a is None else np.tile(a, 4)  # noqa: E731
            e["phase_bias_f32"] = _tensor(tile(bias_f32), torch.float32, device)
            if slope_f32 is not None:
                e["phase_slope_f32"] = _tensor(tile(slope_f32), torch.float32,
                                               device)
    return e


def prepare_weights(graph, raw, dtype=torch.float32, device="cpu"):
    """ncnn-layout numpy weights -> torch tensors (see ``_entry``).

    Convolution keeps ncnn's (O,I,kh,kw) = torch OIHW; Deconvolution keeps
    ncnn's raw (I,O,kh,kw), which ``F.conv_transpose2d`` takes as it is;
    InnerProduct keeps ncnn's (out, in) weight and its bias, and a
    standalone PReLU its slopes, all in the storage dtype."""
    out = {}
    for node in graph.nodes:
        lw = raw.get(node.name)
        if lw is None:
            continue
        if node.type in _CONV_KINDS + _DECONV_KINDS:
            out[node.name] = _entry(node, lw.weight, lw.bias, lw.slope, dtype,
                                    device)
        elif node.type == "InnerProduct":
            out[node.name] = {"weight": _tensor(lw.weight, dtype, device),
                              "bias": _tensor(lw.bias, dtype, device)}
        elif node.type == "PReLU":
            out[node.name] = {"slope": _tensor(lw.slope, dtype, device)}
    return out


def weights_on(weights, device):
    """A session's prepared weights ({net: {node: {name: tensor}}}) on
    ``device``."""
    return {net: {node: {k: None if t is None else t.to(device)
                         for k, t in entry.items()}
                  for node, entry in nodes.items()}
            for net, nodes in weights.items()}
