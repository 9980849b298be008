"""The planar conv sites: the ``conv3x3`` kernel's wrapper, plain twin and
launch counter, the deconv phase decomposition, and jax-free copies of the
gates that send a site to the kernel.

``conv3x3`` (``rife_tpu_torch/csrc/conv.cu``) computes what the Pallas
planar convs of ``rife_tpu/ops/conv_planar.py`` compute: a 3x3 pad-1 conv,
stride 1 or 2, over the channel concat of 1-4 input parts (the concat is
never built), f32 accumulation, then the f32 bias, the activation (none,
ReLU, leaky(alpha) or per-channel PReLU) in f32, and ONE rounding to the
storage dtype (``conv_planar.py:56-63,93-94``).  It replaces
``_conv_planar_s1_direct`` (K11) and ``_conv_planar_s2_direct_cat`` (K12);
``conv_planar_bhcw`` (K9) and ``conv_s2_bhcw`` (K10) compute the same
functions and are covered by it.  Both dtypes read weights packed once per
model (``pack_weight_tc``: (9, Cout, Cin padded to 16)): bf16 on the tensor
cores, f32 on the FP32 pipes (``conv3x3_f32_kernel``, which plans its own
launch: ``csrc/conv_f32_plan.h``; each output's sum in the order of the
kernel it replaced, so bit for bit with it).  Its PixelShuffle(2) form
(B4's conv form, ``conv_ps_planar``: ``conv3x3(..., ps=2)``) runs in bf16
on a kernel of its own (``rife_tpu_torch/csrc/conv_ps.cu``, over the same
packed weights and the tile geometry of ``ps_geometry``), which writes the
shuffled output; in f32 the f32 kernel, then ``F.pixel_shuffle``.  ``deconv4x4`` runs the 4x4
stride-2 transposed conv of the planar deconv sites: in bf16 on the card
the deconv kernel (``rife_tpu_torch/csrc/deconv.cu``: four taps per output
phase, over weights packed once per model by ``pack_weight_t4``), which
writes the interleaved (and shuffled) output itself; in f32 on the card the
f32 kernel's deconv mode over the same ``pack_weight_t4`` weights (four
taps per phase, the interleaved output written by the kernel; with ``ps``
2 then ``F.pixel_shuffle``); in its twin as ``conv_planar.deconv_planar``
does it: one stride-1 conv producing the four output phases on its output
channels (``deconv_phase_weights``), then a plain reshape/permute
(``interleave_phases``).  ``deconv4x4_xla`` runs the same kernel at every
other bf16 4x4 stride-2 pad-1 deconv site on the card (v4.6's
``rife.DeconvPS``, the planar nets' deconvs under the gates) in XLA's
order (below); ``deconv_route`` decides which site takes which.

Numeric trap (ROADMAP queue C): the XLA conv that the JAX package runs off
these sites rounds the conv result to the storage dtype BEFORE it adds the
bias (``jax_ops.conv2d``); the planar kernel adds the f32 bias before its
single rounding.  The cuDNN sites of ``torch_ops`` keep the XLA form, the
kernel sites this one; in f32 the two agree.  ``deconv4x4_xla`` keeps the
XLA form on the kernel: the sum rounded to bf16, then the bf16 bias, then
the activation in bf16 (what cuDNN's bf16 ``conv_transpose2d`` followed by
PyTorch's bias add computed at those sites before).

Gates (``planar_ops.py:63-102,146-158``): exactly the sites that the TPU's
planar executor (the default for the v1/v2/v3 nets) sends to K11/K12.
``torch_ops`` consults them only for nets run as planar on the TPU
(ctx ``planar``); ``CONV_MIN_HW`` / ``DECONV_MIN_HW`` are the input-size
thresholds (ctx ``planar_min_hw`` / ``planar_deconv_min_hw`` override them,
``planar_all`` lifts them, as in ``planar_ops``).

The library sites (every conv and deconv the kernels above do not take:
``F.conv2d`` / ``F.conv_transpose2d``, cuDNN on the card) take their bias and
activation on the card from ``bias_act`` (``rife_tpu_torch/csrc/bias_act.cu``):
one in-place pass over the conv's output, in the XLA order, bit for bit with
the library's bias add followed by ``torch_ops.apply_activation``
(``epilogue_on_kernel``; the CPU keeps the library's bias and the eager
activation).

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches the kernel or
raises (nothing falls back to another kernel or to the twin); a meta tensor
takes the kernel's branch and launches nothing (``ops/launch.py``).
``LAUNCHES`` counts kernel launches: ``conv3x3`` the conv kernels',
``conv3x3_ps`` B4's conv kernel's (and an f32 shuffled conv's),
``deconv4x4`` the deconv kernel's (both of its wrappers, every order and
shuffle), ``bias_act`` the epilogue kernel's.  Each conv launch gives the
plan its site: (batch, part channels, cout, stride, activation code, H, W,
deconv) for ``conv3x3`` / ``conv3x3_ps`` (a deconv site's cout counts its
four output phases), (batch, (cin,), O, PixelShuffle factor, activation
code, H, W, XLA order) for ``deconv4x4``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import common as C
from . import launch as L

LAUNCHES = {"conv3x3": 0, "conv3x3_ps": 0, "deconv4x4": 0, "bias_act": 0}

CONV_MIN_HW = 400_000
DECONV_MIN_HW = 25_000
MAX_PARTS = 4

# kernel activation codes, as conv_planar's
ACT_NONE, ACT_RELU, ACT_LEAKY, ACT_PRELU = 0, 1, 2, 3
ACT_MAP = {C.ACT_NONE: ACT_NONE, C.ACT_RELU: ACT_RELU,
           C.ACT_LEAKY: ACT_LEAKY, C.ACT_PRELU_CH: ACT_PRELU}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# gates (copies of rife_tpu/ops/planar_ops.py's, without jax)
# ---------------------------------------------------------------------------

def planar_conv_ok(cin, cout, h, w, stride, k, dilation, pad) -> bool:
    if dilation != 1 or k != 3 or pad != 1 or stride not in (1, 2):
        return False
    if stride == 2 and (h % 2 or w % 2):
        return False
    return min(cin, cout) <= 32 and max(cin, cout) <= 64


def planar_deconv_ok(cin, cout, k, stride, pad) -> bool:
    if (k, stride, pad) != (4, 2, 1):
        return False
    return cout <= 24 or (cout <= 32 and cin <= 48)


def _big(h, w, ctx, key, default) -> bool:
    return bool(ctx.get("planar_all")) or h * w >= int(ctx.get(key, default))


def conv_wants_planar(node, h, w, cin, cout, ctx) -> bool:
    act, _ = C.activation_of(node)
    if act not in ACT_MAP:
        return False
    _, k, dilation, stride, pad, _ = C.conv_hyperparams(node)
    return (_big(h, w, ctx, "planar_min_hw", CONV_MIN_HW)
            and planar_conv_ok(cin, cout, h, w, stride, k, dilation, pad))


def cat_conv_wants_planar(node, h, w, cin, cout, n_parts, ctx) -> bool:
    """``ConvolutionCat``: the plain gate, or (more than one part) the wider
    stride-2 gate up to 128 channels; only stride 2 takes the multi-part
    kernel (``planar_ops._op_convolution_cat``)."""
    _, k, dilation, stride, pad, _ = C.conv_hyperparams(node)
    act, _ = C.activation_of(node)
    wants = conv_wants_planar(node, h, w, cin, cout, ctx)
    if not wants and act in ACT_MAP and n_parts > 1:
        wants = (_big(h, w, ctx, "planar_min_hw", CONV_MIN_HW)
                 and dilation == 1 and k == 3 and pad == 1 and stride == 2
                 and not (h % 2 or w % 2) and max(cin, cout) <= 128)
    return stride == 2 and wants


def deconv_wants_planar(node, h, w, cin, cout, ctx) -> bool:
    act, _ = C.activation_of(node)
    if act not in ACT_MAP:
        return False
    _, k, _, stride, pad, _ = C.conv_hyperparams(node)
    return (_big(h, w, ctx, "planar_deconv_min_hw", DECONV_MIN_HW)
            and planar_deconv_ok(cin, cout, k, stride, pad))


def is_deconv4x4(node) -> bool:
    """A 4x4 stride-2 pad-1 transposed conv without dilation: the function
    of the deconv kernel."""
    _, k, dilation, stride, pad, _ = C.conv_hyperparams(node)
    return (k, dilation, stride, pad) == (4, 1, 2, 1)


def deconv_on_kernel(device, dtype) -> bool:
    """Whether the 4x4 stride-2 deconv sites of a run on ``device`` in
    ``dtype`` take the deconv kernel: bf16 on the card.  f32 runs keep the
    routes that meet the f32 bar (the planar sites the f32 conv kernel's
    deconv mode, the others cuDNN with TF32 off), and the CPU its twins."""
    return L.on_card(device) and dtype == torch.bfloat16


def deconv_route(node, h, w, cin, cout, ctx, device, dtype) -> str:
    """The route of a ``Deconvolution`` / ``rife.DeconvPS`` site: "planar"
    where the planar gates take it (``deconv4x4``: f32 bias, one rounding;
    the deconv kernel in bf16 on the card), "xla" for every other 4x4
    stride-2 pad-1 site of a bf16 run on the card (``deconv4x4_xla``: the
    kernel in XLA's rounding order), else "library" (``F.conv_transpose2d``:
    cuDNN, or oneDNN on the CPU).  Decided before a launch: the kernel raises
    on what it cannot take (an activation outside ``ACT_MAP``) and nothing
    falls back."""
    if ctx.get("planar_convs") and deconv_wants_planar(node, h, w, cin, cout,
                                                       ctx):
        return "planar"
    if is_deconv4x4(node) and deconv_on_kernel(device, dtype):
        return "xla"
    return "library"


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def full_f32():
    """f32 convs and matmuls in f32 while it runs (cuDNN convs run in TF32
    by default on Hopper, and a matmul may be set to); the twins and the
    calibration (``models/calibrate.py``) are f32."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def activate_f32(y: torch.Tensor, act: int, alpha: float, slope):
    """The planar kernels' ``_apply_act`` on an f32 (B,C,H,W) tensor."""
    if act == ACT_RELU:
        return torch.clamp_min(y, 0.0)
    if act == ACT_LEAKY:
        return torch.where(y >= 0, y, y * alpha)
    if act == ACT_PRELU:
        return torch.where(y >= 0, y, y * slope.float().reshape(1, -1, 1, 1))
    if act != ACT_NONE:
        raise ValueError(f"activation code {act}")
    return y


def conv3x3_ref(parts, weight, bias=None, slope=None, *, stride=1,
                act=ACT_NONE, alpha=0.2, ps=1):
    """Twin of the kernel: ``F.conv2d`` on f32 copies of the concat (TF32
    off), then + f32 bias, the activation in f32 and one cast to the
    storage dtype of ``parts``; with ``ps`` > 1, ``F.pixel_shuffle`` of
    that."""
    x = torch.cat([p.float() for p in parts], dim=1)
    with full_f32():
        y = F.conv2d(x, weight.float(), None, stride=stride, padding=1)
    if bias is not None:
        y = y + bias.float().reshape(1, -1, 1, 1)
    y = activate_f32(y, act, alpha, slope).to(parts[0].dtype)
    return F.pixel_shuffle(y, ps) if ps > 1 else y


def deconv_phase_weights(weight: torch.Tensor) -> torch.Tensor:
    """ncnn ConvTranspose 4x4 s2 p1 weights (I,O,4,4) -> one 3x3 s1 p1 conv
    (4*O, I, 3, 3) whose output channel (py*2+px)*O + o is output phase
    (py, px) of channel o (port of ``conv_planar._deconv_phase_weights``).

    Per axis, even output 2m reads (x[m-1], x[m]) with raw taps (3, 1) and
    odd output 2m+1 reads (x[m], x[m+1]) with raw taps (2, 0): on the 3-tap
    window (x[m-1], x[m], x[m+1]) the taps are (3, 1, -) and (-, 2, 0)."""
    cin, co = weight.shape[0], weight.shape[1]
    taps = {0: {0: 3, 1: 1}, 1: {1: 2, 2: 0}}  # parity -> {3-tap: raw tap}
    w3 = weight.new_zeros((4 * co, cin, 3, 3))
    for py, rows in taps.items():
        for px, cols in taps.items():
            blk = slice((py * 2 + px) * co, (py * 2 + px + 1) * co)
            for ry, a in rows.items():
                for rx, b in cols.items():
                    w3[blk, :, ry, rx] = weight[:, :, a, b].t()
    return w3


def interleave_phases(y4: torch.Tensor) -> torch.Tensor:
    """(B, 4*O, H, W) phase channels -> (B, O, 2H, 2W)."""
    b, c4, h, w = y4.shape
    co = c4 // 4
    y = y4.reshape(b, 2, 2, co, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, co, 2 * h, 2 * w)


def deconv4x4_ref(x, phase_weight, phase_bias=None, phase_slope=None, *,
                  act=ACT_NONE, alpha=0.2, ps=1):
    """Twin of the kernel's deconv form: ``conv3x3_ref`` over the phase
    weights, then ``interleave_phases`` (the kernel writes each phase to its
    interleaved place itself); with ``ps`` > 1, ``F.pixel_shuffle`` of
    that."""
    y4 = conv3x3_ref([x], phase_weight, phase_bias, phase_slope, stride=1,
                     act=act, alpha=alpha)
    y = interleave_phases(y4)
    return F.pixel_shuffle(y, ps) if ps > 1 else y


# (row of the packed layout, raw ky, raw kx) of each tap: output phase
# (py, px) applies raw tap (3-py-2ry, 3-px-2rx) to input pixel (m+py+ry-1,
# n+px+rx-1); rows phase by phase, in the 3x3 window's (row, column) order
_T4_TAPS = [((py * 2 + px) * 4 + ry * 2 + rx, 3 - py - 2 * ry,
             3 - px - 2 * rx)
            for py in (0, 1) for px in (0, 1)
            for ry in (0, 1) for rx in (0, 1)]


def pack_weight_t4(weight: torch.Tensor) -> torch.Tensor:
    """ncnn ConvTranspose 4x4 s2 p1 weights (I, O, 4, 4) -> the deconv
    kernel's layout (16, O, Cp) (``_T4_TAPS``): the 16 rows are the nonzero
    taps of ``deconv_phase_weights``; input channels zero-padded to
    ``padded_cin``; contiguous, same dtype and device."""
    cin, co = weight.shape[0], weight.shape[1]
    packed = weight.new_zeros((16, co, padded_cin(cin)))
    for row, ky, kx in _T4_TAPS:
        packed[row, :, :cin] = weight[:, :, ky, kx].t()
    return packed


def unpack_weight_t4(packed: torch.Tensor, cin: int) -> torch.Tensor:
    """Inverse of ``pack_weight_t4``: (16, O, Cp) -> (cin, O, 4, 4)."""
    weight = packed.new_zeros((cin, packed.shape[1], 4, 4))
    for row, ky, kx in _T4_TAPS:
        weight[:, :, ky, kx] = packed[row, :, :cin].t()
    return weight


def activate_storage(y: torch.Tensor, act: int, alpha: float, slope):
    """The activation in the storage dtype, as ``torch_ops`` applies it at a
    cuDNN site (``apply_activation``): the leaky factor rounded to that
    dtype, each negative product rounded once."""
    if act == ACT_RELU:
        return torch.clamp_min(y, 0)
    if act == ACT_LEAKY:
        return torch.where(y >= 0, y, y * torch.tensor(alpha, dtype=y.dtype))
    if act == ACT_PRELU:
        return torch.where(y >= 0, y, y * slope.to(y.dtype).reshape(
            1, -1, 1, 1))
    if act != ACT_NONE:
        raise ValueError(f"activation code {act}")
    return y


@functools.lru_cache(maxsize=None)
def _in_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``: the leaky slope the kernels that keep
    the XLA order multiply by."""
    return float(torch.tensor(v, dtype=dtype))


def deconv4x4_xla_ref(x, weight, bias=None, slope=None, *, act=ACT_NONE,
                      alpha=0.2, ps=1):
    """Twin of the deconv kernel in XLA's order (``jax_ops.deconv2d`` +
    ``_conv_act``): ``F.conv_transpose2d`` on f32 copies of ``x`` and the raw
    (I, O, 4, 4) ``weight`` (TF32 off), rounded to ``x``'s dtype, then the
    bias in that dtype, the activation in it (``activate_storage``) and,
    with ``ps`` > 1, ``F.pixel_shuffle``.  ``bias`` / ``slope`` (O,) in any
    float dtype, rounded to ``x``'s first."""
    with full_f32():
        y = F.conv_transpose2d(x.float(), weight.float(), None, stride=2,
                               padding=1)
    y = y.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype).reshape(1, -1, 1, 1)
    y = activate_storage(y, act, alpha, slope)
    return F.pixel_shuffle(y, ps) if ps > 1 else y


def deconv_t4_ref(x, weight_t4, bias=None, slope=None, *, act=ACT_NONE,
                  alpha=0.2, ps=1, xla=False):
    """Twin of the deconv kernel over its packed weights: unpacked, then
    ``deconv4x4_ref`` over the phase weights with the bias and slope tiled
    4x (``xla`` False: f32 bias, one rounding), or ``deconv4x4_xla_ref``."""
    raw = unpack_weight_t4(weight_t4, x.shape[1])
    if xla:
        return deconv4x4_xla_ref(x, raw, bias, slope, act=act, alpha=alpha,
                                 ps=ps)
    tile = (lambda t: None if t is None  # noqa: E731
            else t.float().reshape(-1).repeat(4))
    return deconv4x4_ref(x, deconv_phase_weights(raw), tile(bias),
                         tile(slope), act=act, alpha=alpha, ps=ps)


def padded_cin(cin: int) -> int:
    """Input channels of the packed layout: ``cin`` rounded up to 16, the k
    depth of one tensor-core step."""
    return (cin + 15) // 16 * 16


def pack_weight_tc(weight: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> the tensor-core kernel's layout (9, Cout,
    Cp): tap ky*3+kx, output channel, input channel zero-padded to
    ``padded_cin``; contiguous, same dtype and device."""
    cout, cin = weight.shape[0], weight.shape[1]
    packed = weight.new_zeros((9, cout, padded_cin(cin)))
    packed[:, :, :cin] = weight.permute(2, 3, 0, 1).reshape(9, cout, cin)
    return packed


def unpack_weight_tc(packed: torch.Tensor, cin: int) -> torch.Tensor:
    """Inverse of ``pack_weight_tc``: (9, Cout, Cp) -> (Cout, cin, 3, 3)."""
    cout = packed.shape[1]
    return packed[:, :, :cin].reshape(3, 3, cout, cin).permute(
        2, 3, 0, 1).contiguous()


def conv3x3_packed_ref(parts, weight_tc, bias=None, slope=None, *, stride=1,
                       act=ACT_NONE, alpha=0.2):
    """Twin over the packed layout: unpack, then ``conv3x3_ref``."""
    cin = sum(p.shape[1] for p in parts)
    return conv3x3_ref(parts, unpack_weight_tc(weight_tc, cin), bias, slope,
                       stride=stride, act=act, alpha=alpha)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

def _check(parts, weight, bias, slope, stride, act, weight_tc=None,
           packed=True):
    """Validate a launch's operands (``packed``: it reads ``weight_tc``);
    returns (B, H, W, Cout)."""
    ref = parts[0]
    if ref.device.type not in ("cuda", "meta"):
        raise ValueError(f"conv3x3 takes CUDA or CPU tensors, got {ref.device}")
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3 takes float32 or bfloat16, got {ref.dtype}")
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"conv3x3 takes 1-{MAX_PARTS} parts, got {len(parts)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if ref.dim() != 4:
        raise ValueError(f"parts must be (B,C,H,W), got {tuple(ref.shape)}")
    b, _, h, w = ref.shape
    for t in parts:
        if t.dim() != 4 or (t.shape[0], t.shape[2], t.shape[3]) != (b, h, w):
            raise ValueError(f"part {tuple(t.shape)} does not match "
                             f"{tuple(ref.shape)}")
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"part on {t.device}/{t.dtype}, expected "
                             f"{ref.device}/{ref.dtype}")
        if not t.is_contiguous():
            raise ValueError("parts must be contiguous NCHW")
    cin = sum(t.shape[1] for t in parts)
    cout = weight.shape[0]
    if (tuple(weight.shape) != (cout, cin, 3, 3) or weight.dtype != ref.dtype
            or weight.device != ref.device or not weight.is_contiguous()):
        raise ValueError(f"weight must be contiguous ({cout}, {cin}, 3, 3) "
                         f"{ref.dtype} on {ref.device}, got "
                         f"{tuple(weight.shape)} {weight.dtype}")
    if packed and weight_tc is None:
        raise ValueError("a launch takes weight_tc (pack_weight_tc)")
    if weight_tc is not None and (
            tuple(weight_tc.shape) != (9, cout, padded_cin(cin))
            or weight_tc.dtype != ref.dtype or weight_tc.device != ref.device
            or not weight_tc.is_contiguous()):
        raise ValueError(f"weight_tc must be contiguous (9, {cout}, "
                         f"{padded_cin(cin)}) {ref.dtype} on {ref.device}, "
                         f"got {tuple(weight_tc.shape)} {weight_tc.dtype}")
    for what, t in (("bias", bias), ("slope", slope)):
        if t is None:
            continue
        if (tuple(t.shape) != (cout,) or t.dtype != torch.float32
                or t.device != ref.device or not t.is_contiguous()):
            raise ValueError(f"{what} must be contiguous float32 ({cout},) on "
                             f"{ref.device}, got {tuple(t.shape)} {t.dtype}")
    if act == ACT_PRELU and slope is None:
        raise ValueError("PReLU needs a slope")
    if act not in (ACT_NONE, ACT_RELU, ACT_LEAKY, ACT_PRELU):
        raise ValueError(f"activation code {act}")
    return b, h, w, cout


def _launch(parts, weight, bias, slope, out, stride, act, alpha, weight_tc,
            ps=1):
    """One launch over ``weight_tc`` (the packed weights) that writes the
    plain result: the tensor-core kernel for bf16, the f32 kernel for
    f32.  It counts as ``conv3x3_ps`` when ``ps`` > 1 (the caller
    shuffles), else as ``conv3x3``."""
    b, h, w = parts[0].shape[0], parts[0].shape[2], parts[0].shape[3]
    cout = weight.shape[0]
    padded = parts + [None] * (MAX_PARTS - len(parts))
    chans = [0 if t is None else t.shape[1] for t in padded]
    device = parts[0].device
    common = (*map(L.ptr, padded), *chans, L.ptr(weight_tc),
              weight_tc.shape[2], L.ptr(bias), L.ptr(slope), L.ptr(out), b, h,
              w, cout, stride, act, ctypes.c_float(alpha))
    if parts[0].dtype == torch.bfloat16:
        L.launch("rife_conv3x3_tc", device, *common)
    else:
        L.launch("rife_conv3x3", device, *common, 0)
    L.count(LAUNCHES, "conv3x3_ps" if ps > 1 else "conv3x3",
            (b, tuple(chans[:len(parts)]), cout, stride, act, h, w, False))


def _check_ps(ps, channels):
    if ps < 1 or channels % (ps * ps):
        raise ValueError(f"PixelShuffle({ps}) of {channels} channels")


# B4's conv form on the card (csrc/conv_ps.cu): its limits and the geometry
# the kernel reads
PS_MAX_CHANNELS = 64     # Cin and Cout
PS_TILE_COLS = 64        # conv columns of a tile
PS_CHUNK = 16            # input channels of a stage
PS_RAW_PX = 80           # pixels of a staged row: columns x0 - 8 .. x0 + 71
PS_ROW_BYTES = PS_RAW_PX * PS_CHUNK * 2  # a staged row as TMA lands it
PS_T_ROW = 32 * PS_CHUNK * 2  # a warp's transposed row: 32 pixels x 16
PS_OUT_LINE = 64         # bytes of a warp's output line (32 bf16)
PS_CONSUMER_WARPS = 8
PS_WEIGHT_ROW = 24       # bf16 of a staged weight row (16 + skew)
SMEM_OPTIN = 232_448     # H100 shared memory a block may opt in to


class PsGeometry(NamedTuple):
    """What ``conv3x3_ps_kernel`` reads of a launch: ``nt`` n8 tiles of
    output channels, tiles of ``tile_rows`` conv rows x ``PS_TILE_COLS``
    columns, each a window of ``box_rows`` input rows of ``PS_RAW_PX``
    pixels a 16-channel chunk (at stride 2 twice: the even and the odd
    columns), a ring of ``stages``; each of the 8 consumer warps (two row
    groups of tile_rows / 2 rows x four groups of 16 columns) transposes
    its window of each stage and writes its output tile, ``out_bytes``,
    twice buffered; ``tma_in`` / ``tma_out``: TMA (else the per-thread
    branch) for the input rows and the output tiles."""
    nt: int
    tile_rows: int
    box_rows: int
    chunks: int
    tiles_x: int
    tiles_y: int
    n_tiles: int
    stages: int
    out_bytes: int
    smem_bytes: int
    tma_in: bool
    tma_out: bool


def ps_geometry(b, cin, cout, h, w, stride, smem_optin=SMEM_OPTIN):
    """The geometry of one ``conv3x3_ps_kernel`` launch (``csrc/conv_ps.cu``
    ``PsTile`` and ``launch_ps`` check it): NT = ceil(Cout / 8) rounded up
    to 1, 2, 4 or 8; tile rows 16 / NT within [2, 8] at stride 1, so that
    the accumulators (rows / 2 x NT x 4 a thread) and the output tile keep
    their size, and 2 at stride 2; as many stages (2 to 4) as fit in
    ``smem_optin``.  TMA stages the input at stride 1 with W % 8 == 0
    (16-byte row strides; a TMA box has no element stride along its inner
    dimension) and writes the output where 2 Wo % 8 == 0."""
    if not (0 < cin <= PS_MAX_CHANNELS and 0 < cout <= PS_MAX_CHANNELS
            and cout % 4 == 0 and stride in (1, 2)):
        raise ValueError(f"B4's conv kernel takes Cin, Cout <= "
                         f"{PS_MAX_CHANNELS}, Cout a multiple of 4 and "
                         f"stride 1 or 2, got {cin} -> {cout}, stride "
                         f"{stride}")
    n8 = -(-cout // 8)
    nt = n8 if n8 <= 2 else (4 if n8 <= 4 else 8)
    tile_rows = max(2, min(8, 16 // nt)) if stride == 1 else 2
    box_rows = (tile_rows - 1) * stride + 3
    chunks = -(-cin // PS_CHUNK)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    tiles_x = -(-wo // PS_TILE_COLS)
    tiles_y = -(-ho // tile_rows)
    stage = stride * box_rows * PS_ROW_BYTES
    r = tile_rows // 2
    window = stride * ((r - 1) * stride + 3) * PS_T_ROW
    out = -(-(cout // 4) * 2 * r * PS_OUT_LINE // 128) * 128
    weights = chunks * 9 * nt * 8 * PS_WEIGHT_ROW * 2

    def smem(stages):
        return (128 + stages * stage
                + PS_CONSUMER_WARPS * (window + 2 * out) + weights
                + 16 * stages)
    stages = next((n for n in (4, 3) if smem(n) <= smem_optin), 2)
    return PsGeometry(nt, tile_rows, box_rows, chunks, tiles_x, tiles_y,
                      b * tiles_x * tiles_y, stages, out, smem(stages),
                      stride == 1 and w % 8 == 0, wo % 4 == 0)


def _launch_ps(parts, weight, weight_tc, bias, slope, stride, act, alpha,
               ps):
    """B4's conv form in bf16 on the card: one launch of the conv + shuffle
    kernel (``rife_conv3x3_ps``); counts as ``conv3x3_ps``.  Raises on what
    the kernel does not take."""
    b, h, w, cout = _check(parts, weight, bias, slope, stride, act, weight_tc)
    if ps != 2:
        raise ValueError(f"B4's conv kernel shuffles by 2, got {ps}")
    if len(parts) != 1:
        raise ValueError(f"B4's conv kernel takes one input part, got "
                         f"{len(parts)}")
    x = parts[0]
    for what, t in (("x", x), ("weight_tc", weight_tc)):
        if t.data_ptr() % 16:
            raise ValueError(f"B4's conv kernel needs a 16-byte aligned "
                             f"{what}")
    geo = ps_geometry(b, x.shape[1], cout, h, w, stride)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = x.new_empty((b, cout // 4, 2 * ho, 2 * wo))
    L.launch("rife_conv3x3_ps", x.device, L.ptr(x), x.shape[1],
             L.ptr(weight_tc), weight_tc.shape[2], L.ptr(bias), L.ptr(slope),
             L.ptr(out), b, h, w, cout, stride, act, ctypes.c_float(alpha),
             geo.tile_rows, geo.stages, int(geo.tma_in), int(geo.tma_out))
    L.count(LAUNCHES, "conv3x3_ps",
            (b, (x.shape[1],), cout, stride, act, h, w, False))
    return out


def conv3x3(parts, weight, bias=None, slope=None, *, stride=1, act=ACT_NONE,
            alpha=0.2, weight_tc=None, ps=1):
    """The kernel on CUDA, its twin on the CPU.  ``parts``: 1-4 (B,Ci,H,W)
    tensors whose channel concat is the input; ``weight`` (Cout, sum Ci, 3,
    3) in their dtype; ``weight_tc`` the same weights packed once
    (``pack_weight_tc``), which a bf16 launch reads and needs;
    ``bias``/``slope`` (Cout,) float32 or None.  Returns (B, Cout, Ho, Wo)
    in the parts' dtype; with ``ps`` > 1 (B4, ``rife.ConvPS``) its
    PixelShuffle(ps), (B, Cout/ps^2, ps*Ho, ps*Wo): in bf16 one launch of
    B4's conv kernel (one part, ``ps`` 2, Cin and Cout <= 64; it writes each
    conv channel 4c + 2i + j of pixel (y, x) to (c, 2y + i, 2x + j)), in f32
    the f32 kernel (it reads ``weight_tc`` too), then ``F.pixel_shuffle``."""
    parts = list(parts)
    if parts[0].device.type == "cpu":
        return conv3x3_ref(parts, weight, bias, slope, stride=stride, act=act,
                           alpha=alpha, ps=ps)
    if ps > 1 and parts[0].dtype == torch.bfloat16:
        return _launch_ps(parts, weight, weight_tc, bias, slope, stride, act,
                          alpha, ps)
    b, h, w, cout = _check(parts, weight, bias, slope, stride, act, weight_tc)
    _check_ps(ps, cout)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = parts[0].new_empty((b, cout, ho, wo))
    _launch(parts, weight, bias, slope, out, stride, act, alpha, weight_tc,
            ps=ps)
    return F.pixel_shuffle(out, ps) if ps > 1 else out


def _check_deconv(x, weight_t4, bias, slope, act, ps):
    """Validate the deconv kernel's operands; returns (B, H, W, O)."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"the deconv kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the deconv kernel runs bf16 (f32 sites keep their "
                        f"routes), got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (B,C,H,W), got "
                         f"{tuple(x.shape)}")
    b, cin, h, w = x.shape
    if (weight_t4 is None or weight_t4.dim() != 3
            or tuple(weight_t4.shape[::2]) != (16, padded_cin(cin))
            or weight_t4.dtype != x.dtype or weight_t4.device != x.device
            or not weight_t4.is_contiguous() or weight_t4.data_ptr() % 16):
        got = None if weight_t4 is None else tuple(weight_t4.shape)
        raise ValueError(f"weight_t4 must be contiguous, 16-byte aligned "
                         f"(16, O, {padded_cin(cin)}) {x.dtype} on {x.device} "
                         f"(pack_weight_t4), got {got}")
    cout = weight_t4.shape[1]
    for what, t in (("bias", bias), ("slope", slope)):
        if t is None:
            continue
        if (t.dim() != 1 or t.shape[0] < cout or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{what} must be contiguous float32 with at "
                             f"least {cout} values on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if act == ACT_PRELU and slope is None:
        raise ValueError("PReLU needs a slope")
    if act not in (ACT_NONE, ACT_RELU, ACT_LEAKY, ACT_PRELU):
        raise ValueError(f"activation code {act}")
    if ps not in (1, 2):
        raise ValueError(f"the deconv kernel shuffles by 2 or not at all, "
                         f"got {ps}")
    _check_ps(ps, cout)
    return b, h, w, cout


def _launch_deconv(x, weight_t4, bias, slope, act, alpha, ps, xla):
    """One launch of the deconv kernel; counts as ``deconv4x4``."""
    b, h, w, cout = _check_deconv(x, weight_t4, bias, slope, act, ps)
    out = x.new_empty((b, cout // (ps * ps), 2 * ps * h, 2 * ps * w))
    L.launch("rife_deconv4x4", x.device, L.ptr(x), x.shape[1],
             L.ptr(weight_t4), weight_t4.shape[2], L.ptr(bias), L.ptr(slope),
             L.ptr(out), b, h, w, cout, act, ctypes.c_float(alpha), ps,
             int(xla))
    L.count(LAUNCHES, "deconv4x4",
            (b, (x.shape[1],), cout, ps, act, h, w, xla))
    return out


def deconv4x4(x, phase_weight, phase_bias=None, phase_slope=None, *,
              act=ACT_NONE, alpha=0.2, weight_t4=None, ps=1):
    """A planar deconv site: the 4x4 stride-2 pad-1 transposed conv with the
    f32 bias and activation and one rounding, the phases interleaved into
    (B, O, 2H, 2W); with ``ps`` = 2 (B4, ``rife.DeconvPS``) its
    PixelShuffle(2), (B, O/4, 4H, 4W).  ``phase_bias`` / ``phase_slope``:
    the deconv's (O,) float32 values tiled 4x, as the phase conv takes
    them.  Where ``deconv_on_kernel`` (CUDA bf16): one launch of the deconv
    kernel over ``weight_t4`` (``pack_weight_t4``; it reads the first O
    values of the bias and slope); else (CUDA f32, or a plan's meta tensors
    standing for the CPU): one launch of the f32 kernel's deconv mode over
    ``weight_t4`` (``_launch_deconv_f32``, counted as the CPU's phase
    conv).  The CPU: ``conv3x3``'s twin over the phase weights
    (``deconv_phase_weights``), then ``interleave_phases`` (and
    ``F.pixel_shuffle``): what ``deconv4x4_ref`` computes."""
    if x.device.type == "cpu":
        y = interleave_phases(conv3x3([x], phase_weight, phase_bias,
                                      phase_slope, stride=1, act=act,
                                      alpha=alpha))
        return F.pixel_shuffle(y, ps) if ps > 1 else y
    if deconv_on_kernel(x.device, x.dtype):
        return _launch_deconv(x, weight_t4, phase_bias, phase_slope, act,
                              alpha, ps, xla=False)
    return _launch_deconv_f32(x, phase_weight, phase_bias, phase_slope, act,
                              alpha, weight_t4, ps)


def _launch_deconv_f32(x, phase_weight, phase_bias, phase_slope, act, alpha,
                       weight_t4, ps):
    """A planar deconv site in f32 on the card (on meta, any planar site off
    the deconv kernel): one launch of the f32 kernel in its deconv mode over
    ``weight_t4``, which writes the interleaved (B, O, 2H, 2W) output; with
    ``ps`` = 2 then ``F.pixel_shuffle``.  Counts as ``conv3x3``
    (``conv3x3_ps`` with ``ps`` = 2), as the phase conv it replaced did."""
    b, h, w, cout = _check([x], phase_weight, phase_bias, phase_slope, 1,
                           act, packed=False)
    if cout % 4:
        raise ValueError(f"phase weights need 4*O output channels, got {cout}")
    if ps not in (1, 2):
        raise ValueError(f"deconv4x4 shuffles by 2 or not at all, got {ps}")
    o, cin = cout // 4, x.shape[1]
    _check_ps(ps, o)
    if (weight_t4 is None or tuple(weight_t4.shape) != (16, o, padded_cin(cin))
            or weight_t4.dtype != x.dtype or weight_t4.device != x.device
            or not weight_t4.is_contiguous()):
        got = None if weight_t4 is None else tuple(weight_t4.shape)
        raise ValueError(f"weight_t4 must be contiguous (16, {o}, "
                         f"{padded_cin(cin)}) {x.dtype} on {x.device} "
                         f"(pack_weight_t4), got {got}")
    y = x.new_empty((b, o, 2 * h, 2 * w))
    L.launch("rife_conv3x3", x.device, L.ptr(x), *[L.ptr(None)] * 3, cin, 0,
             0, 0, L.ptr(weight_t4), weight_t4.shape[2], L.ptr(phase_bias),
             L.ptr(phase_slope), L.ptr(y), b, h, w, o, 1, act,
             ctypes.c_float(alpha), 1)
    L.count(LAUNCHES, "conv3x3_ps" if ps > 1 else "conv3x3",
            (b, (cin,), cout, 1, act, h, w, True))
    return F.pixel_shuffle(y, ps) if ps > 1 else y


def deconv4x4_xla(x, weight_t4, bias=None, slope=None, *, act=ACT_NONE,
                  alpha=0.2, ps=1):
    """A 4x4 stride-2 pad-1 deconv site outside the planar gates, in XLA's
    order (``deconv4x4_xla_ref``), with ``ps`` = 2 its PixelShuffle(2):
    CUDA bf16 one launch of the deconv kernel over ``weight_t4``, with
    ``bias``, ``slope`` (float32, bf16 values) and ``alpha`` as the kernel
    applies them in bf16; the CPU its twin (``deconv_t4_ref``, ``xla``);
    anything else raises (the route is taken only where
    ``deconv_on_kernel``)."""
    if x.device.type == "cpu":
        return deconv_t4_ref(x, weight_t4, bias, slope, act=act, alpha=alpha,
                             ps=ps, xla=True)
    return _launch_deconv(x, weight_t4, bias, slope, act,
                          _in_dtype(alpha, torch.bfloat16), ps, xla=True)


# ---------------------------------------------------------------------------
# the library sites' epilogue
# ---------------------------------------------------------------------------

def epilogue_on_kernel(device, act: int, has_bias: bool) -> bool:
    """Whether a library conv site (``F.conv2d`` / ``F.conv_transpose2d``) of
    a run on ``device``, with the fused activation ``act`` (``common``'s
    code) and a bias or none, takes its epilogue from one ``bias_act``
    launch: on the card, where the library adds the bias in a pass of its
    own, for a bias or an activation the kernel takes.  Else the library's
    bias and the eager activation stay (the CPU: oneDNN adds the bias
    inside the conv, in f32)."""
    return (L.on_card(device) and act in ACT_MAP
            and (has_bias or act != C.ACT_NONE))


def bias_act_ref(y, bias=None, slope=None, act=ACT_NONE, alpha=0.2):
    """Twin of the epilogue kernel: the bias in ``y``'s dtype, then the
    activation in it (``activate_storage``), out of place: what PyTorch's
    bias add after the library conv and ``torch_ops.apply_activation``
    compute.  ``bias`` / ``slope`` (C,) in any float dtype, rounded to
    ``y``'s first."""
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1, 1, 1)
    return activate_storage(y, act, alpha, slope)


def _check_bias_act(y, bias, slope, act):
    if y.device.type not in ("cuda", "meta"):
        raise ValueError(f"the epilogue kernel takes CUDA tensors, got "
                         f"{y.device}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the epilogue kernel takes float32 or bfloat16, got "
                        f"{y.dtype}")
    if y.dim() != 4 or not y.is_contiguous() or y.numel() == 0:
        raise ValueError(f"y must be contiguous non-empty (B,C,H,W), got "
                         f"{tuple(y.shape)} strides {y.stride()}")
    c = y.shape[1]
    for what, t in (("bias", bias), ("slope", slope)):
        if t is None:
            continue
        if (tuple(t.shape) != (c,) or t.dtype != torch.float32
                or t.device != y.device or not t.is_contiguous()):
            raise ValueError(f"{what} must be contiguous float32 ({c},) on "
                             f"{y.device}, got {tuple(t.shape)} {t.dtype}")
    if act == ACT_PRELU and slope is None:
        raise ValueError("PReLU needs a slope")
    if act not in (ACT_NONE, ACT_RELU, ACT_LEAKY, ACT_PRELU):
        raise ValueError(f"activation code {act}")
    if act == ACT_NONE and bias is None:
        raise ValueError("nothing to apply: no bias and no activation")


def bias_act(y, bias=None, slope=None, act=ACT_NONE, alpha=0.2):
    """A library conv site's epilogue: ``y`` (B,C,H,W), the conv's output
    without its bias, plus ``bias`` rounded to ``y``'s dtype, then the
    activation (none, ReLU, leaky(``alpha`` rounded to that dtype) or
    per-channel PReLU(``slope``)) in that dtype: ``bias_act_ref``'s bits.
    ``bias`` / ``slope``: (C,) float32 holding values of ``y``'s dtype
    (``torch_ops._entry``'s ``bias_q`` / ``slope_q``).  CUDA: one launch of
    the epilogue kernel, which rewrites ``y`` in place and returns it; the
    CPU: the twin."""
    if y.device.type == "cpu":
        return bias_act_ref(y, bias, slope, act, alpha)
    _check_bias_act(y, bias, slope, act)
    b, c, h, w = y.shape
    L.launch("rife_bias_act", y.device, L.ptr(y),
             int(y.dtype == torch.bfloat16), L.ptr(bias), L.ptr(slope), b * c,
             c, ctypes.c_longlong(h * w), act,
             ctypes.c_float(_in_dtype(alpha, y.dtype)))
    L.count(LAUNCHES, "bias_act")
    return y
