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
functions and are covered by it.  In bf16 it runs on the tensor cores over
weights packed once per model (``pack_weight_tc``: (9, Cout, Cin padded to
16)); in f32 on the CUDA cores over the OIHW weights.  ``deconv4x4`` runs
the 4x4 stride-2 transposed conv of the planar deconv sites as
``conv_planar.deconv_planar`` does: one stride-1 conv producing the four
output phases on its output channels (``deconv_phase_weights``); in bf16 the
kernel writes each phase to its interleaved place, in f32 a plain
reshape/permute interleaves them (``interleave_phases``).

Numeric trap (ROADMAP queue C): the XLA conv that the JAX package runs off
these sites rounds the conv result to the storage dtype BEFORE it adds the
bias (``jax_ops.conv2d``); the planar kernel adds the f32 bias before its
single rounding.  The cuDNN sites of ``torch_ops`` keep the XLA form, the
kernel sites this one; in f32 the two agree.

Gates (``planar_ops.py:63-102,146-158``): exactly the sites that the TPU's
planar executor (the default for the v1/v2/v3 nets) sends to K11/K12.
``torch_ops`` consults them only for nets run as planar on the TPU
(ctx ``planar``); ``CONV_MIN_HW`` / ``DECONV_MIN_HW`` are the input-size
thresholds (ctx ``planar_min_hw`` / ``planar_deconv_min_hw`` override them,
``planar_all`` lifts them, as in ``planar_ops``).

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches the kernel or
raises (nothing falls back to another kernel or to the twin).  ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from . import common as C
from . import launch as L

LAUNCHES = {"conv3x3": 0, "conv3x3_ps": 0}

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


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _full_f32():
    """cuDNN convs run in TF32 by default on Hopper; the twin is f32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


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
    with _full_f32():
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

def _check(parts, weight, bias, slope, stride, act, weight_tc=None):
    ref = parts[0]
    if ref.device.type != "cuda":
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
    if ref.dtype == torch.bfloat16 and weight_tc is None:
        raise ValueError("a bf16 launch takes weight_tc (pack_weight_tc)")
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
            phase_o=0, ps=1):
    """One launch: the tensor-core kernel for bf16 (over ``weight_tc``, the
    packed weights; ``phase_o`` > 0 writes a deconv's interleaved phases,
    ``ps`` > 1 the PixelShuffle(ps) of the result), the CUDA-core kernel
    for f32 (which writes the plain result).  It counts as ``conv3x3_ps``
    when ``ps`` > 1, else as ``conv3x3``."""
    b, h, w = parts[0].shape[0], parts[0].shape[2], parts[0].shape[3]
    cout = weight.shape[0]
    padded = parts + [None] * (MAX_PARTS - len(parts))
    chans = [0 if t is None else t.shape[1] for t in padded]
    device = parts[0].device
    if parts[0].dtype == torch.bfloat16:
        L.launch("rife_conv3x3_tc", device, *map(L.ptr, padded), *chans,
                 L.ptr(weight_tc), weight_tc.shape[2], L.ptr(bias),
                 L.ptr(slope), L.ptr(out), b, h, w, cout, stride, act,
                 ctypes.c_float(alpha), phase_o, ps)
    else:
        L.launch("rife_conv3x3", device, *map(L.ptr, padded), *chans,
                 L.ptr(weight), L.ptr(bias), L.ptr(slope), L.ptr(out), b, h,
                 w, cout, stride, act, ctypes.c_float(alpha))
    LAUNCHES["conv3x3_ps" if ps > 1 else "conv3x3"] += 1


def _check_ps(ps, channels):
    if ps < 1 or channels % (ps * ps):
        raise ValueError(f"PixelShuffle({ps}) of {channels} channels")


def conv3x3(parts, weight, bias=None, slope=None, *, stride=1, act=ACT_NONE,
            alpha=0.2, weight_tc=None, ps=1):
    """The kernel on CUDA, its twin on the CPU.  ``parts``: 1-4 (B,Ci,H,W)
    tensors whose channel concat is the input; ``weight`` (Cout, sum Ci, 3,
    3) in their dtype; ``weight_tc`` the same weights packed once
    (``pack_weight_tc``), which a bf16 launch reads and needs;
    ``bias``/``slope`` (Cout,) float32 or None.  Returns (B, Cout, Ho, Wo)
    in the parts' dtype; with ``ps`` > 1 (B4, ``rife.ConvPS``) its
    PixelShuffle(ps), (B, Cout/ps^2, ps*Ho, ps*Wo): in bf16 one launch whose
    epilogue writes each output channel c*ps^2 + i*ps + j of pixel (y, x)
    to (c, ps*y + i, ps*x + j), in f32 the CUDA-core kernel, then
    ``F.pixel_shuffle``."""
    parts = list(parts)
    if parts[0].device.type == "cpu":
        return conv3x3_ref(parts, weight, bias, slope, stride=stride, act=act,
                           alpha=alpha, ps=ps)
    b, h, w, cout = _check(parts, weight, bias, slope, stride, act, weight_tc)
    _check_ps(ps, cout)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if ps > 1 and parts[0].dtype == torch.bfloat16:
        out = parts[0].new_empty((b, cout // (ps * ps), ps * ho, ps * wo))
        _launch(parts, weight, bias, slope, out, stride, act, alpha,
                weight_tc, ps=ps)
        return out
    out = parts[0].new_empty((b, cout, ho, wo))
    _launch(parts, weight, bias, slope, out, stride, act, alpha, weight_tc,
            ps=ps)
    return F.pixel_shuffle(out, ps) if ps > 1 else out


def deconv4x4(x, phase_weight, phase_bias=None, phase_slope=None, *,
              act=ACT_NONE, alpha=0.2, phase_weight_tc=None, ps=1):
    """4x4 stride-2 pad-1 transposed conv as a stride-1 conv over the phase
    weights (``deconv_phase_weights``; bias and slope tiled 4x), the phases
    interleaved into (B, O, 2H, 2W); with ``ps`` = 2 (B4, ``rife.DeconvPS``)
    its PixelShuffle(2), (B, O/4, 4H, 4W).  CUDA bf16: one launch that writes
    the interleaved (and shuffled) output (``phase_weight_tc`` the packed
    phase weights).  Otherwise ``conv3x3`` (the twin on the CPU, the
    CUDA-core kernel for f32), then ``interleave_phases`` (and
    ``F.pixel_shuffle``): what ``deconv4x4_ref`` computes."""
    if x.device.type == "cpu":
        y = interleave_phases(conv3x3([x], phase_weight, phase_bias,
                                      phase_slope, stride=1, act=act,
                                      alpha=alpha))
        return F.pixel_shuffle(y, ps) if ps > 1 else y
    b, h, w, cout = _check([x], phase_weight, phase_bias, phase_slope, 1, act,
                           phase_weight_tc)
    if cout % 4:
        raise ValueError(f"phase weights need 4*O output channels, got {cout}")
    if ps not in (1, 2):
        raise ValueError(f"deconv4x4 shuffles by 2 or not at all, got {ps}")
    _check_ps(ps, cout // 4)
    if x.dtype == torch.bfloat16:
        o = cout // 4 // (ps * ps)
        out = x.new_empty((b, o, 2 * ps * h, 2 * ps * w))
        _launch([x], phase_weight, phase_bias, phase_slope, out, 1, act, alpha,
                phase_weight_tc, phase_o=cout // 4, ps=ps)
        return out
    y4 = x.new_empty((b, cout, h, w))
    _launch([x], phase_weight, phase_bias, phase_slope, y4, 1, act, alpha,
            phase_weight_tc, ps=ps)
    y = interleave_phases(y4)
    return F.pixel_shuffle(y, ps) if ps > 1 else y
