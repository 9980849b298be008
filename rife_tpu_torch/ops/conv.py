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
functions and are covered by it.  ``deconv4x4`` runs the 4x4 stride-2
transposed conv of the planar deconv sites as ``conv_planar.deconv_planar``
does: one stride-1 ``conv3x3`` producing the four output phases on its
output channels (``_deconv_phase_weights``), then a plain reshape/permute
interleave.

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
raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from rife_tpu.ops import common as C

from ..native import build

LAUNCHES = {"conv3x3": 0}

CONV_MIN_HW = 400_000
DECONV_MIN_HW = 25_000
MAX_PARTS = 4

# kernel activation codes, as conv_planar's
ACT_NONE, ACT_RELU, ACT_LEAKY, ACT_PRELU = 0, 1, 2, 3
ACT_MAP = {C.ACT_NONE: ACT_NONE, C.ACT_RELU: ACT_RELU,
           C.ACT_LEAKY: ACT_LEAKY, C.ACT_PRELU_CH: ACT_PRELU}


def reset_launches() -> None:
    LAUNCHES["conv3x3"] = 0


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
                act=ACT_NONE, alpha=0.2):
    """Twin of the kernel: ``F.conv2d`` on f32 copies of the concat (TF32
    off), then + f32 bias, the activation in f32 and one cast to the
    storage dtype of ``parts``."""
    x = torch.cat([p.float() for p in parts], dim=1)
    with _full_f32():
        y = F.conv2d(x, weight.float(), None, stride=stride, padding=1)
    if bias is not None:
        y = y + bias.float().reshape(1, -1, 1, 1)
    return activate_f32(y, act, alpha, slope).to(parts[0].dtype)


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


def deconv4x4(x, phase_weight, phase_bias=None, phase_slope=None, *,
              act=ACT_NONE, alpha=0.2):
    """4x4 stride-2 pad-1 transposed conv as a stride-1 ``conv3x3`` over the
    phase weights (``deconv_phase_weights``; bias and slope tiled 4x), then
    the phase interleave."""
    y4 = conv3x3([x], phase_weight, phase_bias, phase_slope, stride=1,
                 act=act, alpha=alpha)
    return interleave_phases(y4)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _check(parts, weight, bias, slope, stride, act):
    ref = parts[0]
    if ref.device.type != "cuda":
        raise ValueError(f"conv3x3 takes CUDA or CPU tensors, got {ref.device}")
    if ref.dtype not in _DTYPE_CODE:
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


def conv3x3(parts, weight, bias=None, slope=None, *, stride=1, act=ACT_NONE,
            alpha=0.2):
    """The kernel on CUDA, its twin on the CPU.  ``parts``: 1-4 (B,Ci,H,W)
    tensors whose channel concat is the input; ``weight`` (Cout, sum Ci, 3,
    3) in their dtype; ``bias``/``slope`` (Cout,) float32 or None.
    Returns (B, Cout, Ho, Wo) in the parts' dtype."""
    parts = list(parts)
    if parts[0].device.type == "cpu":
        return conv3x3_ref(parts, weight, bias, slope, stride=stride, act=act,
                           alpha=alpha)
    b, h, w, cout = _check(parts, weight, bias, slope, stride, act)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = torch.empty((b, cout, ho, wo), dtype=parts[0].dtype,
                      device=parts[0].device)
    padded = parts + [None] * (MAX_PARTS - len(parts))
    chans = [0 if t is None else t.shape[1] for t in padded]
    lib = build.load()
    stream = torch.cuda.current_stream(parts[0].device).cuda_stream
    rc = lib.rife_conv3x3(*[_ptr(t) for t in padded], *chans, _ptr(weight),
                          _ptr(bias), _ptr(slope), _ptr(out), b, h, w, cout,
                          stride, act, ctypes.c_float(alpha),
                          _DTYPE_CODE[parts[0].dtype], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rife_conv3x3: CUDA error {rc} "
                           f"({build.error_string(rc)})")
    LAUNCHES["conv3x3"] += 1
    return out
