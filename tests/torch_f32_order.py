"""The f32 conv kernel's arithmetic in numpy, exactly, for the tests.

Every output of ``csrc/conv.cu``'s f32 kernel (and of the kernel it replaced)
is one ``fmaf`` chain from +0 over the input channels ascending and, within
one, the taps (ky, kx) ascending, then the f32 bias (one rounding) and the
activation.  ``fma32`` is ``fmaf`` on numpy arrays (one rounding);
``conv3x3_serial`` is that chain over all nine taps, zero halo included (the
earlier kernel's order: its deconv sites ran the phase conv over all nine
taps of ``deconv_phase_weights``); ``deconv4x4_phases`` is the kernel's
deconv mode: each output phase over its four non-zero taps, read from the
packed ``weight_t4`` with the kernel's index formulas, written interleaved.
"""

import numpy as np

ACT_NONE, ACT_RELU, ACT_LEAKY, ACT_PRELU = 0, 1, 2, 3


def fma32(a, b, c):
    """float32 a * b + c with one rounding (to nearest, ties to even),
    elementwise.  The product is exact in float64 (24 + 24 bits); the f64
    sum s and its error e (Knuth's TwoSum) hold p + c exactly, and s rounds
    to float32 as p + c does unless s lies exactly halfway between two
    float32 values, where the sign of e decides."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    p = a.astype(np.float64) * b.astype(np.float64)
    q = c.astype(np.float64)
    s = p + q
    bb = s - p
    e = (p - (s - bb)) + (q - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    side = np.where(s > r64, np.float32(np.inf), np.float32(-np.inf))
    other = np.nextafter(r, side)
    halfway = (s != r64) & (s == (r64 + other.astype(np.float64)) / 2)
    toward = np.where(e > 0, np.maximum(r, other), np.minimum(r, other))
    return np.where(halfway & (e != 0), toward, r)


def epilogue(acc, bias, slope, act, alpha, channel_axis=1):
    """The kernel's epilogue on float32 sums: + bias (one rounding), then
    ReLU, leaky(alpha) or PReLU(slope) with one rounding of each product."""
    shape = [1] * acc.ndim
    shape[channel_axis] = -1
    v = acc
    if bias is not None:
        v = (v + np.asarray(bias, np.float32).reshape(shape)).astype(
            np.float32)
    if act == ACT_RELU:
        return np.maximum(v, np.float32(0))
    if act == ACT_LEAKY:
        return np.where(v >= 0, v, v * np.float32(alpha)).astype(np.float32)
    if act == ACT_PRELU:
        k = np.asarray(slope, np.float32).reshape(shape)
        return np.where(v >= 0, v, v * k).astype(np.float32)
    return v


def conv3x3_serial(parts, weight, bias=None, slope=None, *, stride=1,
                   act=ACT_NONE, alpha=0.2):
    """The conv in the kernel's order: ``parts`` (B, c_i, H, W) float32
    arrays, concatenated; ``weight`` (Cout, Cin, 3, 3); pad 1."""
    x = np.concatenate([np.asarray(p, np.float32) for p in parts], axis=1)
    weight = np.asarray(weight, np.float32)
    b, cin, h, w = x.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    acc = np.zeros((b, weight.shape[0], ho, wo), np.float32)
    for ci in range(cin):
        for ky in range(3):
            for kx in range(3):
                v = xp[:, ci, ky:ky + stride * (ho - 1) + 1:stride,
                       kx:kx + stride * (wo - 1) + 1:stride]
                acc = fma32(v[:, None], weight[None, :, ci, ky, kx, None,
                                                 None], acc)
    return epilogue(acc, bias, slope, act, alpha)


def deconv4x4_phases(x, weight_t4, phase_bias=None, phase_slope=None, *,
                     act=ACT_NONE, alpha=0.2):
    """The kernel's deconv mode: ``x`` (B, Cin, H, W); ``weight_t4`` (16, O,
    Cp) (``pack_weight_t4``: row phase x 4 + ry x 2 + rx); the phase-tiled
    (4 O,) bias and slope, read at phase x O + o.  Phase (py, px) of output
    (2m + py, 2n + px) sums window rows m - 1 + py + ry and columns n - 1 +
    px + rx over (ry, rx) in (0, 0), (0, 1), (1, 0), (1, 1): ascending taps
    ky = py + ry, kx = px + rx of the 3x3 window."""
    x = np.asarray(x, np.float32)
    wt = np.asarray(weight_t4, np.float32)
    b, cin, h, w = x.shape
    o = wt.shape[1]
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    out = np.zeros((b, o, 2 * h, 2 * w), np.float32)
    for ph in range(4):
        py, px = ph >> 1, ph & 1
        acc = np.zeros((b, o, h, w), np.float32)
        for ci in range(cin):
            for k4 in range(4):
                ky, kx = py + (k4 >> 1), px + (k4 & 1)
                v = xp[:, ci, ky:ky + h, kx:kx + w]
                acc = fma32(v[:, None], wt[ph * 4 + k4, None, :, ci, None,
                                           None], acc)
        sel = slice(ph * o, (ph + 1) * o)
        out[:, :, py::2, px::2] = epilogue(
            acc, None if phase_bias is None else np.asarray(phase_bias)[sel],
            None if phase_slope is None else np.asarray(phase_slope)[sel],
            act, alpha)
    return out
