"""B4 on the CPU: the PixelShuffle forms of ``conv3x3`` / ``deconv4x4``
(``ps=2``; on the CPU their twins ``pixel_shuffle(conv3x3_ref(...))`` and
``pixel_shuffle(deconv4x4_ref(...))``) against the Pallas kernels they port,
``rife_tpu.ops.conv_planar.conv_ps_planar`` and ``deconv_ps_planar``, under
``pltpu.force_tpu_interpret_mode()`` on BHCW transposes, for every fused
activation, at r=2 and (cin, cout) pairs that include the v1 fusionnet's
head (16 -> 16) and ones whose output channels cross a 64-channel group of
the kernel (96; a deconv's 4 x 24 phase channels).

Bars: the shuffle moves values only, so the twin of B4 differs from the
Pallas form exactly where the plain twin differs from the plain Pallas
conv (``conv_planar``, ``deconv_planar``) on the same inputs: the two sum
the 9 x cin f32 products in different orders, which can move the one
rounding.  So bf16 is bit for bit where the sums agree (the v1 head,
16 -> 16, and 8 -> 16 at these inputs), and otherwise held to the bar
``chip_smoke.py`` holds the kernel to: <= 1 ulp of max(|out|, 2^-14 x the
sum of the output's absolute products) (two f32 sums of a value that
cancels to near zero differ by more than its own ulp) and >= 99% exact;
the Pallas
permutation is checked bit for bit against its own plain kernel.  f32:
max |d| <= 1e-5 of the output's largest magnitude.  The wrappers' gates
take the pre-shuffle channels, as ``planar_ops._op_conv_ps`` asks them; the
kernel against its twin on the card: tests/test_torch_cuda.py.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from rife_tpu.graph.ir import LayerNode
from rife_tpu.graph.weights import LayerWeights
from rife_tpu.ops import conv_planar as CP
from rife_tpu.ops import planar_ops as P
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import torch_ops

ACTS = [CV.ACT_NONE, CV.ACT_RELU, CV.ACT_LEAKY, CV.ACT_PRELU]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
CONV_PAIRS = [(16, 16), (8, 16), (24, 96)]
DECONV_PAIRS = [(12, 8), (16, 24)]  # (cin, deconv channels)


def q(a, jd):
    """numpy f32 values of ``a`` rounded to the storage dtype."""
    return np.asarray(jnp.asarray(a).astype(jd), np.float32)


def bhcw(x, jd):
    return jnp.asarray(x.transpose(0, 2, 1, 3)).astype(jd)


def bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def check(got, want_bhcw, jd, exact, scale=None):
    """``scale``: the sum of each output's absolute products."""
    got = got.float().numpy()
    want = np.asarray(want_bhcw, np.float32).transpose(0, 2, 1, 3)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if jd == jnp.float32:
        assert diff.max() <= 1e-5 * np.abs(want).max()
    elif exact:
        np.testing.assert_array_equal(got, want)
    else:
        mag = np.maximum(np.abs(want), scale.numpy() * 2.0 ** -14)
        assert np.all(diff <= bf16_ulp(mag)), diff.max()
        assert (diff == 0).mean() >= 0.99


def shuffle_bhcw(y, r=2):
    """PixelShuffle(r) of a BHCW array, as the NCHW twin does it."""
    y = torch.from_numpy(np.array(y, np.float32).transpose(0, 2, 1, 3))
    return F.pixel_shuffle(y, r).numpy().transpose(0, 2, 1, 3)


def case(seed, b, cin, wshape, n_bias, h, w, jd):
    rng = np.random.default_rng(seed)
    x = q(rng.normal(size=(b, cin, h, w)).astype(np.float32), jd)
    weight = q((rng.normal(size=wshape) * 0.3).astype(np.float32), jd)
    bias = (rng.normal(size=n_bias) * 0.5).astype(np.float32)
    slope = rng.uniform(0.05, 0.4, n_bias).astype(np.float32)
    return x, weight, bias, slope


def t(a, td=torch.float32):
    return torch.from_numpy(np.array(a)).to(td)


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("cin,cout", CONV_PAIRS)
def test_conv_ps_twin_matches_conv_ps_planar(cin, cout, act, jd, td):
    x, weight, bias, slope = case(cin + cout + act, 2, cin,
                                  (cout, cin, 3, 3), cout, 14, 22, jd)
    hwio = jnp.asarray(weight.transpose(2, 3, 1, 0))
    kw = dict(act=act, alpha=0.2, slope=jnp.asarray(slope))
    with pltpu.force_tpu_interpret_mode():
        ref = CP.conv_ps_planar(bhcw(x, jd), hwio, jnp.asarray(bias), r=2,
                                **kw)
        plain = CP.conv_planar(bhcw(x, jd), hwio, jnp.asarray(bias), **kw)
    np.testing.assert_array_equal(np.asarray(ref, np.float32),
                                  shuffle_bhcw(plain))
    got = CV.conv3x3([t(x, td)], t(weight, td), t(bias), t(slope), act=act,
                     alpha=0.2, ps=2)
    assert got.dtype == td and got.shape == (2, cout // 4, 28, 44)
    scale = CV.conv3x3_ref([t(np.abs(x))], t(np.abs(weight)), ps=2)
    check(got, ref, jd, exact=cin <= 16, scale=scale)


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("cin,co", DECONV_PAIRS)
def test_deconv_ps_twin_matches_deconv_ps_planar(cin, co, act, jd, td):
    """ncnn's (I,O,4,4) weights: the Pallas form takes them spatially
    flipped as HWIO, the port as the phase weights (bias and slope tiled
    4x)."""
    x, raw, bias, slope = case(cin * co + act, 2, cin, (cin, co, 4, 4), co,
                               9, 13, jd)
    flipped = jnp.asarray(raw[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
    kw = dict(act=act, alpha=0.2, slope=jnp.asarray(slope))
    with pltpu.force_tpu_interpret_mode():
        ref = CP.deconv_ps_planar(bhcw(x, jd), flipped, jnp.asarray(bias),
                                  **kw)
        plain = CP.deconv_planar(bhcw(x, jd), flipped, jnp.asarray(bias),
                                 **kw)
    np.testing.assert_array_equal(np.asarray(ref, np.float32),
                                  shuffle_bhcw(plain))
    phase = CV.deconv_phase_weights(t(raw)).to(td)
    got = CV.deconv4x4(t(x, td), phase, t(np.tile(bias, 4)),
                       t(np.tile(slope, 4)), act=act, alpha=0.2, ps=2)
    assert got.dtype == td and got.shape == (2, co // 4, 36, 52)
    scale = CV.deconv4x4_ref(t(np.abs(x)), phase.float().abs(), ps=2)
    check(got, ref, jd, exact=False, scale=scale)


def test_twins_are_shuffles_of_the_plain_twins():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 6, 8, 10)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(20, 6, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=20).astype(np.float32))
    assert torch.equal(CV.conv3x3([x], w, b, ps=2, stride=2),
                       F.pixel_shuffle(CV.conv3x3_ref([x], w, b, stride=2), 2))
    pw = CV.deconv_phase_weights(torch.from_numpy(rng.normal(
        size=(6, 8, 4, 4)).astype(np.float32)))
    assert torch.equal(CV.deconv4x4(x, pw, ps=2),
                       F.pixel_shuffle(CV.deconv4x4_ref(x, pw), 2))
    with pytest.raises(ValueError, match="PixelShuffle"):
        CV._check_ps(2, 18)


@pytest.mark.parametrize("kind", ["rife.ConvPS", "rife.DeconvPS"])
@pytest.mark.parametrize("cin,cout", [(16, 16), (48, 16), (16, 80)])
def test_gate_takes_the_pre_shuffle_channels(kind, cin, cout, monkeypatch):
    """``torch_ops`` sends a ConvPS / DeconvPS site to the PixelShuffle
    kernel exactly where ``planar_ops._op_conv_ps`` sends it to
    ``conv_ps_planar`` / ``deconv_ps_planar``: the gates on the conv's own
    (pre-shuffle) channels and the input size."""
    if kind == "rife.ConvPS":
        params = {0: cout, 1: 3, 3: 1, 4: 1, 5: 1, 6: cout * cin * 9, 25: 2}
        wshape = (cout, cin, 3, 3)
    else:
        params = {0: cout, 1: 4, 3: 2, 4: 1, 5: 1, 6: cout * cin * 16, 25: 2}
        wshape = (cin, cout, 4, 4)
    nd = LayerNode(kind, "ps", ["x"], ["y"], params)
    rng = np.random.default_rng(cin + cout)
    raw = {"ps": LayerWeights(
        weight=(rng.normal(size=wshape) * 0.2).astype(np.float32),
        bias=np.zeros(cout, np.float32))}
    w = torch_ops.prepare_weights(SimpleNamespace(nodes=[nd]), raw)
    calls = []
    name = "deconv4x4" if kind == "rife.DeconvPS" else "conv3x3"
    real = getattr(CV, name)
    monkeypatch.setattr(CV, name, lambda *a, **k: calls.append(
        k.get("ps")) or real(*a, **k))
    for h, wd in ((8, 12), (40, 60)):
        ctx = {"w": w, "planar_convs": True, "planar_min_hw": 1000,
               "planar_deconv_min_hw": 1000}
        calls.clear()
        x = torch.from_numpy(rng.normal(size=(1, cin, h, wd)).astype(
            np.float32))
        y = torch_ops.OP_TABLE[kind](nd, [x], None, ctx)[0]
        gate = (P.deconv_wants_planar if kind == "rife.DeconvPS"
                else P.conv_wants_planar)
        want = gate(nd, h, wd, cin, cout, ctx)
        assert calls == ([2] if want else []), (h, wd)
        scale = 2 if kind == "rife.ConvPS" else 4
        assert y.shape == (1, cout // 4, scale * h, scale * wd)
