"""The conv twin of rife_tpu_torch.ops.conv against the Pallas planar convs it
ports, and the copied site gates against rife_tpu.ops.planar_ops (the CUDA
kernel against the twin: tests/test_torch_cuda.py).

``conv3x3_ref`` is held to ``conv_planar`` (stride 1: K11
``_conv_planar_s1_direct``, or K9 ``conv_planar_bhcw`` with
RIFE_TPU_S1_DIRECT=0; stride 2: K12 ``_conv_planar_s2_direct``, or K10
``conv_s2_bhcw`` with RIFE_TPU_S2_DIRECT=0), to ``conv_planar_cat`` (2-3
parts, K12) and, through ``deconv4x4``, to ``deconv_planar``, for every
activation the kernels fuse, in f32 and bf16, under
``pltpu.force_tpu_interpret_mode`` (as tests/test_conv_planar.py runs them).
Tolerances: f32 max |d| <= 1e-5 of the output's largest magnitude (the two
sum the taps in another order); bf16 <= 1 ulp (that f32 difference can move
the one rounding) and exact on >= 99% of elements.
"""

import itertools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from rife_tpu.graph.ir import LayerNode
from rife_tpu.ops import common as C
from rife_tpu.ops import conv_planar as CP
from rife_tpu.ops import planar_ops as P
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import launch as L
from torch_other_device import elsewhere

ACTS = [CV.ACT_NONE, CV.ACT_RELU, CV.ACT_LEAKY, CV.ACT_PRELU]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def check(got, want_bhcw, jd):
    """``got`` NCHW torch, ``want_bhcw`` the Pallas BHCW result."""
    got = got.float().numpy()
    want = np.asarray(want_bhcw, np.float32).transpose(0, 2, 1, 3)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if jd == jnp.float32:
        assert diff.max() <= 1e-5 * np.abs(want).max(), diff.max()
    else:
        assert np.all(diff <= bf16_ulp(want)), diff.max()
        assert (diff == 0).mean() >= 0.99


def case(seed, b, cins, cout, h, w, jd):
    """NCHW parts in the storage dtype (numpy f32 values of it), an OIHW
    weight rounded to the storage dtype, f32 bias and slope."""
    rng = np.random.default_rng(seed)
    q = lambda a: np.asarray(jnp.asarray(a).astype(jd), np.float32)  # noqa: E731
    parts = [q(rng.normal(size=(b, c, h, w)).astype(np.float32)) for c in cins]
    weight = q((rng.normal(size=(cout, sum(cins), 3, 3)) * 0.3)
               .astype(np.float32))
    bias = (rng.normal(size=cout) * 0.5).astype(np.float32)
    slope = rng.uniform(0.05, 0.4, cout).astype(np.float32)
    return parts, weight, bias, slope


def twin(parts, weight, bias, slope, td, **kw):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return CV.conv3x3_ref([t(p).to(td) for p in parts], t(weight).to(td),
                          t(bias), t(slope), **kw)


def bhcw(x, jd):
    return jnp.asarray(x.transpose(0, 2, 1, 3)).astype(jd)


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_twin_matches_planar_conv(stride, act, jd, td):
    parts, weight, bias, slope = case(stride * 10 + act, 2, (12,), 20, 18, 36,
                                      jd)
    with pltpu.force_tpu_interpret_mode():
        ref = CP.conv_planar(bhcw(parts[0], jd),
                             jnp.asarray(weight.transpose(2, 3, 1, 0)),
                             jnp.asarray(bias), stride=stride, act=act,
                             alpha=0.2, slope=jnp.asarray(slope))
    got = twin(parts, weight, bias, slope, td, stride=stride, act=act,
               alpha=0.2)
    assert got.dtype == td
    check(got, ref, jd)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_twin_matches_packed_phase_kernels(stride, monkeypatch):
    """K9 / K10, the non-direct planar kernels (RIFE_TPU_S{1,2}_DIRECT=0),
    compute the same function: the twin covers them too."""
    monkeypatch.setenv(f"RIFE_TPU_S{stride}_DIRECT", "0")
    parts, weight, bias, slope = case(40 + stride, 1, (5,), 7, 16, 40,
                                      jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = CP.conv_planar(bhcw(parts[0], jnp.float32),
                             jnp.asarray(weight.transpose(2, 3, 1, 0)),
                             jnp.asarray(bias), stride=stride,
                             act=CV.ACT_PRELU, slope=jnp.asarray(slope))
    got = twin(parts, weight, bias, slope, torch.float32, stride=stride,
               act=CV.ACT_PRELU)
    check(got, ref, jnp.float32)


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("cins", [(3, 3), (3, 3, 4), (32, 32, 64)])
def test_conv3x3_twin_matches_planar_cat(cins, jd, td):
    """K12's multi-part form: the concat of the parts is never built."""
    parts, weight, bias, slope = case(sum(cins), 2, cins, 16, 16, 40, jd)
    with pltpu.force_tpu_interpret_mode():
        ref = CP.conv_planar_cat([bhcw(p, jd) for p in parts],
                                 jnp.asarray(weight.transpose(2, 3, 1, 0)),
                                 jnp.asarray(bias), act=CV.ACT_PRELU,
                                 slope=jnp.asarray(slope))
    got = twin(parts, weight, bias, slope, td, stride=2, act=CV.ACT_PRELU)
    check(got, ref, jd)


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("act", [CV.ACT_NONE, CV.ACT_PRELU])
def test_deconv4x4_matches_deconv_planar(act, jd, td):
    """The phase decomposition: ``deconv4x4`` (one stride-1 conv over the
    four output phases + interleave) against ``deconv_planar``."""
    rng = np.random.default_rng(50 + act)
    cin, co, h, w = 12, 4, 10, 30
    q = lambda a: np.asarray(jnp.asarray(a).astype(jd), np.float32)  # noqa: E731
    x = q(rng.normal(size=(2, cin, h, w)).astype(np.float32))
    raw = q((rng.normal(size=(cin, co, 4, 4)) * 0.3).astype(np.float32))
    bias = rng.normal(size=co).astype(np.float32)
    slope = rng.uniform(0.05, 0.4, co).astype(np.float32)
    wf = jnp.asarray(raw[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)).astype(jd)
    with pltpu.force_tpu_interpret_mode():
        ref = CP.deconv_planar(bhcw(x, jd), wf, jnp.asarray(bias), act=act,
                               slope=jnp.asarray(slope))
    w3 = CV.deconv_phase_weights(torch.from_numpy(np.array(raw))).to(td)
    got = CV.deconv4x4(torch.from_numpy(np.array(x)).to(td), w3,
                       torch.from_numpy(np.tile(bias, 4)),
                       torch.from_numpy(np.tile(slope, 4)), act=act)
    assert got.shape == (2, co, 2 * h, 2 * w)
    check(got, ref, jd)


def test_deconv4x4_matches_conv_transpose():
    rng = np.random.default_rng(60)
    x = torch.from_numpy(rng.normal(size=(1, 6, 7, 9)).astype(np.float32))
    raw = torch.from_numpy(rng.normal(size=(6, 5, 4, 4)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=5).astype(np.float32))
    got = CV.deconv4x4(x, CV.deconv_phase_weights(raw), bias.repeat(4))
    want = F.conv_transpose2d(x, raw, bias, stride=2, padding=1)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_cpu_wrapper_takes_twin_without_counting():
    parts, weight, bias, slope = case(70, 1, (3, 5), 6, 8, 10, jnp.float32)
    t = [torch.from_numpy(np.array(p)) for p in parts]
    args = (torch.from_numpy(np.array(weight)), torch.from_numpy(bias),
            torch.from_numpy(slope))
    CV.reset_launches()
    got = CV.conv3x3(t, *args, stride=2, act=CV.ACT_PRELU)
    assert torch.equal(got, CV.conv3x3_ref(t, *args, stride=2,
                                           act=CV.ACT_PRELU))
    raw = torch.linspace(-1, 1, 3 * 5 * 16).reshape(3, 5, 4, 4)
    got = CV.deconv4x4_xla(t[0], CV.pack_weight_t4(raw), torch.ones(5),
                           act=CV.ACT_RELU)
    assert torch.equal(got, CV.deconv4x4_xla_ref(t[0], raw, torch.ones(5),
                                                 act=CV.ACT_RELU))
    assert CV.LAUNCHES == {"conv3x3": 0, "conv3x3_ps": 0, "deconv4x4": 0,
                           "bias_act": 0}


def test_non_cpu_tensors_never_take_the_twin(monkeypatch):
    """Only a CPU tensor takes the twin: a plan's meta tensors take the
    kernel's branch (checks, output, count) and launch nothing; any other
    device raises there rather than fall back."""
    def twin(*args, **kw):
        raise AssertionError("the twin ran off the CPU")

    monkeypatch.setattr(CV, "conv3x3_ref", twin)
    meta = [torch.empty(1, 4, 8, 8, device="meta")]
    weight = torch.empty(2, 4, 3, 3, device="meta")
    with L.planning("cuda") as calls:
        out = CV.conv3x3(meta, weight, weight_tc=CV.pack_weight_tc(weight))
        with pytest.raises(ValueError, match="weight_tc"):
            CV.conv3x3(meta, weight)
    assert calls == [("conv3x3", (1, (4,), 2, 1, CV.ACT_NONE, 8, 8, False))]
    assert out.device.type == "meta" and out.shape == (1, 2, 8, 8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        CV.conv3x3([elsewhere(1, 4, 8, 8)], elsewhere(2, 4, 3, 3))


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

GATE_ACTS = [C.ACT_NONE, C.ACT_RELU, C.ACT_PRELU_CH, C.ACT_CLIP]
SIZES = [(1088, 1920), (544, 960), (512, 768), (545, 960), (272, 480),
         (136, 240), (128, 192), (64, 112)]
CHANNELS = [3, 10, 24, 32, 48, 64, 96, 128, 192]


def conv_node(kind, cout, k=3, stride=2, pad=1, act=C.ACT_PRELU_CH):
    return LayerNode(kind, "n", ["x"], ["y"],
                     {0: cout, 1: k, 3: stride, 4: pad, 5: 1, 9: act})


def test_conv_gates_match_planar_ops():
    ctxs = [{}, {"planar_min_hw": 100_000}, {"planar_all": True}]
    n = 0
    for cin, cout, (h, w), stride, k, pad, act in itertools.product(
            CHANNELS, CHANNELS, SIZES, (1, 2), (3, 1), (1, 0), GATE_ACTS):
        node = conv_node("Convolution", cout, k, stride, pad, act)
        assert CV.planar_conv_ok(cin, cout, h, w, stride, k, 1, pad) == \
            P._planar_conv_ok(cin, cout, h, w, stride, k, 1, pad)
        for ctx in ctxs:
            assert CV.conv_wants_planar(node, h, w, cin, cout, ctx) == \
                P.conv_wants_planar(node, h, w, cin, cout, ctx), \
                (cin, cout, h, w, stride, k, pad, act, ctx)
            n += 1
    assert n > 10_000


def test_deconv_gates_match_planar_ops():
    for cin, cout, (h, w), stride, k, pad, act in itertools.product(
            CHANNELS, CHANNELS + [4], SIZES, (2, 1), (4, 3), (1, 0),
            GATE_ACTS):
        node = conv_node("Deconvolution", cout, k, stride, pad, act)
        assert CV.planar_deconv_ok(cin, cout, k, stride, pad) == \
            P._planar_deconv_ok(cin, cout, k, stride, pad)
        for ctx in ({}, {"planar_deconv_min_hw": 5000}, {"planar_all": True}):
            assert CV.deconv_wants_planar(node, h, w, cin, cout, ctx) == \
                P.deconv_wants_planar(node, h, w, cin, cout, ctx)


def _planar_cat_route(monkeypatch, node, h, w, cins, cout):
    """Which path ``planar_ops._op_convolution_cat`` takes: 'kernel'
    (conv_planar_cat) or 'concat' (concat + _op_convolution)."""
    monkeypatch.setattr(P, "conv_planar_cat", lambda *a, **k: "kernel")
    monkeypatch.setattr(P, "_op_convolution", lambda *a, **k: ["concat"])
    monkeypatch.setattr(P, "jnp", SimpleNamespace(
        concatenate=lambda xs, axis: None))
    ins = [SimpleNamespace(shape=(1, h, c, w)) for c in cins]
    ctx = {"use_pallas_warp": True, "w": {node.name: {
        "hwio": SimpleNamespace(shape=(3, 3, sum(cins), cout)),
        "bias": None, "slope": None}}}
    out = P._op_convolution_cat(node, ins, None, ctx)
    return out[0]


def test_cat_gate_matches_planar_ops(monkeypatch):
    for cins, cout, (h, w), stride, act in itertools.product(
            [(3, 3, 4), (3, 3, 2, 1, 1), (32, 64), (64, 32, 32), (128,),
             (96, 96)],
            [16, 32, 48, 96, 128, 192], SIZES, (2, 1), GATE_ACTS):
        node = conv_node("ConvolutionCat", cout, stride=stride, act=act)
        want = _planar_cat_route(monkeypatch, node, h, w, cins, cout)
        got = CV.cat_conv_wants_planar(node, h, w, sum(cins), cout,
                                       len(cins), {})
        assert got == (want == "kernel"), (cins, cout, h, w, stride, act)
