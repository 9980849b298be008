"""The deconv kernel's layouts and plain versions on the CPU
(``rife_tpu_torch/csrc/deconv.cu``; ``ops/conv.py`` ``pack_weight_t4``,
``deconv_t4_ref``, ``deconv4x4_xla_ref``).

- The 4-tap packing holds exactly the nonzero taps of the phase
  weights (``deconv_phase_weights``), phase by phase in the kernel's order,
  and unpacks to the raw weights: exact.
- The kernel's plain version over the packed weights equals
  ``deconv4x4_ref`` (the phase conv, interleaved, shuffled) bit for bit, at
  ps 1 and 2, f32 and bf16, every activation: the same f32 sums.
- Against ``rife_tpu``'s ``deconv_planar`` / ``deconv_ps_planar`` in
  interpret mode: the bar of tests/test_torch_v1_conv_ps.py (the two sum
  the products in other orders: f32 1e-5 of the largest output; bf16 <= 1
  ulp of max(|out|, 2^-14 x the sum of absolute products), >= 99% exact).
- The XLA-order form (the sum rounded, then the bias and the activation in
  the storage dtype) equals ``jax_ops.deconv2d`` and the activation as
  ``rife_tpu`` computes them on XLA:CPU bit for bit, and the CPU route's
  composition with its bf16 convs summed as XLA sums them
  (tests/test_torch_v1_bf16_session.py ``_XlaConvs``), also with a
  PixelShuffle.  (oneDNN's own bf16 ``conv_transpose2d`` adds the bias
  before it rounds: the CPU route, unchanged, keeps that.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from rife_tpu.ops import conv_planar as CP
from rife_tpu.ops import jax_ops
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import torch_ops

ACTS = [CV.ACT_NONE, CV.ACT_RELU, CV.ACT_LEAKY, CV.ACT_PRELU]
DTYPES = [torch.float32, torch.bfloat16]
# (cin, O): a v2.3 fusionnet site, the v4.6 block tail, v1's up0 (512 ->
# 128, cut to 40 -> 72 here: three groups of 24 channels on the card)
PAIRS = [(12, 8), (16, 24), (40, 72)]


def case(seed, cin, co, h=9, w=13, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = t(rng.normal(size=(2, cin, h, w))).to(dtype)
    raw = t(rng.normal(size=(cin, co, 4, 4)) * 0.3).to(dtype)
    bias = t(rng.normal(size=co) * 0.5)
    slope = t(rng.uniform(0.05, 0.4, co))
    return x, raw, bias, slope


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,co", PAIRS + [(3, 4)])
def test_t4_packing_is_the_phase_weights_nonzero_taps(cin, co, dtype):
    _, raw, _, _ = case(cin * co, cin, co, dtype=dtype)
    packed = CV.pack_weight_t4(raw)
    assert packed.shape == (16, co, CV.padded_cin(cin))
    assert packed.dtype == dtype and packed.is_contiguous()
    assert not packed[:, :, cin:].any()
    assert torch.equal(CV.unpack_weight_t4(packed, cin), raw)
    w3 = CV.deconv_phase_weights(raw)
    seen = torch.zeros_like(w3, dtype=torch.bool)
    for py in (0, 1):
        for px in (0, 1):
            ph = py * 2 + px
            for ry in (0, 1):
                for rx in (0, 1):
                    blk = slice(ph * co, (ph + 1) * co)
                    assert torch.equal(packed[ph * 4 + ry * 2 + rx, :, :cin],
                                       w3[blk, :, py + ry, px + rx])
                    seen[blk, :, py + ry, px + rx] = True
    assert not w3[~seen].any()  # every other tap of the phase conv is 0
    assert torch.equal(CV.deconv_phase_weights(CV.unpack_weight_t4(
        packed, cin)), w3)


@pytest.mark.parametrize("ps", [1, 2])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,co", PAIRS)
def test_t4_twin_equals_deconv4x4_ref(cin, co, dtype, act, ps):
    x, raw, bias, slope = case(cin + co + act, cin, co, dtype=dtype)
    got = CV.deconv_t4_ref(x, CV.pack_weight_t4(raw), bias, slope, act=act,
                           alpha=0.2, ps=ps)
    want = CV.deconv4x4_ref(x, CV.deconv_phase_weights(raw), bias.repeat(4),
                            slope.repeat(4), act=act, alpha=0.2, ps=ps)
    assert got.dtype == dtype and torch.equal(got, want)
    # the card's planar route reads the first O values of the tiled bias
    assert torch.equal(bias.repeat(4)[:co], bias)


def bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("ps", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,co", PAIRS[:2])
def test_t4_twin_against_the_pallas_deconvs(cin, co, dtype, ps):
    """``deconv_planar`` (ps 1) and ``deconv_ps_planar`` (ps 2) in interpret
    mode on BHCW transposes, PReLU: the Pallas forms take the raw weights
    spatially flipped as HWIO."""
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x, raw, bias, slope = case(7 * cin + co, cin, co, dtype=dtype)
    flipped = jnp.asarray(raw.float().numpy()[:, :, ::-1, ::-1].transpose(
        2, 3, 0, 1)).astype(jd)
    xb = jnp.asarray(x.float().numpy().transpose(0, 2, 1, 3)).astype(jd)
    fn = CP.deconv_planar if ps == 1 else CP.deconv_ps_planar
    with pltpu.force_tpu_interpret_mode():
        ref = fn(xb, flipped, jnp.asarray(bias.numpy()), act=CV.ACT_PRELU,
                 alpha=0.2, slope=jnp.asarray(slope.numpy()))
    want = np.asarray(ref, np.float32).transpose(0, 2, 1, 3)
    got = CV.deconv_t4_ref(x, CV.pack_weight_t4(raw), bias, slope,
                           act=CV.ACT_PRELU, ps=ps).float().numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if dtype == torch.float32:
        assert diff.max() <= 1e-5 * np.abs(want).max()
    else:
        scale = CV.deconv_t4_ref(x.float().abs(), CV.pack_weight_t4(
            raw.float().abs()), ps=ps).numpy()
        mag = np.maximum(np.abs(want), scale * 2.0 ** -14)
        assert np.all(diff <= bf16_ulp(mag)), diff.max()
        assert (diff == 0).mean() >= 0.99


JAX_ACT = {CV.ACT_NONE: lambda y, s: y,
           CV.ACT_RELU: lambda y, s: jnp.maximum(y, 0),
           CV.ACT_LEAKY: lambda y, s: jnp.where(y >= 0, y,
                                                y * jnp.asarray(0.2, y.dtype)),
           CV.ACT_PRELU: lambda y, s: jnp.where(y >= 0, y, y * s)}


@pytest.mark.parametrize("ps", [1, 2])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("cin,co", PAIRS[:2])
def test_xla_order_form_equals_xla(cin, co, act, ps):
    """bf16: ``deconv4x4_xla_ref`` (and ``deconv_t4_ref(xla=True)`` over the
    packed weights) equals ``jax_ops.deconv2d`` (its bf16 bias) and the
    activation in bf16, then ``jax_ops.pixel_shuffle``, bit for bit, at
    widths where oneDNN's and XLA's f32 sums agree on these inputs (at 40
    input channels one value of 67,392 rounds 1 ulp apart: the two sum in
    other orders, as tests/test_torch_v1_conv_ps.py finds for the convs)."""
    x, raw, bias, slope = case(3 * cin + co + act, cin, co,
                               dtype=torch.bfloat16)
    bq, sq = bias.to(torch.bfloat16), slope.to(torch.bfloat16)
    got = CV.deconv4x4_xla_ref(x, raw, bq, sq, act=act, alpha=0.2, ps=ps)
    packed = CV.deconv_t4_ref(x, CV.pack_weight_t4(raw), bq.float(),
                              sq.float(), act=act, alpha=0.2, ps=ps, xla=True)
    assert torch.equal(got, packed)
    xj = jnp.asarray(x.float().numpy().transpose(0, 2, 3, 1)).astype(
        jnp.bfloat16)
    flipped = jnp.asarray(raw.float().numpy()[:, :, ::-1, ::-1].transpose(
        2, 3, 0, 1)).astype(jnp.bfloat16)
    y = jax_ops.deconv2d(xj, flipped, jnp.asarray(bq.float().numpy()).astype(
        jnp.bfloat16))
    y = JAX_ACT[act](y, jnp.asarray(sq.float().numpy()).astype(jnp.bfloat16))
    if ps == 2:
        y = jax_ops.pixel_shuffle(y, 2)
    want = np.asarray(y, np.float32).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got.float().numpy(), want)


class _XlaConvs:
    """``torch.nn.functional`` with the bf16 transposed convs summed as XLA
    sums them on the CPU: f32 sums of the bf16 operands, one rounding, then
    the bias in bf16 (as tests/test_torch_v1_bf16_session.py's)."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def conv_transpose2d(x, w, b=None, **kw):
        y = F.conv_transpose2d(x.float(), w.float(), None, **kw).to(x.dtype)
        return y if b is None else y + b.reshape(1, -1, 1, 1)


# (torch_ops activation of the node, kernel code): ncnn 9=1 ReLU, 9=2 leaky
# (its slope in -23310), the rewrite's per-channel PReLU
NODE_ACTS = [(0, [], CV.ACT_NONE), (1, [], CV.ACT_RELU),
             (2, [0.1], CV.ACT_LEAKY), (100, [], CV.ACT_PRELU)]


@pytest.mark.parametrize("ps", [1, 2])
@pytest.mark.parametrize("node_act,params,act", NODE_ACTS)
def test_xla_order_form_equals_the_cpu_route_summed_as_xla(
        monkeypatch, node_act, params, act, ps):
    """The CPU route of a Deconvolution / rife.DeconvPS site outside the
    gates (``torch_ops``: ``F.conv_transpose2d``, the activation in bf16,
    the shuffle) with its bf16 conv summed as XLA sums it gives what
    ``deconv4x4_xla`` computes on the CPU (the card's kernel in XLA
    order), from the same prepared weights."""
    from rife_tpu_torch.graph.ir import LayerNode

    cin, co = 16, 24
    x, raw, bias, slope = case(11 + act + ps, cin, co, dtype=torch.bfloat16)
    kind = "rife.DeconvPS" if ps == 2 else "Deconvolution"
    p = {0: co, 1: 4, 3: 2, 4: 1, 5: 1, 6: cin * co * 16, 9: node_act}
    if params:
        p[-23310] = params
    if ps == 2:
        p[25] = 2
    node = LayerNode(kind, "d", ["x"], ["y"], p)
    entry = torch_ops._entry(node, raw.float().numpy(), bias.numpy(),
                             slope.numpy() if act == CV.ACT_PRELU else None,
                             torch.bfloat16, "cpu")
    monkeypatch.setattr(torch_ops, "F", _XlaConvs())
    got = torch_ops.OP_TABLE[kind](node, [x], None, {"w": {"d": entry}})[0]
    monkeypatch.undo()
    want = CV.deconv4x4_xla(x, entry["weight_t4"], entry.get("bias_q"),
                            entry.get("slope_q"), act=act,
                            alpha=params[0] if params else 0.2, ps=ps)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
