"""The op kinds the v1 graphs add to rife_tpu_torch.ops.torch_ops.OP_TABLE,
each against the jax_ops handler of the same name on the same node and
weights (CPU): ``InnerProduct``, global ``Pooling``, ``UnaryOp``, the
``BinaryOp`` broadcast of a (B,C) vector into a (B,C,H,W) map and the
types beyond ADD/SUB/MUL/RSUB, a standalone ``PReLU`` on a (B,C) vector,
``Interp`` nearest and ``rife.ConvPS`` / ``rife.DeconvPS`` off the planar
sites; and ``weights_from_jax`` against ``prepare_weights`` on the v1
graphs.

Inputs are made with numpy from a seed; JAX runs NHWC, the port NCHW.
Bars: f32 max |d| <= 1e-6 where the op sums (``InnerProduct``,
``Pooling``: the two may add in another order) and bit for bit elsewhere;
bf16 bit for bit, except where a sum of more than a few terms is rounded
once (``Pooling`` over a map, ``InnerProduct``): <= 1 ulp there, since
the f32 sums of the two backends may differ in their last bits and move
that one rounding.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.graph.ir import LayerNode
from rife_tpu.graph.weights import LayerWeights
from rife_tpu.ops import common as JC
from rife_tpu.ops import jax_ops
from rife_tpu_torch.models.v1_arch import write_v1_params
from rife_tpu_torch.ops import torch_ops
from torch_jax_weights import weights_from_jax

RNG = np.random.default_rng(91)
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def node(kind, n_in, params):
    return LayerNode(kind, f"t_{kind}", [f"in{i}" for i in range(n_in)],
                     ["out0"], params)


def rand(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def nchw(x):
    """NHWC (or (B,C)) numpy -> the port's layout."""
    return np.ascontiguousarray(np.moveaxis(x, -1, 1)) if x.ndim == 4 else x


def run_both(nd, ins, raw=None, dtypes=DTYPES[0]):
    """Run ``nd`` through both tables in one dtype; returns (jax, port) as
    f32 numpy in the JAX layout."""
    jd, td = dtypes
    graph = SimpleNamespace(nodes=[nd])
    raw = raw or {}
    jctx = {"w": jax_ops.prepare_weights(graph, raw, jd)}
    tctx = {"w": torch_ops.prepare_weights(graph, raw, td)}
    j = jax_ops.OP_TABLE[nd.type](nd, [jnp.asarray(x).astype(jd) for x in ins],
                                  raw.get(nd.name), jctx)[0]
    t = torch_ops.OP_TABLE[nd.type](
        nd, [torch.from_numpy(nchw(x)).to(td) for x in ins],
        raw.get(nd.name), tctx)[0]
    assert t.dtype == td
    t = t.float().numpy()
    return np.asarray(j, np.float32), np.moveaxis(t, 1, -1) if t.ndim == 4 \
        else t


def bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def check(j, t, jd, summed=False):
    assert j.shape == t.shape
    if jd == jnp.float32:
        if summed:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(t, j)
    elif summed:
        assert np.all(np.abs(t - j) <= bf16_ulp(j)), np.abs(t - j).max()
    else:
        np.testing.assert_array_equal(t, j)


# --- InnerProduct ---------------------------------------------------------

def ip_case(bias: bool, act: int = 0, n_in=24, n_out=16):
    params = {0: n_out, 1: int(bias), 2: n_in * n_out, 9: act}
    if act == JC.ACT_CLIP:
        params[-23310] = [-0.5, 0.5]
    nd = node("InnerProduct", 1, params)
    raw = {nd.name: LayerWeights(
        weight=rand(n_out, n_in, scale=0.3),
        bias=rand(n_out, scale=0.7) if bias else None)}
    return nd, raw


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", [JC.ACT_NONE, JC.ACT_RELU, JC.ACT_CLIP,
                                 JC.ACT_SIGMOID])
def test_innerproduct(jd, td, bias, act):
    nd, raw = ip_case(bias, act)
    j, t = run_both(nd, [rand(3, 24)], raw, (jd, td))
    check(j, t, jd, summed=True)


def test_innerproduct_rounds_before_the_bias():
    """bf16: the f32 product is rounded to bf16 and the bf16 bias added in
    bf16 (``jax_ops._op_innerproduct``), not added in f32 before one
    rounding; the inputs are picked so that the two orders differ."""
    nd, raw = ip_case(True)
    raw[nd.name].bias = np.full(16, 1.0 + 2.0 ** -7, np.float32)
    x = rand(4, 24)
    j, t = run_both(nd, [x], raw, DTYPES[1])
    np.testing.assert_array_equal(t, j)
    w = torch.from_numpy(raw[nd.name].weight).bfloat16().float()
    xb = torch.from_numpy(x).bfloat16().float()
    once = ((xb @ w.t()) + torch.from_numpy(raw[nd.name].bias).bfloat16()
            .float()).bfloat16().float().numpy()
    assert not np.array_equal(once, t)


# --- Pooling --------------------------------------------------------------

@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("shape", [(2, 6, 8, 5), (3, 17, 23, 16)])
def test_global_average_pooling(jd, td, shape):
    j, t = run_both(node("Pooling", 1, {0: 1, 4: 1}), [rand(*shape) + 0.3],
                    dtypes=(jd, td))
    assert t.shape == (shape[0], shape[3])
    check(j, t, jd, summed=True)


@pytest.mark.parametrize("params", [{0: 0, 4: 1}, {0: 1, 4: 0}])
def test_other_pooling_raises(params):
    nd = node("Pooling", 1, params)
    for table in (jax_ops.OP_TABLE, torch_ops.OP_TABLE):
        with pytest.raises(NotImplementedError, match="global average"):
            table["Pooling"](nd, [torch.zeros(1, 2, 3, 3)], None, {})


# --- UnaryOp --------------------------------------------------------------

UNARY_INPUTS = {
    JC.UNARY_SQRT: lambda x: np.abs(x) + 0.1,
    JC.UNARY_RSQRT: lambda x: np.abs(x) + 0.1,
    JC.UNARY_LOG: lambda x: np.abs(x) + 0.1,
    JC.UNARY_TAN: lambda x: x * 0.5,
}


@pytest.mark.parametrize("op", sorted(jax_ops._UNARY))
def test_unaryop_f32(op):
    x = UNARY_INPUTS.get(op, lambda v: v * 2)(rand(2, 5, 7, 3))
    j, t = run_both(node("UnaryOp", 1, {0: op}), [x])
    np.testing.assert_allclose(t, j, rtol=2e-7, atol=1e-7)


@pytest.mark.parametrize("op", [JC.UNARY_ABS, JC.UNARY_NEG, JC.UNARY_FLOOR,
                                JC.UNARY_CEIL, JC.UNARY_SQUARE])
def test_unaryop_bf16_bitwise(op):
    """The exact ones (NEG is the op the v1 graphs run) are bit for bit in
    bf16; with a (B,C) vector too."""
    for shape in ((2, 5, 7, 3), (3, 16)):
        j, t = run_both(node("UnaryOp", 1, {0: op}), [rand(*shape) * 3],
                        dtypes=DTYPES[1])
        np.testing.assert_array_equal(t, j)


def test_unaryop_table_covers_jax():
    assert set(torch_ops._UNARY) == set(jax_ops._UNARY)
    with pytest.raises(NotImplementedError, match="UnaryOp"):
        torch_ops.OP_TABLE["UnaryOp"](node("UnaryOp", 1, {0: 99}),
                                      [torch.zeros(1)], None, {})


# --- BinaryOp -------------------------------------------------------------

@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("op", [JC.BINARY_ADD, JC.BINARY_SUB, JC.BINARY_MUL,
                                JC.BINARY_DIV, JC.BINARY_MAX, JC.BINARY_MIN,
                                JC.BINARY_RSUB, JC.BINARY_RDIV])
@pytest.mark.parametrize("order", ["map, vector", "vector, map"])
def test_binaryop_broadcasts_a_vector(jd, td, op, order):
    """The SE scale: a (B,C) vector against a (B,C,H,W) map, either side,
    for every type; bit for bit (one rounding per element)."""
    m, v = rand(2, 5, 7, 6), rand(2, 6) + 3.0
    ins = [m, v] if order == "map, vector" else [v, m]
    j, t = run_both(node("BinaryOp", 2, {0: op}), ins, dtypes=(jd, td))
    assert t.shape == (2, 5, 7, 6)
    check(j, t, jd)


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("op", [JC.BINARY_DIV, JC.BINARY_MAX, JC.BINARY_MIN,
                                JC.BINARY_RDIV])
def test_binaryop_new_types(jd, td, op):
    """The types beyond ADD/SUB/MUL/RSUB, map against map and against a
    scalar constant (cast to the storage dtype first)."""
    a, b = np.abs(rand(2, 5, 7, 3)) + 0.5, rand(2, 5, 7, 3)
    check(*run_both(node("BinaryOp", 2, {0: op}), [a, b], dtypes=(jd, td)),
          jd)
    check(*run_both(node("BinaryOp", 1, {0: op, 1: 1, 2: 1.7}), [a],
                    dtypes=(jd, td)), jd)


@pytest.mark.parametrize("jd,td", DTYPES)
def test_binaryop_pow(jd, td):
    """POW: XLA's and torch's ``pow`` round differently in the last bit:
    <= 1 ulp (f32: relative 2^-23; bf16: one bf16 ulp), map against map
    and against a scalar."""
    a, b = np.abs(rand(2, 5, 7, 3)) + 0.5, rand(2, 5, 7, 3)
    for nd, ins in ((node("BinaryOp", 2, {0: JC.BINARY_POW}), [a, b]),
                    (node("BinaryOp", 1, {0: JC.BINARY_POW, 1: 1, 2: 1.7}),
                     [a])):
        j, t = run_both(nd, ins, dtypes=(jd, td))
        if jd == jnp.float32:
            np.testing.assert_allclose(t, j, rtol=2.0 ** -23, atol=0)
        else:
            assert np.all(np.abs(t - j) <= bf16_ulp(j))


@pytest.mark.parametrize("jd,td", DTYPES)
def test_prelu_on_a_vector(jd, td):
    """The SE gate's one-slope PReLU stays a node of its own
    (``fuse_prelu_activations`` folds into convs only)."""
    nd = node("PReLU", 1, {0: 1})
    raw = {nd.name: LayerWeights(slope=np.array([0.25], np.float32))}
    check(*run_both(nd, [rand(3, 16)], raw, (jd, td)), jd)


# --- Interp nearest -------------------------------------------------------

@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("hs,ws", [(2.0, 2.0), (0.5, 0.5), (4.0, 1.0),
                                   (0.25, 3.0), (1.5, 0.75)])
def test_interp_nearest(jd, td, hs, ws):
    nd = node("Interp", 1, {0: 1, 1: hs, 2: ws})
    j, t = run_both(nd, [rand(2, 12, 20, 3)], dtypes=(jd, td))
    np.testing.assert_array_equal(t, j)


# --- ConvPS / DeconvPS off the planar sites -----------------------------

@pytest.mark.parametrize("kind", ["rife.ConvPS", "rife.DeconvPS"])
def test_conv_ps_composes(kind):
    """Outside a planar site the fused node is the conv (cuDNN on the card)
    then PixelShuffle(2), as ``jax_ops._op_conv_ps`` composes them: f32
    against JAX (the convs sum in another order: 2e-6), and in bf16 bit for
    bit the port's own conv op, then ``F.pixel_shuffle`` (the conv ops
    against XLA's: tests/test_torch_ops.py and the bf16 session tests)."""
    plain = {"rife.ConvPS": "Convolution", "rife.DeconvPS": "Deconvolution"}
    if kind == "rife.ConvPS":
        params = {0: 16, 1: 3, 3: 1, 4: 1, 5: 1, 6: 16 * 8 * 9}
        weight = rand(16, 8, 3, 3, scale=0.3)
    else:
        params = {0: 16, 1: 4, 3: 2, 4: 1, 5: 1, 6: 16 * 8 * 16}
        weight = rand(8, 16, 4, 4, scale=0.2)
    nd = node(kind, 1, {**params, 25: 2})
    raw = {nd.name: LayerWeights(weight=weight, bias=rand(16, scale=0.1))}
    x = rand(2, 6, 10, 8, scale=0.5)
    j, t = run_both(nd, [x], raw)
    scale = 2 if kind == "rife.ConvPS" else 4
    assert t.shape == (2, 6 * scale, 10 * scale, 4)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-6)
    graph = SimpleNamespace(nodes=[nd])
    ctx = {"w": torch_ops.prepare_weights(graph, raw, torch.bfloat16)}
    xb = torch.from_numpy(nchw(x)).bfloat16()
    fused = torch_ops.OP_TABLE[kind](nd, [xb], None, ctx)[0]
    conv = LayerNode(plain[kind], nd.name, nd.bottoms, nd.tops, params)
    y = torch_ops.OP_TABLE[conv.type](conv, [xb], None, ctx)[0]
    assert torch.equal(fused, torch.nn.functional.pixel_shuffle(y, 2))


# --- weights --------------------------------------------------------------

@pytest.mark.parametrize("variant", ["rife", "rife-anime"])
def test_weights_from_jax_equal_prepare_weights(tmp_path, variant):
    """``weights_from_jax`` maps ``jax_ops.prepare_weights`` (the
    InnerProducts' (in, out) ``dense`` included) back to what
    ``prepare_weights`` makes of the raw weights, on the v1 graphs."""
    from rife_tpu.models.zoo import load_model

    model = load_model(str(write_v1_params(tmp_path, (8, 8, 8, 4), variant)))
    n_ip = 0
    for net in model.nets.values():
        tree = jax_ops.prepare_weights(net.graph, net.weights)
        tree = {k: {n: None if a is None else np.asarray(a)
                    for n, a in e.items()} for k, e in tree.items()}
        got = weights_from_jax(net.graph, tree)
        want = torch_ops.prepare_weights(net.graph, net.weights)
        assert got.keys() == want.keys()
        for name, e in want.items():
            assert got[name].keys() == e.keys(), name
            for k, a in e.items():
                b = got[name][k]
                assert (a is None) == (b is None), (name, k)
                if a is not None:
                    assert torch.equal(a, b), (name, k)
        n_ip += sum(n.type == "InnerProduct" for n in net.graph.nodes)
    assert n_ip > 0
