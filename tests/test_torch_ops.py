"""Each kind of rife_tpu_torch.ops.torch_ops.OP_TABLE against the jax_ops
handler of the same name, on the same node and weights (CPU).

Inputs are made with numpy from a seed; JAX runs NHWC, the port NCHW, and
results are compared after the layout change.  Tolerance: f32 atol 1e-6
where the op sums (same op order, the two backends may contract or reorder
a few roundings); bitwise where the op only moves data or the JAX op is
bitwise.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.graph.executor import Executor
from rife_tpu.graph.ir import LayerNode
from rife_tpu.graph.param import parse_param
from rife_tpu.graph.weights import LayerWeights, synthesize_weights
from rife_tpu.ops import frame as jframe
from rife_tpu.ops import jax_ops
from rife_tpu_torch.engine.session import rewrite_flownet
from rife_tpu_torch.models.v46_arch import write_flownet_param
from rife_tpu_torch.ops import frame as tframe
from rife_tpu_torch.ops import torch_ops
from rife_tpu_torch.ops import warp as W
from torch_jax_weights import weights_from_jax

RNG = np.random.default_rng(21)
ATOL = 1e-6


def node(kind, n_in, params, n_out=1):
    return LayerNode(kind, f"t_{kind}", [f"in{i}" for i in range(n_in)],
                     [f"out{i}" for i in range(n_out)], params)


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def to_nhwc(t):
    return np.moveaxis(t.float().numpy(), 1, -1)


def run_both(nd, ins, raw=None, ctx=None):
    """Run ``nd`` through both tables; returns (jax outs, port outs), NHWC."""
    ctx = dict(ctx or {})
    graph = SimpleNamespace(nodes=[nd])
    raw = raw or {}
    jctx = {**ctx, "w": jax_ops.prepare_weights(graph, raw)}
    tctx = {**ctx, "w": torch_ops.prepare_weights(graph, raw)}
    j = jax_ops.OP_TABLE[nd.type](nd, [jnp.asarray(x) for x in ins],
                                  raw.get(nd.name), jctx)
    t = torch_ops.OP_TABLE[nd.type](nd, [to_nchw(x) for x in ins],
                                    raw.get(nd.name), tctx)
    assert len(j) == len(t)
    return [np.asarray(a, np.float32) for a in j], [to_nhwc(b) for b in t]


def close(j, t, atol=ATOL):
    for a, b in zip(j, t):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def same(j, t):
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)


def rand(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def test_op_table_kinds():
    """Every kind of ``jax_ops.OP_TABLE`` but ``rife.WarpCatConv`` (the
    TPU's ``RIFE_TPU_FUSE_WARPCAT`` rewrite, not ported: ROADMAP "Not to
    port")."""
    assert set(torch_ops.OP_TABLE) == {
        "Convolution", "ConvolutionCat", "Deconvolution", "rife.ConvPS",
        "rife.DeconvPS", "InnerProduct", "Pooling", "UnaryOp",
        "PixelShuffle", "Interp", "Concat", "Crop", "Slice", "Split",
        "BinaryOp", "Eltwise", "Sigmoid", "rife.Warp", "rife.WarpDs4",
        "rife.WarpPair", "rife.WarpDs4Pair", "rife.WarpDs2",
        "rife.RenderBlend", "PReLU", "ReLU", "Clip",
    }
    assert set(jax_ops.OP_TABLE) - set(torch_ops.OP_TABLE) == {
        "rife.WarpCatConv"}


def test_unported_kind_raises():
    """A kind outside the table (``rife.WarpCatConv``, left out on purpose)
    raises in ``Executor.run``."""
    g = SimpleNamespace(
        nodes=[LayerNode("Input", "x", [], ["x"]),
               LayerNode("rife.WarpCatConv", "r", ["x"], ["y"])],
        required_nodes=lambda outs, given: [0, 1])
    ex = Executor(g, torch_ops.OP_TABLE, {})
    with pytest.raises(NotImplementedError, match="rife.WarpCatConv"):
        ex.run({"x": torch.zeros(1, 1, 2, 2)}, ["y"])


@pytest.mark.parametrize("scale", [2.0, 4.0, 8.0, 0.5, 0.25, 0.125])
@pytest.mark.parametrize("c", [1, 6, 16])
def test_interp(scale, c):
    h, w = (6, 10) if scale > 1 else (32, 48)
    nd = node("Interp", 1, {0: 2, 1: scale, 2: scale})
    close(*run_both(nd, [rand(2, h, w, c)]))


def test_interp_bf16_bitwise():
    x = rand(2, 8, 12, 6)
    for scale in (2.0, 0.5):
        nd = node("Interp", 1, {0: 2, 1: scale, 2: scale})
        j = jax_ops.OP_TABLE["Interp"](
            nd, [jnp.asarray(x).astype(jnp.bfloat16)], None, {})[0]
        t = torch_ops.OP_TABLE["Interp"](
            nd, [to_nchw(x).to(torch.bfloat16)], None, {})[0]
        np.testing.assert_array_equal(to_nhwc(t), np.asarray(j, np.float32))


def test_interp_other_ratio_raises():
    nd = node("Interp", 1, {0: 2, 1: 1.5, 2: 1.5})
    with pytest.raises(NotImplementedError):
        torch_ops.OP_TABLE["Interp"](nd, [torch.zeros(1, 1, 4, 4)], None, {})


def _conv_node(kind, cin, cout, stride, n_in=1, extra=None):
    return node(kind, n_in, {0: cout, 1: 3, 3: stride, 4: 1, 5: 1,
                             6: cout * cin * 9, 9: 2, -23310: [0.2],
                             **(extra or {})})


def _conv_raw(nd, cin, cout):
    return {nd.name: LayerWeights(weight=rand(cout, cin, 3, 3, scale=0.3),
                                  bias=rand(cout, scale=0.1))}


@pytest.mark.parametrize("stride", [1, 2])
def test_convolution_fused_leaky(stride):
    nd = _conv_node("Convolution", 8, 12, stride)
    close(*run_both(nd, [rand(2, 16, 20, 8, scale=0.5)], _conv_raw(nd, 8, 12)))


def test_convolution_cat():
    nd = _conv_node("ConvolutionCat", 8, 12, 2, n_in=3)
    ins = [rand(2, 16, 20, c, scale=0.5) for c in (3, 1, 4)]
    close(*run_both(nd, ins, _conv_raw(nd, 8, 12)))


def _deconv(kind, cin, extra=None):
    nd = node(kind, 1, {0: 24, 1: 4, 3: 2, 4: 1, 5: 1, 6: cin * 24 * 16,
                        **(extra or {})})
    raw = {nd.name: LayerWeights(weight=rand(cin, 24, 4, 4, scale=0.2),
                                 bias=rand(24, scale=0.1))}
    return nd, raw


def test_deconv_then_pixelshuffle():
    nd, raw = _deconv("Deconvolution", 10)
    x = rand(2, 5, 7, 10, scale=0.5)
    j, t = run_both(nd, [x], raw)
    close(j, t)
    ps = node("PixelShuffle", 1, {0: 2})
    same(*run_both(ps, [j[0]]))


def test_deconv_ps():
    nd, raw = _deconv("rife.DeconvPS", 10, {25: 2})
    j, t = run_both(nd, [rand(2, 5, 7, 10, scale=0.5)], raw)
    assert j[0].shape == (2, 20, 28, 6)
    close(j, t)


def test_eltwise_coefficients():
    nd = node("Eltwise", 2, {0: 1, -23301: [1.0, 4.0]})
    close(*run_both(nd, [rand(2, 8, 8, 4), rand(2, 8, 8, 4)]))
    plain = node("Eltwise", 2, {0: 1})
    close(*run_both(plain, [rand(2, 8, 8, 1), rand(2, 8, 8, 1)]))


def test_crop_slice_concat_split():
    x = rand(2, 6, 8, 6)
    same(*run_both(node("Crop", 1, {-23309: [4], -23310: [5],
                                     -23311: [0]}), [x]))
    same(*run_both(node("Crop", 1, {-23309: [0], -23310: [4],
                                     -23311: [0]}), [x]))
    same(*run_both(node("Slice", 1, {-23300: [2, 4], 1: 0}, n_out=2), [x]))
    same(*run_both(node("Slice", 1, {1: 0}, n_out=3), [x]))
    same(*run_both(node("Concat", 3, {0: 0}),
                   [x, rand(2, 6, 8, 1), rand(2, 6, 8, 3)]))
    same(*run_both(node("Split", 1, {}, n_out=3), [x]))


@pytest.mark.parametrize("params,n_in", [
    ({0: 2, 1: 1, 2: 8.0}, 1),     # flow x scale
    ({0: 2, 1: 1, 2: 0.25}, 1),
    ({0: 7, 1: 1, 2: 1.0}, 1),     # 1 - mask
    ({0: 0}, 2),                   # residual add
    ({0: 2}, 2),                   # render mul
])
def test_binaryop(params, n_in):
    ins = [rand(2, 6, 8, 3) for _ in range(n_in)]
    same(*run_both(node("BinaryOp", n_in, params), ins))


def test_sigmoid():
    close(*run_both(node("Sigmoid", 1, {}), [rand(2, 6, 8, 1, scale=4.0)]))


@pytest.fixture(scope="module")
def mini_graph(tmp_path_factory):
    d = write_flownet_param(tmp_path_factory.mktemp("ops"), (16, 16, 16, 16))
    g = parse_param(d / "flownet.param")
    return rewrite_flownet(g, synthesize_weights(g, "rife-v4.6/flownet"))


def test_weights_from_jax_equals_prepare_weights(mini_graph):
    g, raw = mini_graph
    tree = {k: {n: None if a is None else np.asarray(a)
                for n, a in v.items()}
            for k, v in jax_ops.prepare_weights(g, raw).items()}
    got = weights_from_jax(g, tree)
    want = torch_ops.prepare_weights(g, raw)
    assert got.keys() == want.keys() and len(want) == 44
    for name, entry in want.items():
        assert got[name].keys() == entry.keys()
        for key, t in entry.items():
            assert torch.equal(got[name][key], t), (name, key)


def test_frame_ops_match_jax():
    u8 = RNG.integers(0, 256, (2, 30, 40, 3), np.uint8)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        j = np.asarray(jframe.preprocess(jnp.asarray(u8), 32, 64, jd),
                       np.float32)
        t = tframe.preprocess(torch.from_numpy(u8), 32, 64, td)
        assert t.is_contiguous()  # the warp kernels take NCHW planes
        np.testing.assert_array_equal(to_nhwc(t), j)
    x = RNG.uniform(-0.1, 1.1, (2, 32, 64, 3)).astype(np.float32)
    j = np.asarray(jframe.postprocess(jnp.asarray(x), 30, 40))
    np.testing.assert_array_equal(
        tframe.postprocess(to_nchw(x), 30, 40).numpy(), j)
    planes = np.ascontiguousarray(x.transpose(0, 1, 3, 2))
    j = np.asarray(jframe.postprocess_planar(jnp.asarray(planes), 30, 40))
    np.testing.assert_array_equal(
        tframe.postprocess_planar(torch.from_numpy(planes), 30, 40).numpy(), j)
    ts = np.array([0.25, 0.5], np.float32)
    j = np.asarray(jframe.timestep_plane(jnp.asarray(ts), 2, 8, 16))
    t = tframe.timestep_plane(torch.from_numpy(ts), 2, 8, 16)
    np.testing.assert_array_equal(to_nhwc(t), j)


def _warp_inputs(b=2, h=16, w=24):
    img = lambda: (RNG.integers(0, 256, (b, 3, h, w)) / 255.0).astype(  # noqa: E731
        np.float32)
    flow = lambda: rand(b, 2, h, w, scale=3.0)  # noqa: E731
    return [torch.from_numpy(x) for x in (img(), flow(), img(), flow())]


def test_warp_ops_on_cpu_take_the_twins():
    ia, fa, ib, fb = _warp_inputs()
    ctx = {"u8_image_blobs": frozenset(("in0", "in2"))}
    before = dict(W.LAUNCHES)
    pair = torch_ops.OP_TABLE["rife.WarpPair"](
        node("rife.WarpPair", 4, {}), [ia, fa, ib, fb], None, ctx)
    for got, want in zip(pair, W.warp_pair_ref(ia, fa, ib, fb)):
        assert torch.equal(got, want)
    ds4 = torch_ops.OP_TABLE["rife.WarpDs4Pair"](
        node("rife.WarpDs4Pair", 4, {}), [ia, fa, ib, fb], None, ctx)
    for got, want in zip(ds4, W.warp_ds4_pair_ref(ia, fa, ib, fb)):
        assert torch.equal(got, want)
    mask = torch.from_numpy(RNG.uniform(0, 1, (2, 1, 16, 24)).astype(np.float32))
    rb = node("rife.RenderBlend", 5, {})
    planar = torch_ops.OP_TABLE["rife.RenderBlend"](
        rb, [ia, fa, ib, fb, mask], None,
        {**ctx, "planar_outputs": frozenset(("out0",))})[0]
    nchw = torch_ops.OP_TABLE["rife.RenderBlend"](
        rb, [ia, fa, ib, fb, mask], None, ctx)[0]
    assert torch.equal(planar, W.warp_render_ref(ia, fa, ib, fb, mask[:, 0]))
    assert torch.equal(nchw, planar.permute(0, 2, 1, 3))
    assert W.LAUNCHES == before  # CPU tensors never count a launch


def test_unpaired_warp_needs_u8_image():
    """An unpaired warp takes the single-warp kernel's u8 mode (K4) only on
    a frame copy; any other image takes its float mode (K1/K2)."""
    ia, fa, _, _ = _warp_inputs()
    nd = node("rife.Warp", 2, {})
    got = torch_ops.OP_TABLE["rife.Warp"](
        nd, [ia, fa], None, {"u8_image_blobs": frozenset(("in0",))})[0]
    assert torch.equal(got, W.warp_u8_ref(ia, fa))
    got = torch_ops.OP_TABLE["rife.Warp"](nd, [ia, fa], None, {})[0]
    assert torch.equal(got, W.warp_feat_ref(ia, fa))


def test_unpaired_warp_ds4_on_tap_grid():
    ia, fa, _, _ = _warp_inputs()
    nd = node("rife.WarpDs4", 2, {})
    ctx = {"u8_image_blobs": frozenset(("in0",))}
    got = torch_ops.OP_TABLE["rife.WarpDs4"](nd, [ia, fa], None, ctx)[0]
    assert torch.equal(got, W.warp_ds4_u8_ref(ia, fa))
    feat = torch_ops.OP_TABLE["rife.WarpDs4"](nd, [ia, fa], None, {})[0]
    assert torch.equal(feat, W.half_sum2(W.warp_feat_ref(
        ia, W.ds4_positions(fa), abs_pos=True)))
    assert feat.shape == (2, 3, 4, 6)


@pytest.mark.parametrize("n_slope", [1, 5])
def test_prelu_standalone(n_slope):
    nd = node("PReLU", 1, {0: n_slope})
    raw = {nd.name: LayerWeights(slope=RNG.uniform(0, 0.5, n_slope).astype(
        np.float32))}
    same(*run_both(nd, [rand(2, 6, 8, 5)], raw))


@pytest.mark.parametrize("params", [{}, {0: 0.1}])
def test_relu(params):
    same(*run_both(node("ReLU", 1, params), [rand(2, 6, 8, 4)]))


def test_clip_and_sub():
    same(*run_both(node("Clip", 1, {0: 0.0, 1: 1.0}),
                   [rand(2, 6, 8, 3, scale=2.0)]))
    same(*run_both(node("BinaryOp", 1, {0: 1, 1: 1, 2: 1.0}),
                   [rand(2, 6, 8, 3)]))
    same(*run_both(node("BinaryOp", 2, {0: 1}),
                   [rand(2, 6, 8, 3), rand(2, 6, 8, 3)]))
    # the v2 fusionnet's mask (1 channel) times a warped frame (3)
    same(*run_both(node("BinaryOp", 2, {0: 2}),
                   [rand(2, 6, 8, 3), rand(2, 6, 8, 1)]))


@pytest.mark.parametrize("kind", ["Convolution", "Deconvolution"])
def test_fused_prelu_on_cudnn_sites(kind):
    """ACT_PRELU_CH (fuse_prelu_activations) on the convs that stay on
    cuDNN: the XLA form, bias and slope in the storage dtype."""
    if kind == "Convolution":
        nd = _conv_node(kind, 8, 12, 1, extra={9: 100})
        raw = _conv_raw(nd, 8, 12)
        x = rand(2, 10, 12, 8, scale=0.5)
        cout = 12
    else:
        nd = node(kind, 1, {0: 6, 1: 4, 3: 2, 4: 1, 5: 1, 6: 10 * 6 * 16,
                            9: 100})
        raw = {nd.name: LayerWeights(weight=rand(10, 6, 4, 4, scale=0.2),
                                     bias=rand(6, scale=0.1))}
        x = rand(2, 5, 7, 10, scale=0.5)
        cout = 6
    raw[nd.name].slope = RNG.uniform(0.05, 0.4, cout).astype(np.float32)
    close(*run_both(nd, [x], raw))


def test_planar_sites_take_the_conv_twin():
    """With ctx ``planar_convs`` a gated site runs ``conv3x3`` (its twin on
    the CPU): same result as the XLA-form op in f32."""
    nd = _conv_node("ConvolutionCat", 8, 12, 2, n_in=3, extra={9: 100})
    raw = _conv_raw(nd, 8, 12)
    raw[nd.name].slope = np.full(12, 0.25, np.float32)
    ins = [rand(2, 16, 20, c, scale=0.5) for c in (3, 1, 4)]
    j, t = run_both(nd, ins, raw, {"planar_convs": True, "planar_all": True})
    close(j, t, atol=2e-6)
    dnd = node("Deconvolution", 1, {0: 4, 1: 4, 3: 2, 4: 1, 5: 1,
                                    6: 12 * 4 * 16})
    draw = {dnd.name: LayerWeights(weight=rand(12, 4, 4, 4, scale=0.2),
                                   bias=rand(4, scale=0.1))}
    j, t = run_both(dnd, [rand(2, 5, 7, 12)], draw,
                    {"planar_convs": True, "planar_all": True})
    close(j, t, atol=2e-6)
