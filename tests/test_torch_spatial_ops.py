"""graph/spatial.py's SpatialExecutor, one layer kind at a time, and the
sharded warp (ops/warp.py warp_spatial) against the unsharded warp, on the
CPU (the kernels' plain twins).

Each case is a one-node graph run by the port's Executor and by a
SpatialExecutor over 2-4 shards of the CPU, with row boundaries at the edge
cases (one-row shards, shards narrower than the halo, uneven shards).  The
data-moving kinds, the warps and the resizes must agree bit for bit; the
convolutions and the pooling sum the same products on a window of rows,
in an order that oneDNN may choose by shape, so they are held to f32
atol 1e-6 (the pooling's partial sums change its f32 order by design).
"""

import numpy as np
import pytest
import torch

from rife_tpu_torch.graph.executor import Executor
from rife_tpu_torch.graph.ir import LayerNode
from rife_tpu_torch.graph.rewrite import _rebuild
from rife_tpu_torch.graph import spatial
from rife_tpu_torch.graph.spatial import SpatialExecutor, shard_bounds
from rife_tpu_torch.graph.weights import LayerWeights
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import torch_ops
from rife_tpu_torch.ops import warp as W

CPU = torch.device("cpu")
RNG = np.random.default_rng(10)


def rand(*shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy((RNG.normal(size=shape) * scale).astype(
        np.float32)).to(dtype)


def graph_of(kind, params, n_in, n_out=1, ins=None):
    ins = ins or [f"in{i}" for i in range(n_in)]
    nodes = [LayerNode("Input", f"input_{b}", [], [b], {}) for b in ins]
    nodes.append(LayerNode(kind, "t", list(ins),
                           [f"out{i}" for i in range(n_out)], params))
    return _rebuild(nodes, list(ins))


def run_both(graph, inputs, raw=None, n_shards=4, align=1, ctx=None,
             dtype=torch.float32):
    """(Executor's outputs, SpatialExecutor's outputs) of every top; the
    shards' boundaries at multiples of ``align`` rows (``spatial.ALIGN``
    lowered from 32 to reach one-row and uneven shards at test sizes)."""
    raw = raw or {}
    w = torch_ops.prepare_weights(graph, raw, dtype)
    ex = Executor(graph, torch_ops.OP_TABLE, raw, ctx=dict(ctx or {}))
    outs = [t for n in graph.nodes if n.type != "Input" for t in n.tops]
    want = ex.run(inputs, outs, {"w": w})
    sp = SpatialExecutor(ex, [CPU] * n_shards, {CPU: w})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spatial, "ALIGN", align)
        got = sp.run(inputs, outs, {"w": w})
    return want, got


def same(want, got):
    for a, b in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


def close(want, got, atol=1e-6):
    for a, b in zip(want, got):
        assert a.shape == b.shape
        torch.testing.assert_close(b, a, rtol=0, atol=atol)


def test_shard_bounds(monkeypatch):
    assert shard_bounds(128, 4) == [0, 32, 64, 96, 128]
    assert shard_bounds(96, 8) == [0, 32, 64, 96]  # five shards idle
    assert shard_bounds(64, 4) == [0, 32, 64]
    with pytest.raises(ValueError, match="multiple of 32"):
        shard_bounds(100, 4)
    monkeypatch.setattr(spatial, "ALIGN", 1)
    assert shard_bounds(6, 4) == [0, 1, 3, 4, 6]


def _conv(kind, cin, cout, k=3, stride=1, pad=1, act=2, extra=None,
          n_in=1):
    params = {0: cout, 1: k, 3: stride, 4: pad, 5: 1, 6: cout * cin * k * k,
              9: act, -23310: [0.2], **(extra or {})}
    g = graph_of(kind, params, n_in)
    raw = {"t": LayerWeights(weight=rand(cout, cin, k, k, scale=0.3).numpy(),
                             bias=rand(cout, scale=0.1).numpy())}
    return g, raw


# (height, shards, align): one-row shards, a shard thinner than a halo
CONV_CUTS = [(6, 4, 1), (16, 3, 2), (12, 4, 2)]


@pytest.mark.parametrize("cut", CONV_CUTS)
@pytest.mark.parametrize("stride", [1, 2])
def test_convolution(stride, cut):
    h, n, align = cut
    if stride == 2 and align % 2:
        align = 2
        h = 8
    g, raw = _conv("Convolution", 5, 7, stride=stride)
    close(*run_both(g, {"in0": rand(2, 5, h, 9, scale=0.5)}, raw, n, align))


@pytest.mark.parametrize("k,pad", [(1, 0), (5, 2)])
def test_convolution_other_windows(k, pad):
    g, raw = _conv("Convolution", 4, 6, k=k, pad=pad)
    close(*run_both(g, {"in0": rand(1, 4, 12, 7)}, raw, 4, 1))


def test_convolution_cat_s2():
    g, raw = _conv("ConvolutionCat", 8, 6, stride=2, n_in=3)
    ins = {f"in{i}": rand(2, c, 16, 10, scale=0.5)
           for i, c in enumerate((3, 1, 4))}
    close(*run_both(g, ins, raw, 4, 2))


def test_conv_ps():
    g, raw = _conv("rife.ConvPS", 6, 16, extra={25: 2})
    want, got = run_both(g, {"in0": rand(2, 6, 10, 8)}, raw, 3, 1)
    assert got[0].shape == (2, 4, 20, 16)
    close(want, got)


def _deconv(kind, cin, cout, extra=None):
    g = graph_of(kind, {0: cout, 1: 4, 3: 2, 4: 1, 5: 1,
                        6: cin * cout * 16, 9: 1, **(extra or {})}, 1)
    raw = {"t": LayerWeights(weight=rand(cin, cout, 4, 4, scale=0.2).numpy(),
                             bias=rand(cout, scale=0.1).numpy())}
    return g, raw


@pytest.mark.parametrize("cut", [(5, 4, 1), (8, 3, 2)])
def test_deconvolution(cut):
    h, n, align = cut
    g, raw = _deconv("Deconvolution", 6, 8)
    want, got = run_both(g, {"in0": rand(2, 6, h, 7)}, raw, n, align)
    assert got[0].shape == (2, 8, 2 * h, 14)
    close(want, got)


def test_deconv_ps():
    g, raw = _deconv("rife.DeconvPS", 6, 16, {25: 2})
    want, got = run_both(g, {"in0": rand(1, 6, 6, 5)}, raw, 4, 1)
    assert got[0].shape == (1, 4, 24, 20)
    close(want, got)


def test_planar_sites_see_the_whole_blob(monkeypatch):
    """With the gate between a shard's rows and the blob's, every shard
    takes conv3x3 (here its twin), as the unsharded site does."""
    calls = []
    real = CV.conv3x3

    def spy(*args, **kw):
        calls.append(args[0][0].shape[2])
        return real(*args, **kw)

    monkeypatch.setattr(CV, "conv3x3", spy)
    monkeypatch.setattr(CV, "CONV_MIN_HW", 64 * 8)
    g, raw = _conv("Convolution", 8, 8)
    want, got = run_both(g, {"in0": rand(1, 8, 64, 8)}, raw, 4, 16,
                         ctx={"planar_convs": True})
    close(want, got)
    assert calls == [64, 17, 18, 18, 17]  # unsharded, then each window


@pytest.mark.parametrize("scale", [2, 4, 8, 0.5, 0.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interp_bilinear(scale, dtype):
    g = graph_of("Interp", {0: 2, 1: scale, 2: scale}, 1)
    h = 16 if scale < 1 else 6
    align = int(1 / scale) if scale < 1 else 1
    same(*run_both(g, {"in0": rand(2, 3, h, 8, dtype=dtype)}, None, 4,
                   align, dtype=dtype))


@pytest.mark.parametrize("scale", [2, 0.5])
def test_interp_nearest(scale):
    g = graph_of("Interp", {0: 1, 1: scale, 2: scale}, 1)
    same(*run_both(g, {"in0": rand(1, 3, 8, 6)}, None, 3, 2))


def test_interp_other_kind_raises():
    g = graph_of("Interp", {0: 3, 1: 2.0, 2: 2.0}, 1)
    with pytest.raises(NotImplementedError, match="resize_type 3"):
        run_both(g, {"in0": rand(1, 3, 8, 6)}, None, 2, 2)


def test_pooling_sums_partials_in_f32():
    g = graph_of("Pooling", {0: 1, 4: 1}, 1)
    want, got = run_both(g, {"in0": rand(2, 6, 12, 5)}, None, 4, 1)
    assert got[0].shape == (2, 6)
    close(want, got)
    g16 = graph_of("Pooling", {0: 1, 4: 1}, 1)
    x = rand(2, 6, 12, 5, dtype=torch.bfloat16)
    want, got = run_both(g16, {"in0": x}, None, 4, 1, dtype=torch.bfloat16)
    ulp = torch.pow(2.0, torch.floor(torch.log2(want[0].float().abs())) - 7)
    assert bool(((got[0].float() - want[0].float()).abs() <= ulp).all())


def test_se_gate_broadcast():
    """The v1 SE pattern: pool -> InnerProduct -> BinaryOp into the map."""
    ins = ["x"]
    nodes = [LayerNode("Input", "input_x", [], ["x"], {}),
             LayerNode("Pooling", "pool", ["x"], ["p"], {0: 1, 4: 1}),
             LayerNode("InnerProduct", "fc", ["p"], ["f"],
                       {0: 4, 1: 1, 2: 16, 9: 1}),
             LayerNode("BinaryOp", "mul", ["x", "f"], ["y"], {0: 2})]
    g = _rebuild(nodes, ins)
    raw = {"fc": LayerWeights(weight=rand(4, 4, scale=0.3).numpy(),
                              bias=rand(4, scale=0.1).numpy())}
    close(*run_both(g, {"x": rand(2, 4, 12, 6)}, raw, 3, 2))


@pytest.mark.parametrize("kind,params,n_in,n_out", [
    ("Sigmoid", {}, 1, 1),
    ("ReLU", {0: 0.1}, 1, 1),
    ("Clip", {0: -0.5, 1: 0.5}, 1, 1),
    ("Eltwise", {0: 1, -23301: [1.0, 2.0]}, 2, 1),
    ("BinaryOp", {0: 0}, 2, 1),
    ("UnaryOp", {0: 0}, 1, 1),
    ("PixelShuffle", {0: 2}, 1, 1),
    ("Concat", {0: 0}, 2, 1),
    ("Slice", {1: 0, -23300: [1, -233]}, 1, 2),
    ("Split", {}, 1, 2),
    ("Crop", {-23309: [1], -23310: [3], -23311: [0]}, 1, 1),
])
def test_no_halo_kinds(kind, params, n_in, n_out):
    g = graph_of(kind, params, n_in, n_out)
    ins = {f"in{i}": rand(2, 4, 12, 6) for i in range(n_in)}
    want, got = run_both(g, ins, None, 4, 1)
    if kind == "Sigmoid":
        # f32 torch.sigmoid on the CPU takes a vector path and a scalar
        # tail by tensor size: 1 ulp apart on a few values
        close(want, got, atol=2e-7)
    else:
        same(want, got)


@pytest.mark.parametrize("kind,params", [
    ("Concat", {0: 1}),
    ("Crop", {-23309: [1], -23310: [3], -23311: [1]}),
    ("Slice", {1: 1, -23300: [1, -233]}),
])
def test_cut_along_the_height_raises(kind, params):
    g = graph_of(kind, params, 2 if kind == "Concat" else 1,
                 2 if kind == "Slice" else 1)
    ins = {f"in{i}": rand(1, 2, 8, 4)
           for i in range(2 if kind == "Concat" else 1)}
    with pytest.raises(NotImplementedError, match="height"):
        run_both(g, ins, None, 2, 4)


# --- the sharded warp -------------------------------------------------------

def frame(b, h, w, dtype):
    """A u8-valued image as preprocess makes it."""
    u = torch.from_numpy(RNG.integers(0, 256, (b, 3, h, w)).astype(np.uint8))
    return (u.to(dtype) * torch.tensor(1 / 255, dtype=dtype)).contiguous()


def flow(b, h, w, dtype, shift=6.0):
    f = rand(b, 2, h, w, scale=4.0)
    f[:, 1, : h // 4] += shift  # rows that read other shards' rows
    return f.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u8", [True, False])
@pytest.mark.parametrize("ds4", [False, True])
def test_warp_spatial_rows_equal_the_unsharded_warp(dtype, u8, ds4):
    b, h, w = 2, 32, 20
    img = frame(b, h, w, dtype) if u8 else rand(b, 5, h, w, dtype=dtype)
    fl = flow(b, h, w, dtype)
    ref = W.warp_u8 if u8 else W.warp_feat
    if ds4:
        whole = W.half_sum2(ref(img, W.ds4_positions(fl), abs_pos=True))
    else:
        whole = ref(img, fl)
    for s, e in ((0, 8), (8, 12), (12, 32)):
        got = W.warp_spatial(img, fl[:, :, s:e], s, u8=u8, ds4=ds4)
        k = 4 if ds4 else 1
        assert torch.equal(got, whole[:, :, s // k:e // k])


WARP_CASES = {
    "rife.Warp": (["img", "flo"], 1),
    "rife.WarpDs4": (["img", "flo"], 1),
    "rife.WarpDs2": (["img", "flo"], 1),
    "rife.WarpPair": (["img", "flo", "img2", "flo2"], 2),
    "rife.WarpDs4Pair": (["img", "flo", "img2", "flo2"], 2),
    "rife.RenderBlend": (["img", "flo", "img2", "flo2", "mask"], 1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u8", [True, False])
@pytest.mark.parametrize("kind", list(WARP_CASES))
def test_warp_kinds_unfuse_bit_for_bit(kind, u8, dtype):
    """Each warp kind over 3 shards equals the unsharded op (which takes the
    pair, render, ds4-pair and ds2 kernels' twins for u8-origin frames)."""
    names, n_out = WARP_CASES[kind]
    b, h, w = 2, 48, 24
    inputs = {}
    for name in names:
        if name.startswith("img"):
            inputs[name] = frame(b, h, w, dtype) if u8 else rand(
                b, 3, h, w, dtype=dtype)
        elif name.startswith("flo"):
            inputs[name] = flow(b, h, w, dtype)
        else:
            inputs[name] = torch.sigmoid(rand(b, 1, h, w)).to(dtype)
    g = graph_of(kind, {}, len(names), n_out, ins=names)
    ctx = {"u8_image_blobs": frozenset(("img", "img2")) if u8 else ()}
    same(*run_both(g, inputs, None, 3, 8, ctx=ctx, dtype=dtype))
