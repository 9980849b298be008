"""The ``.bin`` the benchmark writes reads back through its own reader and
the program's, and the weights follow the seed."""

import json

import numpy as np
import torch

from portbench import ncnn, weights
from portbench.models import v23_arch
from portbench.seeds import derive
from portbench.testing import MINI_WIDTHS, ROOT

CFG = json.loads((ROOT / "portbench/configs/rife-v2.3-arch.json").read_text())


def _cfg():
    return dict(CFG, widths=MINI_WIDTHS["rife-v2.3-arch"])


def test_bin_round_trip(tmp_path):
    from rife_tpu_torch.graph.param import parse_param
    from rife_tpu_torch.graph.weights import load_bin

    md, scales = weights.write_model(_cfg(), tmp_path, 2 ** 40 + 3, "cpu")
    for net in CFG["nets"]:
        nodes = ncnn.parse_param(md / f"{net}.param")
        mine = ncnn.read_bin(nodes, md / f"{net}.bin")
        again = weights.layer_weights(nodes, weights.draw(
            nodes, derive(2 ** 40 + 3, f"weights:{CFG['name']}:{net}"),
            "cpu"), scales[net])
        theirs = load_bin(parse_param(md / f"{net}.param"), md / f"{net}.bin")
        assert set(mine) == set(theirs) == set(again)
        for name, lw in mine.items():
            for k in ("weight", "bias", "slope"):
                a, b, c = (getattr(x[name], k) for x in (mine, theirs, again))
                assert (a is None) == (b is None) == (c is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
                    np.testing.assert_array_equal(a, c)


def test_weights_follow_the_seed():
    nodes = ncnn.parse_param_text(v23_arch.flownet_param_text((8, 8, 8, 8, 4)))
    a, b, c = (weights.layer_weights(nodes, weights.draw(nodes, s, "cpu"), 1.0)
               for s in (5, 5, 6))
    name = "block0_conv0"
    np.testing.assert_array_equal(a[name].weight, b[name].weight)
    assert not np.array_equal(a[name].weight, c[name].weight)
    w = a[name].weight
    # every tap weighted, by an envelope that no flip or transpose keeps
    assert np.count_nonzero(w) == w.size
    for other in (w[..., ::-1, :], w[..., ::-1], w.swapaxes(-1, -2)):
        assert np.abs(other - w).max() > 0.1 * np.abs(w).max()
    for node in nodes:
        if node.type == "Deconvolution":
            d = a[node.name].weight
            assert np.count_nonzero(d) == d.size
            assert not np.allclose(d, d[..., ::-1, ::-1], atol=1e-3)
            assert not np.allclose(d, d.swapaxes(-1, -2), atol=1e-3)
    assert np.all(a["block0_conv0_prelu"].slope == 0.25)
    assert a[name].weight.dtype == np.float32
    assert np.array_equal(w, w.astype(np.float16).astype(np.float32))


def test_fp16_flag_layout():
    nodes = ncnn.parse_param_text(v23_arch.flownet_param_text((8, 8, 8, 8, 4)))
    w = weights.layer_weights(nodes, weights.draw(nodes, 9, "cpu"), 1.0)
    raw = ncnn.bin_bytes(nodes, w)
    assert int(np.frombuffer(raw[:4], "<u4")[0]) == ncnn.FLAG_FP16
    assert len(raw) % 4 == 0
    assert torch.is_tensor(torch.as_tensor(w["block0_conv0"].weight))


def test_inner_product_bin_round_trip(tmp_path):
    """InnerProduct weights in the zoo's fp16-flagged format, with and
    without a bias, read back by the benchmark and by the program."""
    from rife_tpu_torch.graph.param import parse_param
    from rife_tpu_torch.graph.weights import load_bin

    text = ("7767517\n4 4\nInput x 0 1 x\n"
            "InnerProduct fc1 1 1 x a 0=3 1=1 2=15\n"
            "PReLU p 1 1 a b 0=1\n"
            "InnerProduct fc2 1 1 b c 0=5 1=0 2=15 9=4\n")
    nodes = ncnn.parse_param_text(text)
    assert ncnn.weight_shape(nodes[1]) == (3, 5)
    assert ncnn.bias_size(nodes[1]) == 3 and ncnn.bias_size(nodes[3]) == 0
    w = weights.layer_weights(nodes, weights.draw(nodes, 4, "cpu"), 1.0)
    w["fc1"].bias = np.arange(3, dtype=np.float32)
    (tmp_path / "n.param").write_text(text)
    (tmp_path / "n.bin").write_bytes(ncnn.bin_bytes(nodes, w))
    mine = ncnn.read_bin(nodes, tmp_path / "n.bin")
    theirs = load_bin(parse_param(tmp_path / "n.param"), tmp_path / "n.bin")
    for name in ("fc1", "fc2"):
        np.testing.assert_array_equal(mine[name].weight, w[name].weight)
        np.testing.assert_array_equal(theirs[name].weight, w[name].weight)
    np.testing.assert_array_equal(mine["fc1"].bias, [0, 1, 2])
    np.testing.assert_array_equal(theirs["fc1"].bias, [0, 1, 2])
    assert mine["fc2"].bias is None and mine["p"].slope.tolist() == [0.25]


def test_inner_product_draw_leaves_other_bytes():
    """The gates' weights come from a stream of their own, drawn after the
    convolutions': a graph's convolutions draw the same with or without
    them."""
    conv = "Convolution c 1 1 x y 0=4 1=3 4=1 5=0 6=108\n"
    plain = ncnn.parse_param_text("7767517\n2 2\nInput x 0 1 x\n" + conv)
    gated = ncnn.parse_param_text(
        "7767517\n4 4\nInput x 0 1 x\n" + conv
        + "Pooling p 1 1 y z 0=1 4=1\n"
        "InnerProduct fc 1 1 z g 0=4 1=0 2=16 9=4\n")
    a, b = weights.draw(plain, 8, "cpu"), weights.draw(gated, 8, "cpu")
    assert torch.equal(a["c"], b["c"]) and set(b) == {"c", "fc"}
    assert b["fc"].shape == (4, 4)
