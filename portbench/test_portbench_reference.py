"""The reference against the program on the CPU at a small size: the
program's float32 session (CPU kernels' twins) and the reference agree to
one u8 level; the check's numbers of a sound run are small."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import check, scene, weights
from portbench.reference.rife import Reference
from portbench.testing import MINI_WIDTHS, ROOT


@pytest.mark.parametrize("name", ["rife-v4.6-arch", "rife-v2.3-arch"])
def test_reference_matches_program_f32(tmp_path, name):
    from rife_tpu_torch import RIFE

    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg["widths"] = MINI_WIDTHS[name]
    clip = scene.clip(99, 4, 64, 96, 2, "cpu")
    md, _ = weights.write_model(cfg, tmp_path, 1234, "cpu", clip[:2])
    ref = Reference(md, cfg["family"], cfg["nets"], "cpu")
    want, flow = ref.pair(clip[:3], clip[1:4], 0.5)
    sess = RIFE(os.path.relpath(md), device="cpu", dtype=torch.float32)
    got = sess.process_batch(clip[:3].numpy(), clip[1:4].numpy(),
                             np.full(3, 0.5, np.float32))
    d = np.abs(got.astype(int) - want.numpy().astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999
    assert float(flow.std()) > 0.5  # the flow moves the frames
    assert max(check.mean_abs(torch.from_numpy(g), w)
               for g, w in zip(got, want)) < 0.01


def test_warp_by_hand():
    from portbench.reference.graph import warp

    img = torch.arange(12, dtype=torch.float32).view(1, 1, 3, 4)
    flow = torch.zeros(1, 2, 3, 4)
    flow[:, 0] = 0.5   # half a pixel right
    flow[0, 1, 2, 3] = 5.0  # far below: clamped to the last row
    out = warp(img, flow)
    assert out[0, 0, 0, 0] == 0.5 and out[0, 0, 1, 1] == 5.5
    assert out[0, 0, 0, 3] == 3.0  # the right border clamps
    assert out[0, 0, 2, 3] == 11.0


def _node(text):
    """One layer of a .param, parsed."""
    from portbench import ncnn

    return ncnn.parse_param_text(f"7767517\n2 2\nInput x 0 1 x\n{text}\n")[1]


def _one(text, xs, p=None, quant=None):
    from portbench.reference import graph

    return graph._node(_node(text), xs, p, quant)


def test_pooling_by_hand():
    x = torch.randn(2, 3, 5, 7, generator=torch.Generator().manual_seed(1))
    y, = _one("Pooling pool 1 1 x y 0=1 4=1", [x])
    assert y.shape == (2, 3)
    torch.testing.assert_close(y, x.sum((2, 3)) / 35, rtol=1e-6, atol=0)


def test_inner_product_by_hand():
    g = torch.Generator().manual_seed(2)
    x, w, b = (torch.randn(2, 6, generator=g), torch.randn(4, 6, generator=g),
               torch.randn(4, generator=g))
    y, = _one("InnerProduct fc 1 1 x y 0=4 1=1 2=24", [x],
              {"weight": w, "bias": b})
    torch.testing.assert_close(y, x @ w.T + b)
    y, = _one("InnerProduct fc 1 1 x y 0=4 1=0 2=24 9=4", [x],
              {"weight": w, "bias": None})
    torch.testing.assert_close(y, 1 / (1 + torch.exp(-(x @ w.T))))
    # the control rounds the weight as it rounds a convolution's
    y, = _one("InnerProduct fc 1 1 x y 0=4 1=0 2=24", [x],
              {"weight": w, "bias": None}, quant=torch.round)
    torch.testing.assert_close(y, x @ torch.round(w).T)


def test_unary_neg_and_binary_broadcast_by_hand():
    g = torch.Generator().manual_seed(3)
    m, v = torch.randn(2, 3, 4, 5, generator=g), torch.randn(2, 3, generator=g)
    y, = _one("UnaryOp neg 1 1 x y 0=1", [m])
    assert torch.equal(y, -m)
    want = m * v[:, :, None, None]
    assert torch.equal(_one("BinaryOp mul 2 1 x v y 0=2", [m, v])[0], want)
    assert torch.equal(_one("BinaryOp mul 2 1 v x y 0=2", [v, m])[0], want)
    assert torch.equal(_one("BinaryOp sub 2 1 v x y 0=1", [v, m])[0],
                       v[:, :, None, None] - m)
    with pytest.raises(ValueError):
        _one("BinaryOp mul 2 1 x v y 0=2", [m, v[:, :2]])


@pytest.mark.parametrize("text", [
    "Pooling pool 1 1 x y 0=0 4=1",        # max pooling
    "Pooling pool 1 1 x y 0=1",            # not global
    "Pooling pool 1 1 x y 0=1 4=1 7=1",    # adaptive
    "InnerProduct fc 1 1 x y 0=4 1=0 2=24 9=1",  # relu
    "InnerProduct fc 1 1 x y 0=4 1=0 2=24 8=1",  # int8
    "UnaryOp u 1 1 x y 0=0",               # abs
    "UnaryOp u 1 1 x y",                   # abs by default
])
def test_layer_parameters_the_graphs_do_not_use_raise(text):
    x = torch.zeros(1, 6, 2, 2)
    p = {"weight": torch.zeros(4, 6), "bias": None}
    with pytest.raises(NotImplementedError):
        _one(text, [x.mean((2, 3)) if "fc" in text else x], p)


def test_given_blob_is_not_computed():
    """A node whose outputs are all given is skipped, as ncnn's extractor
    skips it: the v1 contextnet's frame-0 run feeds ``flow.0``."""
    from portbench import ncnn
    from portbench.reference import graph

    nodes = ncnn.parse_param_text(
        "7767517\n3 3\nInput a 0 1 a\nUnaryOp neg 1 1 a b 0=1\n"
        "BinaryOp add 1 1 b c 0=0 1=1 2=1.0\n")
    x = torch.ones(1, 1, 1, 1)
    assert graph.run(nodes, {}, {"a": x}, ["c"])[0].item() == 0.0
    assert graph.run(nodes, {}, {"b": x}, ["c"])[0].item() == 2.0
