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
