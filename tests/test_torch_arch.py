"""The in-repo v4.6-architecture flownet (rife_tpu_torch/models/v46_arch.py).

It must carry the invariants the repo asserts on the real rife-v4.6 graph
(tests/test_param_parser.py test_v46_*, tests/test_rewrite.py,
tests/test_warp_pair.py) and load in both packages.  Mini widths keep the
CPU runs short; the full-width text is checked structurally.
"""

import numpy as np
import pytest

from rife_tpu.graph.param import parse_param, parse_param_text
from rife_tpu_torch.engine.session import rewrite_flownet
from rife_tpu_torch.models.v46_arch import (
    V46_WIDTHS,
    flownet_param_text,
    write_flownet_param,
)

MINI = (16, 16, 16, 16)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_flownet_param(tmp_path_factory.mktemp("arch"), MINI)


@pytest.fixture(scope="module")
def graph(model_dir):
    return parse_param(model_dir / "flownet.param")


def test_layout_of_written_dir(model_dir):
    from rife_tpu.models.zoo import sniff_family

    assert model_dir.name == "rife-v4.6"
    assert (model_dir / "flownet.param").is_file()
    assert sniff_family(str(model_dir)) == "v4"


def test_interface_and_taps(graph):
    assert graph.input_blobs == ["in0", "in1", "in2"]
    for tap in ("flow0", "flow1", "flow2", "flow3", "out0"):
        assert tap in graph.producer
    full = graph.required_nodes(["flow3"], graph.input_blobs)
    pinned = graph.required_nodes(
        ["flow3"], graph.input_blobs + ["flow0", "flow1", "flow2"])
    assert len(pinned) < len(full)


def test_warps_read_u8_frame_copies(graph):
    u8 = graph.value_copies_of(["in0", "in1"])
    warps = graph.layers_of_type("rife.Warp")
    assert len(warps) == 8
    assert all(n.bottoms[0] in u8 for n in warps)
    assert all(n.bottoms[1] not in u8 for n in warps)
    assert "flow0" not in u8 and "out0" not in u8


def test_full_width_structure():
    g = parse_param_text(flownet_param_text())
    convs = g.layers_of_type("Convolution")
    entries = [int(n.p(0)) for n in convs if int(n.p(3, 1)) == 2]
    assert entries == [c for w in V46_WIDTHS for c in (w // 2, w)]
    assert len(convs) == 4 * (2 + 8)
    assert all(n.p(9) == 2 and n.p(-23310) == [0.2] for n in convs)
    deconvs = g.layers_of_type("Deconvolution")
    assert [int(n.p(0)) for n in deconvs] == [24] * 4
    assert [int(n.p(1)) for n in deconvs] == [4] * 4
    scales = sorted(float(n.p(1)) for n in g.layers_of_type("Interp"))
    assert {0.125, 0.25, 0.5, 2.0, 4.0, 8.0} <= set(scales)


def test_generator_rejects_bad_widths():
    with pytest.raises(ValueError):
        flownet_param_text((16, 16, 16))
    with pytest.raises(ValueError):
        flownet_param_text((16, 16, 16, 15))


def test_rewrite_chain_counts(graph):
    from rife_tpu.graph.weights import synthesize_weights

    g2, _ = rewrite_flownet(graph, synthesize_weights(graph, "rife-v4.6/flownet"))
    hist = g2.type_histogram()
    assert hist.get("rife.WarpDs4Pair", 0) == 1
    assert hist.get("rife.WarpPair", 0) == 2
    assert hist.get("rife.RenderBlend", 0) == 1
    assert hist.get("ConvolutionCat", 0) == 3
    assert hist.get("rife.DeconvPS", 0) == 4
    live = g2.required_nodes(["out0"], g2.input_blobs)
    live_types = [g2.nodes[i].type for i in live]
    assert "rife.Warp" not in live_types
    assert "rife.WarpDs4" not in live_types


def test_write_is_idempotent(model_dir):
    text = (model_dir / "flownet.param").read_text()
    write_flownet_param(model_dir.parent, MINI)
    assert (model_dir / "flownet.param").read_text() == text


def test_jax_session_runs_graph(model_dir):
    from rife_tpu.engine.session import RIFE

    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (1, 64, 64, 3), np.uint8)
    b = rng.integers(0, 256, (1, 64, 64, 3), np.uint8)
    out = RIFE(str(model_dir)).process_batch(a, b, np.array([0.5], np.float32))
    assert out.shape == (1, 64, 64, 3) and out.dtype == np.uint8
    assert out.std() > 1.0
