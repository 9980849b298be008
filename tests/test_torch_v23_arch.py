"""The in-repo v2.3-architecture graphs (rife_tpu_torch/models/v23_arch.py).

They must carry every invariant the repo asserts on the real rife-v2.3 files
(tests/test_param_parser.py test_v23_*, tests/test_graph_executor.py,
tests/test_bin_weights.py, tests/test_rewrite.py, SURVEY.md §2.3) and load
in both packages.  The full-width text is checked structurally; what the
session's rewrite chain makes of each net is counted on the live nodes.
"""

from collections import Counter

import numpy as np
import pytest

from rife_tpu.graph.param import parse_param
from rife_tpu.graph.weights import synthesize_weights
from rife_tpu_torch.engine.session import rewrite_planar_net
from rife_tpu_torch.models.v23_arch import NETS, V23_WIDTHS, write_v23_params

OUTPUTS = {"flownet": ["flow"], "contextnet": ["f1", "f2", "f3", "f4"],
           "fusionnet": ["output"]}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_v23_params(tmp_path_factory.mktemp("v23"))


@pytest.fixture(scope="module")
def graphs(model_dir):
    return {net: parse_param(model_dir / f"{net}.param") for net in NETS}


def test_layout_of_written_dir(model_dir):
    from rife_tpu.models.zoo import sniff_family

    assert model_dir.name == "rife-v2.3"
    assert sniff_family(str(model_dir)) == "v2"
    for net in NETS:
        assert (model_dir / f"{net}.param").is_file()
    # rewriting with the same widths leaves the files as they are
    before = {n: (model_dir / f"{n}.param").stat().st_mtime_ns for n in NETS}
    write_v23_params(model_dir.parent)
    assert before == {n: (model_dir / f"{n}.param").stat().st_mtime_ns
                      for n in NETS}


def test_net_interfaces(graphs):
    assert graphs["flownet"].input_blobs == ["input0", "input1"]
    assert "flow" in graphs["flownet"].producer
    assert graphs["contextnet"].input_blobs == ["input.1", "flow.0"]
    for f in ("f1", "f2", "f3", "f4"):
        assert f in graphs["contextnet"].producer
    assert set(graphs["fusionnet"].input_blobs) == {
        "img0", "img1", "flow", "3", "4", "5", "6", "7", "8", "9", "10"}
    assert "output" in graphs["fusionnet"].producer


def test_flownet_warps_read_frame_crops(graphs):
    g = graphs["flownet"]
    u8 = g.value_copies_of(["input0", "input1"])
    warps = g.layers_of_type("rife.Warp")
    assert len(warps) == 6
    assert all(n.bottoms[0] in u8 for n in warps)
    assert all(n.bottoms[1] not in u8 for n in warps)
    # every warped image is a channel crop of Concat(input0, input1)
    for n in warps:
        crop = g.nodes[g.producer[n.bottoms[0]][0]]
        assert crop.type == "Crop"
        split = g.nodes[g.producer[crop.bottoms[0]][0]]
        cat = g.nodes[g.producer[split.bottoms[0]][0]]
        assert (split.type, cat.type, cat.bottoms) == (
            "Split", "Concat", ["input0", "input1"])


def test_flownet_pyramid(graphs):
    g = graphs["flownet"]
    scales = sorted(float(n.p(1)) for n in g.layers_of_type("Interp")
                    if float(n.p(1)) < 1)
    assert scales == [0.125, 0.25, 0.5]
    assert len(g.layers_of_type("PReLU")) == 32  # 8 conv+PReLU per block
    strided = [n for n in g.layers_of_type("Convolution") if int(n.p(3)) == 2]
    assert len(strided) == 8
    deconvs = g.layers_of_type("Deconvolution")
    assert [(int(n.p(0)), int(n.p(1)), int(n.p(3))) for n in deconvs] == \
        [(4, 4, 2)] * 4
    # the three flows the warps take are upsampled x2, then multiplied by 2
    ups = [n for n in g.layers_of_type("Interp") if float(n.p(1)) == 2.0]
    muls = [[c for c in g.nodes if up.tops[0] in c.bottoms][0] for up in ups]
    scaled = [m for m in muls if (m.type, int(m.p(0)), float(m.p(2, 0.0)))
              == ("BinaryOp", 2, 2.0)]
    assert len(scaled) == 3


def test_contextnet_weight_counts(model_dir, graphs):
    """The counts SURVEY.md §2.3 verified byte-exact on the real file."""
    g = graphs["contextnet"]
    w = synthesize_weights(g, "rife-v2.3/contextnet")
    convs = g.layers_of_type("Convolution")
    assert len(convs) == 10
    assert sum(w[n.name].weight.size for n in convs) == 1_189_728
    assert sum(w[n.name].bias.size for n in convs) == 1024
    assert sum(lw.slope.size for lw in w.values()
               if lw.slope is not None) == 1024
    assert [int(n.p(3)) for n in convs] == [2, 1] * 5
    # no warp of the contextnet reads an image copy
    u8 = g.value_copies_of([])
    assert all(n.bottoms[0] not in u8 for n in g.layers_of_type("rife.Warp"))


def test_fusionnet_head_and_tail(graphs):
    g = graphs["fusionnet"]
    u8 = g.value_copies_of(["img0", "img1"])
    warps = g.layers_of_type("rife.Warp")
    assert len(warps) >= 2 and all(n.bottoms[0] in u8 for n in warps)
    (head,) = [n for n in g.layers_of_type("Interp") if n.bottoms == ["flow"]]
    assert float(head.p(1)) == 2.0
    (clip,) = g.layers_of_type("Clip")
    assert clip.tops == ["output"]
    assert (float(clip.p(0)), float(clip.p(1))) == (0.0, 1.0)
    assert len(g.layers_of_type("Sigmoid")) == 2
    assert len(g.layers_of_type("Deconvolution")) == 5


def _live_counts(graph, net):
    live = [graph.nodes[i] for i in
            graph.required_nodes(OUTPUTS[net], graph.input_blobs)]
    return Counter(n.type for n in live)


def test_rewrite_chain_node_counts(model_dir, graphs):
    """What the TPU-default planar chain turns each net into: the flownet's
    warps pair (one WarpDs4Pair at the 1/4 entry, two WarpPair), its three
    warped block entries and the fusionnet's four encoder entries become
    ConvolutionCat, every PReLU folds into its conv; the contextnet keeps
    four float warps, and the fusionnet's two frame warps stay unpaired
    (each warp's Split sits between them): u8 warps on the main path that
    the single-warp kernel's u8 mode (K4) serves."""
    want = {
        "flownet": {"rife.WarpDs4Pair": 1, "rife.WarpPair": 2,
                    "ConvolutionCat": 3, "rife.Warp": 0},
        "contextnet": {"rife.Warp": 4, "ConvolutionCat": 0},
        "fusionnet": {"rife.Warp": 2, "rife.WarpPair": 0,
                      "ConvolutionCat": 4},
    }
    for net in NETS:
        g = graphs[net]
        w = synthesize_weights(g, f"rife-v2.3/{net}")
        rg, _ = rewrite_planar_net(net, g, w)
        counts = _live_counts(rg, net)
        assert counts["PReLU"] == 0
        for kind, n in want[net].items():
            assert counts[kind] == n, (net, kind, counts)
    u8 = graphs["fusionnet"].value_copies_of(["img0", "img1"])
    rg, _ = rewrite_planar_net("fusionnet", graphs["fusionnet"], {})
    assert all(n.bottoms[0] in u8 for n in rg.layers_of_type("rife.Warp"))


def test_loads_in_both_packages(tmp_path):
    """Mini widths run end to end in rife_tpu (the reference the port is
    held to): flow at half resolution, features at 1/4..1/32."""
    import jax.numpy as jnp

    from rife_tpu.engine.session import RIFE as JaxRIFE
    from rife_tpu_torch import RIFE

    d = write_v23_params(tmp_path, (8, 8, 8, 8, 4))
    jx = JaxRIFE(str(d))
    assert set(jx.executors) == set(NETS) and jx.cfg.family == "v2"
    ex = jx.executors["contextnet"]
    feats = ex.run({"input.1": jnp.zeros((1, 64, 96, 3)),
                    "flow.0": jnp.zeros((1, 32, 48, 2))},
                   OUTPUTS["contextnet"], {"w": jx.weights["contextnet"]})
    assert [f.shape for f in feats] == [(1, 16, 24, 4), (1, 8, 12, 8),
                                        (1, 4, 6, 16), (1, 2, 3, 32)]
    port = RIFE(str(d), device="cpu")
    assert set(port.executors) == set(NETS)
    a = np.zeros((1, 32, 32, 3), np.uint8)
    assert port.process_batch(a, a, np.full(1, 0.5)).shape == (1, 32, 32, 3)


def test_full_widths():
    assert V23_WIDTHS == (192, 128, 96, 48, 32)
    with pytest.raises(ValueError):
        write_v23_params("/nonexistent-never-written", (8, 8, 8, 8))
