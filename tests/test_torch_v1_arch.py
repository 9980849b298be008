"""The in-repo v1-architecture graphs (rife_tpu_torch/models/v1_arch.py), both
variants (``rife``, ``rife-anime``).

They must carry every invariant the repo records about the real v1 files
(SURVEY.md §2.3; tests/test_param_parser.py, tests/test_graph_executor.py,
tests/test_rewrite.py) and load in both packages the same way (the copies
of the parser and loader against the originals on these dirs:
tests/test_torch_graph.py).  The full-width text is checked structurally;
the 1080p conv sites against the planar gates and against the tensor-core
kernel's resident-weight limit (a refusal would raise on the card).
"""

from collections import Counter

import numpy as np
import pytest
import torch

from rife_tpu.graph.param import parse_param
from rife_tpu_torch import RIFE
from rife_tpu_torch.engine import plan
from rife_tpu_torch.engine.session import rewrite_planar_net
from rife_tpu_torch.models.v1_arch import (NETS, SE_WIDTH, V1_WIDTHS,
                                           VARIANTS, write_v1_params)
from rife_tpu_torch.ops import conv as CV

MINI = (8, 8, 8, 4)
# the H100's opt-in shared memory a block
# (cudaDevAttrMaxSharedMemoryPerBlockOptin)
H100_SMEM_OPTIN = 232_448


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("v1")
    return {v: write_v1_params(root, variant=v) for v in VARIANTS}


@pytest.fixture(scope="module")
def graphs(dirs):
    return {(v, net): parse_param(d / f"{net}.param")
            for v, d in dirs.items() for net in NETS}


def producer(g, blob):
    return g.nodes[g.producer[blob][0]]


def consumers(g, blob):
    return [n for n in g.nodes if blob in n.bottoms]


@pytest.mark.parametrize("variant", VARIANTS)
def test_layout_of_written_dir(dirs, variant):
    from rife_tpu.models.zoo import sniff_family

    d = dirs[variant]
    assert d.name == variant and sniff_family(str(d)) == "v1"
    before = {n: (d / f"{n}.param").stat().st_mtime_ns for n in NETS}
    write_v1_params(d.parent, variant=variant)
    assert before == {n: (d / f"{n}.param").stat().st_mtime_ns for n in NETS}


def test_bad_arguments_raise(tmp_path):
    with pytest.raises(ValueError, match="variant"):
        write_v1_params(tmp_path, variant="rife-HD")
    with pytest.raises(ValueError, match="widths"):
        write_v1_params(tmp_path, (8, 8, 8))


@pytest.mark.parametrize("variant", VARIANTS)
def test_net_interfaces(graphs, variant):
    fl, ctx, fus = (graphs[variant, n] for n in NETS)
    assert fl.input_blobs == ["input0", "input1"] and "flow" in fl.producer
    assert ctx.input_blobs == ["input.1", "flow.1"]
    assert all(f"f{k}" in ctx.producer for k in range(1, 5))
    assert set(fus.input_blobs) == {"img0", "img1", "flow", *map(str,
                                                                 range(3, 11))}
    assert producer(fus, "output").type == "Clip"  # the fusionnet ends in Clip


@pytest.mark.parametrize("variant", VARIANTS)
def test_contextnet_negates_flow_1(graphs, variant):
    """``UnaryOp 0=1`` turns ``flow.1`` into ``flow.0``, which every warp
    reads: a run fed ``flow.0`` skips the negation."""
    g = graphs[variant, "contextnet"]
    neg = producer(g, "flow.0")
    assert (neg.type, neg.bottoms, int(neg.p(0))) == ("UnaryOp", ["flow.1"], 1)
    assert g.type_histogram()["UnaryOp"] == 1
    assert len(g.layers_of_type("rife.Warp")) == 4
    need = g.required_nodes(["f1", "f2", "f3", "f4"], ["input.1", "flow.0"])
    assert all(g.nodes[i].type != "UnaryOp" for i in need)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("net", NETS)
def test_se_blocks(graphs, variant, net):
    """Every SE gate: global-average ``Pooling 0=1 4=1`` -> bias-free
    ``InnerProduct`` C->16 -> one-slope ``PReLU`` -> ``InnerProduct`` 16->C
    with its fused sigmoid (``9=4``) -> ``BinaryOp`` MUL of the vector into
    the map, then the residual add and a per-channel ``PReLU``."""
    g = graphs[variant, net]
    pools = g.layers_of_type("Pooling")
    assert len(pools) == {"flownet": 18, "contextnet": 4,
                          "fusionnet": 4}[net]
    assert g.type_histogram()["InnerProduct"] == 2 * len(pools)
    for pool in pools:
        assert (int(pool.p(0)), int(pool.p(4))) == (1, 1)
        (fc1,) = consumers(g, pool.tops[0])
        assert fc1.type == "InnerProduct"
        assert (int(fc1.p(0)), int(fc1.p(1)), int(fc1.p(9, 0))) == (
            SE_WIDTH, 0, 0)
        (pr,) = consumers(g, fc1.tops[0])
        assert pr.type == "PReLU" and int(pr.p(0)) == 1
        (fc2,) = consumers(g, pr.tops[0])
        assert fc2.type == "InnerProduct" and int(fc2.p(9)) == 4
        c = int(fc2.p(0))
        assert int(fc2.p(2)) == SE_WIDTH * c == int(fc1.p(2))
        (mul,) = consumers(g, fc2.tops[0])
        assert mul.type == "BinaryOp" and int(mul.p(0)) == 2
        assert mul.bottoms[1] == fc2.tops[0]
        (add,) = consumers(g, mul.tops[0])
        assert add.type == "BinaryOp" and int(add.p(0)) == 0
        (out,) = consumers(g, add.tops[0])
        assert out.type == "PReLU" and int(out.p(0)) == c


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("net", NETS)
def test_pixelshuffle_tails_fuse(graphs, dirs, variant, net):
    """Each Conv3x3 -> PixelShuffle(2) becomes one ``rife.ConvPS`` (three
    flownet block heads, the fusionnet head), and no standalone PReLU of
    a (B,C) vector is folded away."""
    from rife_tpu.models.zoo import load_model

    model = load_model(str(dirs[variant]))
    g, w = model.nets[net].graph, model.nets[net].weights
    n_ps = g.type_histogram().get("PixelShuffle", 0)
    assert n_ps == {"flownet": 3, "contextnet": 0, "fusionnet": 1}[net]
    g2, _ = rewrite_planar_net(net, g, w)
    hist = g2.type_histogram()
    assert hist.get("rife.ConvPS", 0) == n_ps
    assert hist.get("PixelShuffle", 0) == 0
    for ps in g.layers_of_type("PixelShuffle"):
        conv = producer(g, ps.bottoms[0])
        assert conv.type == "Convolution" and int(conv.p(1)) == 3
    se_prelus = [n for n in g2.nodes if n.type == "PReLU"
                 and producer(g2, n.bottoms[0]).type == "InnerProduct"]
    assert len(se_prelus) == len(g.layers_of_type("Pooling"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_flownet_pyramid_and_warps(graphs, variant):
    """Three blocks at widths 240/150/90; 4 internal warps (the repo's
    record: 4-6), the second of each pair by the negated flow.  ``rife``
    warps value copies of the frames (the u8-origin kernels); ``rife-anime``
    scales the concat by 0.5 before it is sliced, so none of its warps
    does."""
    g = graphs[variant, "flownet"]
    entries = sorted(int(n.p(0)) for n in g.layers_of_type("Convolution")
                     if int(n.p(3, 1)) == 2)
    assert entries == sorted(V1_WIDTHS[:3])
    warps = g.layers_of_type("rife.Warp")
    assert len(warps) == 4
    negs = {n.tops[0] for n in g.layers_of_type("UnaryOp")
            if int(n.p(0)) == 1}
    assert sum(w.bottoms[1] in negs for w in warps) == 2
    u8 = g.value_copies_of(["input0", "input1"])
    if variant == "rife":
        assert all(w.bottoms[0] in u8 for w in warps)
    else:
        assert not any(w.bottoms[0] in u8 for w in warps)
        for w in warps:  # Crop(Split(Interp 0.5(Concat(input0, input1))))
            split = producer(g, producer(g, w.bottoms[0]).bottoms[0])
            half = producer(g, split.bottoms[0])
            assert (split.type, half.type, float(half.p(1))) == (
                "Split", "Interp", 0.5)
    assert all(w.bottoms[1] not in u8 for w in warps)


@pytest.mark.parametrize("variant", VARIANTS)
def test_flow_is_two_channels_at_half_resolution(dirs, tmp_path, variant):
    sess = RIFE(str(write_v1_params(tmp_path, MINI, variant)), device="cpu")
    x = torch.rand(1, 3, 64, 96)
    flow = sess.executors["flownet"].run(
        {"input0": x, "input1": x.flip(3)}, ["flow"],
        {"w": sess.weights["flownet"]})[0]
    assert flow.shape == (1, 2, 32, 48)
    assert torch.isfinite(flow).all()


def tc_smem_bytes(site) -> int:
    """Dynamic shared memory of one ``conv3x3_tc_kernel`` launch at a site
    (``csrc/conv.cu`` ``launch_tc`` and the channel groups of
    ``rife_conv3x3_tc``): the group's packed weights, two input stages, the
    warps' output rows, the group's bias and activation factors."""
    _, parts, cout, stride, _, _, _, deconv = site
    cp = CV.padded_cin(sum(parts))
    if deconv:
        group = cout if cout <= 64 else cout // 2
    else:
        n = (cout + 63) // 64
        group = -(-cout // n)
    nt = 2 * -(-group // 16)
    rows, cols, pix = (18, 24, 24) if stride == 1 else (17, 36, 20)
    return (9 * nt * 8 * (cp + 8) + 2 * rows * cols * pix
            + 8 * nt * 8 * 16) * 2 + 2 * nt * 8 * 4


@pytest.mark.parametrize("variant", VARIANTS)
def test_1080p_sites(dirs, variant):
    """At full widths and 1080p: the fusionnet's head conv takes the
    544x960 output of the decoder (16 -> 16), which the planar gate sends
    to B4 (``conv3x3_ps``); the wide flownet convs stay on cuDNN; every
    gated conv site fits the tensor-core kernel's resident weights, and the
    head B4's conv kernel's shared memory (``ps_geometry``)."""
    sess = RIFE(str(dirs[variant]), device="cpu")
    sites = plan.kernel_sites(sess, 1080, 1920)
    ps = plan.conv_sites(sess, 1080, 1920, "conv3x3_ps")
    assert ps == [(1, (16,), 16, 1, CV.ACT_NONE, 544, 960, False)]
    assert sites["conv3x3_ps"] == 1 and sites["conv3x3"] == 15
    convs = plan.conv_sites(sess, 1080, 1920)
    # the flownet's only planar site: block 2's entry over its three parts
    assert [s for s in convs if s[2] > 64 and not s[-1]] == [
        (1, (3, 3, 2), V1_WIDTHS[2], 2, CV.ACT_PRELU, 544, 960, False)]
    for site in convs:
        assert tc_smem_bytes(site) <= H100_SMEM_OPTIN, site
    for _, parts, cout, stride, _, h, w, _ in ps:
        assert CV.ps_geometry(8, sum(parts), cout, h, w,
                              stride).smem_bytes <= H100_SMEM_OPTIN
    assert max(tc_smem_bytes(s) for s in convs) > 200_000  # the 128->64 deconv
    want = ({"warp_ds4_pair": 1, "warp_pair": 2, "warp_feat": 8}
            if variant == "rife" else {"warp_pair": 1, "warp_feat": 12})
    assert {k: v for k, v in sites.items() if k.startswith("warp")} == want


def test_full_width_text(graphs):
    """Widths as documented: flownet convs at 240/150/90, contextnet stages
    16/32/64/128, fusionnet head 16 -> 16."""
    hist = Counter()
    for (variant, net), g in graphs.items():
        if variant != "rife":
            continue
        for n in g.layers_of_type("Convolution"):
            hist[net, int(n.p(0))] += 1
    assert {c for (net, c) in hist if net == "flownet"} == {240, 150, 90, 8}
    assert {c for (net, c) in hist if net == "contextnet"} == {16, 32, 64,
                                                                128}
    head = [n for n in graphs["rife", "fusionnet"].nodes if n.name == "head"]
    assert int(head[0].p(0)) == 16
    assert int(head[0].p(6)) == 16 * 16 * 9
    np.testing.assert_array_equal(
        sorted(int(n.p(0)) for n in graphs["rife", "fusionnet"]
               .layers_of_type("Deconvolution")), [16, 64, 128])
