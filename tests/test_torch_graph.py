"""The port's copies of the JAX package's framework-free layers against the
originals, on the mini v4.6-, v2.3- and v1-architecture reconstructions
(``rife``, ``rife-anime``): the
parser (``graph/param.py``, ``graph/ir.py``), the weight synthesis
(``graph/weights.py``, both modes), the rewrite chains of the sessions
(``graph/rewrite.py``, with and without ``fuse_ds2``), the zoo loader
(``models/zoo.py``) and the layer helpers (``ops/common.py``).  Every
comparison is exact."""

import numpy as np
import pytest
from rife_tpu.graph import param as jparam
from rife_tpu.graph import rewrite as jrewrite
from rife_tpu.graph import weights as jweights
from rife_tpu.models import zoo as jzoo
from rife_tpu.ops import common as jcommon

from rife_tpu_torch.engine import session as session_mod
from rife_tpu_torch.graph import param, weights
from rife_tpu_torch.models import zoo
from rife_tpu_torch.models.v1_arch import write_v1_params
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.models.v46_arch import write_flownet_param
from rife_tpu_torch.ops import common

THREE = ("flownet", "contextnet", "fusionnet")
NETS = [("rife-v4.6", "flownet")] + [
    (m, n) for m in ("rife-v2.3", "rife", "rife-anime") for n in THREE]
NET_IDS = [f"{m}/{n}" for m, n in NETS]
REWRITES = ("fuse_concat_into_convs", "fuse_pixelshuffle_into_convs",
            "fuse_prelu_activations", "fuse_quarter_downscaled_warps",
            "fuse_render_blend", "fuse_sibling_warps",
            "push_concat_through_interp")


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("graph")
    return {"rife-v4.6": write_flownet_param(root, (16, 16, 16, 16)),
            "rife-v2.3": write_v23_params(root, (8, 8, 8, 8, 4)),
            **{v: write_v1_params(root, (8, 8, 8, 4), v)
               for v in ("rife", "rife-anime")}}


def node_tuples(graph):
    return [(n.type, n.name, list(n.bottoms), list(n.tops), dict(n.params))
            for n in graph.nodes]


def assert_same_graph(got, want):
    assert node_tuples(got) == node_tuples(want)
    assert got.producer == want.producer
    assert list(got.input_blobs) == list(want.input_blobs)


def assert_same_weights(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        for field in ("weight", "bias", "slope"):
            a, b = getattr(got[name], field), getattr(want[name], field)
            assert (a is None) == (b is None), (name, field)
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape
                assert np.array_equal(a, b), (name, field)


def parse_both(model_dirs, model, net):
    path = model_dirs[model] / f"{net}.param"
    return param.parse_param(path), jparam.parse_param(path)


@pytest.mark.parametrize("model,net", NETS, ids=NET_IDS)
def test_parse_param_matches(model_dirs, model, net):
    got, want = parse_both(model_dirs, model, net)
    assert_same_graph(got, want)
    seeds = ("in0", "in1", "input0", "input1", "img0", "img1")
    assert got.value_copies_of(seeds) == want.value_copies_of(seeds)
    assert got.required_nodes(list(want.producer)[-1:], want.input_blobs) == \
        want.required_nodes(list(want.producer)[-1:], want.input_blobs)


@pytest.mark.parametrize("mode", ["mix", "iid"])
@pytest.mark.parametrize("model,net", NETS, ids=NET_IDS)
def test_synthesize_weights_bit_identical(model_dirs, model, net, mode,
                                          monkeypatch):
    got_g, want_g = parse_both(model_dirs, model, net)
    tag = f"{model}/{net}"
    if mode == "iid":
        monkeypatch.setenv("RIFE_TPU_SYNTH_MODE", "iid")
    else:
        monkeypatch.delenv("RIFE_TPU_SYNTH_MODE", raising=False)
    want = jweights.synthesize_weights(want_g, tag)
    got = weights.synthesize_weights(got_g, tag, mode=mode)
    assert_same_weights(got, want)


def test_synthesis_mode_is_checked(model_dirs):
    g, _ = parse_both(model_dirs, "rife-v4.6", "flownet")
    with pytest.raises(ValueError, match="synthesis mode"):
        weights.synthesize_weights(g, "rife-v4.6/flownet", mode="env")


def test_baked_scales_match():
    assert weights.SYNTHETIC_FLOWNET_SCALE == jweights.SYNTHETIC_FLOWNET_SCALE
    assert weights.SYNTHETIC_FUSIONNET_SCALE == \
        jweights.SYNTHETIC_FUSIONNET_SCALE


def test_load_bin_matches(model_dirs, tmp_path):
    """A .bin stream (fp32 and fp16 weight arrays, raw biases and slopes)
    binds to the same arrays."""
    g, jg = parse_both(model_dirs, "rife-v2.3", "contextnet")
    raw = jweights.synthesize_weights(jg, "rife-v2.3/contextnet")
    chunks = []
    for k, node in enumerate(jg.nodes):
        lw = raw.get(node.name)
        if lw is None:
            continue
        if lw.weight is not None:
            if k % 2:
                data = lw.weight.astype("<f2").tobytes()
                data += b"\0" * (-len(data) % 4)
                chunks += [np.uint32(jweights.FLAG_FP16).tobytes(), data]
            else:
                chunks += [np.uint32(0).tobytes(),
                           lw.weight.astype("<f4").tobytes()]
        for extra in (lw.bias, lw.slope):
            if extra is not None:
                chunks.append(extra.astype("<f4").tobytes())
    path = tmp_path / "contextnet.bin"
    path.write_bytes(b"".join(chunks))
    assert_same_weights(weights.load_bin(g, path), jweights.load_bin(jg, path))


def chain(model, net, graph, w, fuse_ds2):
    if model == "rife-v4.6":
        return session_mod.rewrite_flownet(graph, w, fuse_ds2=fuse_ds2)
    return session_mod.rewrite_planar_net(net, graph, w, fuse_ds2=fuse_ds2)


@pytest.mark.parametrize("fuse_ds2", [False, True])
@pytest.mark.parametrize("model,net", NETS, ids=NET_IDS)
def test_rewrite_chain_matches(model_dirs, model, net, fuse_ds2,
                               monkeypatch):
    """The session's chain over the port's rewrites against the same chain
    over ``rife_tpu``'s, on the same graph and weights."""
    g, jg = parse_both(model_dirs, model, net)
    tag = f"{model}/{net}"
    got_g, got_w = chain(model, net, g, weights.synthesize_weights(g, tag),
                         fuse_ds2)
    for name in REWRITES:
        monkeypatch.setattr(session_mod, name, getattr(jrewrite, name))
    want_g, want_w = chain(model, net, jg,
                           jweights.synthesize_weights(jg, tag), fuse_ds2)
    assert_same_graph(got_g, want_g)
    assert_same_weights(got_w, want_w)
    assert got_g.type_histogram() == want_g.type_histogram()


@pytest.mark.parametrize("model", ["rife-v4.6", "rife-v2.3", "rife",
                                   "rife-anime"])
def test_load_model_matches(model_dirs, model):
    got = zoo.load_model(str(model_dirs[model]))
    want = jzoo.load_model(str(model_dirs[model]))
    assert (got.name, got.family) == (want.name, want.family)
    assert list(got.nets) == list(want.nets)
    for name, net in want.nets.items():
        assert got.nets[name].synthetic == net.synthetic
        assert_same_graph(got.nets[name].graph, net.graph)
        assert_same_weights(got.nets[name].weights, net.weights)


def test_sniff_family_matches():
    for name in ["rife", "rife-HD", "rife-v2.3", "rife-v3.1", "rife-v4.6",
                 "/x/rife-v4/m", "models/rife-anime"]:
        assert zoo.sniff_family(name) == jzoo.sniff_family(name)
    with pytest.raises(ValueError):
        zoo.sniff_family("other")


@pytest.mark.parametrize("model,net", NETS, ids=NET_IDS)
def test_layer_helpers_match(model_dirs, model, net):
    g, _ = parse_both(model_dirs, model, net)
    for node in g.nodes:
        if node.type in ("Convolution", "Deconvolution"):
            assert common.conv_hyperparams(node) == \
                jcommon.conv_hyperparams(node)
            assert common.activation_of(node) == jcommon.activation_of(node)
        elif node.type == "Interp":
            assert common.interp_out_size(68, 120, node) == \
                jcommon.interp_out_size(68, 120, node)
        elif node.type == "Eltwise":
            assert common.eltwise_coeffs(node, len(node.bottoms)) == \
                jcommon.eltwise_coeffs(node, len(node.bottoms))
        elif node.type == "Slice":
            n = len(node.tops)
            assert list(common.slice_sizes(node, 12, n)) == \
                list(jcommon.slice_sizes(node, 12, n))
    for name in ("BINARY_ADD", "BINARY_SUB", "BINARY_MUL", "BINARY_DIV",
                 "BINARY_MAX", "BINARY_MIN", "BINARY_POW", "BINARY_RSUB",
                 "BINARY_RDIV", "UNARY_ABS", "UNARY_NEG", "UNARY_FLOOR",
                 "UNARY_CEIL", "UNARY_SQUARE", "UNARY_SQRT", "UNARY_RSQRT",
                 "UNARY_EXP", "UNARY_LOG", "UNARY_SIN", "UNARY_COS",
                 "UNARY_TAN", "ACT_NONE", "ACT_RELU", "ACT_LEAKY", "ACT_CLIP",
                 "ACT_SIGMOID", "ACT_PRELU_CH"):
        assert getattr(common, name) == getattr(jcommon, name)
