"""Where the 4x4 stride-2 deconv sites go (``ops/conv.py`` ``deconv_route``)
and what the plan counts for them, on the CPU.

- The card's gate sends every bf16 deconv site of the three families to
  the deconv kernel (the planar sites in the planar order, the rest in
  XLA's); an f32 run and every CPU run send none there: the CPU keeps its
  twins and oneDNN, f32 on the card ``conv3x3``'s phase conv and cuDNN.
- ``plan.kernel_sites`` equals the wrappers one step calls, for a bf16
  session routed as on the card (``deconv_on_kernel`` answered for a card;
  the deconv wrappers then run their twins), for five session kinds,
  unsharded and height-sharded 1x4.
"""

import numpy as np
import pytest
import torch

from rife_tpu_torch import RIFE
from rife_tpu_torch.engine import plan
from rife_tpu_torch.models.v1_arch import write_v1_params
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.models.v46_arch import write_flownet_param
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import warp as W
from rife_tpu_torch.parallel import sharding as S

CPU = torch.device("cpu")
BF16 = torch.bfloat16
KINDS = {
    "v4.6": ("v4.6", {}),
    "v2.3": ("v2.3", {}),
    "v1": ("v1", {}),
    "v2.3 -u": ("v2.3", {"uhd_mode": True}),
    "v4.6 -x -z fuse_ds2": ("v4.6", {"tta_mode": True,
                                     "tta_temporal_mode": True,
                                     "fuse_ds2": True}),
}
WARPS = ("warp_feat", "warp_u8", "warp_pair", "warp_ds4_pair", "warp_render",
         "warp_ds2", "warp_spatial")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("deconv_route")
    return {"v4.6": str(write_flownet_param(root, (16, 16, 16, 16))),
            "v2.3": str(write_v23_params(root, (8, 8, 8, 8, 4))),
            "v1": str(write_v1_params(root, (8, 8, 8, 4), "rife"))}


def deconv_nodes(sess):
    for ex in sess.executors.values():
        for node in ex.graph.nodes:
            if node.type in ("Deconvolution", "rife.DeconvPS"):
                yield ex, node


@pytest.mark.parametrize("model", ["v4.6", "v2.3", "v1"])
def test_card_gate_sends_every_bf16_deconv_to_the_kernel(model_dirs, model,
                                                         monkeypatch):
    sess = RIFE(model_dirs[model], device="cpu", dtype=BF16)
    nodes = list(deconv_nodes(sess))
    assert nodes
    seen = set()
    for lowered in (False, True):
        if lowered:
            monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
        for ex, node in nodes:
            assert CV.is_deconv4x4(node)
            cin = sess.weights[next(k for k, e in sess.executors.items()
                                    if e is ex)][node.name]["weight"].shape[0]
            cout = int(node.p(0))
            for h, w in ((34, 60), (272, 480), (1088, 1920)):
                def route(device, dtype):
                    return CV.deconv_route(node, h, w, cin, cout, ex.ctx,
                                           torch.device(device), dtype)
                card = route("cuda", BF16)
                assert card in ("planar", "xla")
                seen.add(card)
                assert route("cuda", torch.float32) == route("cpu", BF16) \
                    == route("cpu", torch.float32) == (
                        "planar" if card == "planar" else "library")
    # v4.6 runs no planar net: all its deconvs take XLA's order
    assert seen == ({"xla"} if model == "v4.6" else {"planar", "xla"})


def test_cpu_step_never_launches_the_deconv_kernel(model_dirs, monkeypatch):
    """A CPU step in bf16 takes the twins and oneDNN at every deconv site:
    the kernel's launch path is never reached."""
    def refuse(*args, **kw):
        raise AssertionError("the deconv kernel's launch path on the CPU")

    monkeypatch.setattr(CV, "_launch_deconv", refuse)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 256, (1, 64, 64, 3), np.uint8) for _ in range(2))
    for model in ("v4.6", "v2.3", "v1"):
        out = RIFE(model_dirs[model], device="cpu", dtype=BF16).process_batch(
            a, b, np.full(1, 0.5, np.float32))
        assert out.shape == (1, 64, 64, 3)


def as_on_card(monkeypatch):
    """Route as on the card: bf16 deconv sites to the kernel."""
    monkeypatch.setattr(CV, "deconv_on_kernel",
                        lambda device, dtype: dtype == BF16)


def spy_as_on_card(monkeypatch, calls):
    """Route as on the card and count each wrapper call under the plan's
    names; the deconv wrappers run their plain versions
    (``deconv_t4_ref``), so no ``conv3x3`` twin call hides inside them."""
    as_on_card(monkeypatch)

    def count(key):
        calls[key] = calls.get(key, 0) + 1

    def wrap(mod, name, key=None):
        real = getattr(mod, name)

        def spy(*args, **kw):
            count(key or ("conv3x3_ps" if kw.get("ps", 1) > 1 else name))
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)

    for name in WARPS:
        wrap(W, name)
    wrap(CV, "conv3x3")
    wrap(CV, "deconv4x4_xla", "deconv4x4")

    def planar(x, phase_weight, phase_bias=None, phase_slope=None, *, act,
               alpha, weight_t4, ps=1):
        count("deconv4x4")
        o = weight_t4.shape[1]
        cut = (lambda t: None if t is None else t[:o])  # noqa: E731
        return CV.deconv_t4_ref(x, weight_t4, cut(phase_bias),
                                cut(phase_slope), act=act, alpha=alpha, ps=ps)
    monkeypatch.setattr(CV, "deconv4x4", planar)


@pytest.mark.parametrize("mesh", ["unsharded", "1x4"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_plan_equals_dispatch_routed_as_on_the_card(model_dirs, monkeypatch,
                                                    kind, mesh):
    model, modes = KINDS[kind]
    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    sess = RIFE(model_dirs[model], device="cpu", dtype=BF16, **modes)
    runner = sess
    if mesh == "1x4":
        runner = S.ShardedRIFE(sess, S.make_mesh_2d(1, 4, [CPU] * 4),
                               height_axis="spatial")
    as_on_card(monkeypatch)
    want = runner.kernel_sites(128, 64) if mesh == "1x4" else \
        plan.kernel_sites(sess, 128, 64)
    calls = {}
    spy_as_on_card(monkeypatch, calls)
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 256, (1, 128, 64, 3), np.uint8) for _ in range(2))
    runner.process_batch(a, b, np.full(1, 0.5, np.float32))
    assert calls == want
    assert want.get("deconv4x4", 0) > 0
    assert (want.get("warp_spatial", 0) > 0) == (mesh == "1x4")
