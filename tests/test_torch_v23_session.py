"""The v2.3 slice end to end: rife_tpu_torch.RIFE against rife_tpu.RIFE on the
v2.3-architecture graphs (in-repo reconstruction, synthetic weights), CPU,
f32, at mini widths.

On the CPU the JAX package runs its NHWC executors: XLA convs and the XLA
``warp_at`` form.  The port runs the twins of the Pallas kernels at the
sites the TPU's planar executors send to them (ops/conv.py, ops/warp.py).
The two round differently, so the bar is u8 max |d| <= 1 with >= 99.9% of
pixels exact, at two sizes (32-aligned, and unaligned: pad and crop), with
the rewrite chain on and off, and with the conv gates as shipped (at these
sizes no site is large enough) and lowered to 0 so that every conv site the
channel gates admit runs ``conv3x3``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rife_tpu_torch import RIFE
from rife_tpu_torch.engine import plan
from rife_tpu_torch.engine import session as session_mod
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import torch_ops

SIZES = [(64, 96), (50, 70)]
MINI = (8, 8, 8, 8, 4)
REPO = Path(__file__).resolve().parent.parent


def frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, h, w, 3), np.uint8),
            rng.integers(0, 256, (2, h, w, 3), np.uint8))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_v23_params(tmp_path_factory.mktemp("v23sess"), MINI)


@pytest.fixture(scope="module")
def jax_reference(model_dir):
    """rife_tpu outputs, built once per module: {(h, w): u8}."""
    from rife_tpu.engine.session import RIFE as JaxRIFE

    ref = JaxRIFE(str(model_dir))
    return {(h, w): ref.process_batch(*frames(h, w), np.full(2, 0.5,
                                                             np.float32))
            for h, w in SIZES}


def lower_gates(monkeypatch):
    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)


def assert_u8_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


@pytest.mark.parametrize("sites", ["gated", "all"])
@pytest.mark.parametrize("rewrite", [True, False])
@pytest.mark.parametrize("size", SIZES)
def test_slice_matches_rife_tpu(model_dir, jax_reference, size, rewrite,
                                sites, monkeypatch):
    if not rewrite:  # run the graphs as parsed
        monkeypatch.setattr(session_mod, "rewrite_planar_net",
                            lambda name, graph, weights, **_: (graph,
                                                               weights))
    if sites == "all":
        lower_gates(monkeypatch)
    sess = RIFE(str(model_dir), device="cpu")
    kinds = {n.type for n in sess.executors["flownet"].graph.nodes}
    assert ("rife.WarpPair" in kinds) == rewrite
    got = sess.process_batch(*frames(*size), np.full(2, 0.5, np.float32))
    assert_u8_close(got, jax_reference[size])


def test_session_defaults(model_dir):
    sess = RIFE(str(model_dir), device="cpu")
    assert sess.dtype == torch.float32
    assert set(sess.executors) == {"flownet", "contextnet", "fusionnet"}
    assert all(ex.ctx["planar_convs"] for ex in sess.executors.values())
    out = sess.process_batch_device(*frames(32, 32), np.full(2, 0.5))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.shape == (2, 32, 32, 3) and out.dtype == torch.uint8
    a, b = frames(32, 64)
    assert np.array_equal(sess.process(a[0], b[0], 0.0), a[0])
    assert np.array_equal(sess.process(a[0], b[0], 0.5),
                          sess.process_batch(a[:1], b[:1], [0.5])[0])


def test_timestep_other_than_half_raises(model_dir):
    sess = RIFE(str(model_dir), device="cpu")
    a, b = frames(32, 32)
    with pytest.raises(ValueError, match="0.5"):
        sess.process_batch(a, b, np.array([0.5, 0.25], np.float32))
    with pytest.raises(ValueError, match="0.5"):
        sess.process(a[0], b[0], 0.75)


def _spy(monkeypatch, calls):
    """Count the kernel wrappers' calls (on the CPU they run the twins) and
    check the operand contract of the CUDA kernels on every call."""
    from rife_tpu_torch.ops import warp as W

    def wrap(mod, name, check):
        real = getattr(mod, name)

        def spy(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            check(*args, **kw)
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)

    def single(img, flow, abs_pos=False):
        assert img.is_contiguous() and flow.is_contiguous()
        assert flow.dtype == (torch.float32 if abs_pos else img.dtype)

    def pair(*ts):
        assert all(t.is_contiguous() for t in ts)

    def conv(parts, weight, bias=None, slope=None, **kw):
        assert all(p.is_contiguous() for p in parts) and len(parts) <= 4
        assert weight.shape[1] == sum(p.shape[1] for p in parts)
        assert bias.dtype == torch.float32
        assert slope is None or slope.shape == (weight.shape[0],)

    for name in ("warp_feat", "warp_u8"):
        wrap(W, name, single)
    for name in ("warp_pair", "warp_ds4_pair", "warp_render"):
        wrap(W, name, pair)
    wrap(CV, "conv3x3", conv)


@pytest.mark.parametrize("sites", ["gated", "all"])
def test_kernel_sites_match_dispatch(model_dir, sites, monkeypatch):
    """``plan.kernel_sites`` (the step on meta tensors) counts what one
    step hands the kernel wrappers: chip_smoke.py holds the card's launch
    counters to it."""
    if sites == "all":
        lower_gates(monkeypatch)
    sess = RIFE(str(model_dir), device="cpu")
    wants = {size: plan.kernel_sites(sess, *size) for size in SIZES}
    calls = {}
    _spy(monkeypatch, calls)
    for size in SIZES:
        calls.clear()
        sess.process_batch(*frames(*size), np.full(2, 0.5, np.float32))
        want = wants[size]
        assert calls == want
        assert want["warp_feat"] == 4 and want["warp_u8"] == 2
        assert (want.get("conv3x3", 0) > 0) == (sites == "all")


def test_kernel_sites_at_1080p(tmp_path):
    """At full widths and 1080p the gates route 11 conv sites per step to
    the kernel (contextnet 3, flownet 2 block entries + 2 deconvs,
    fusionnet 3 + its head deconv); at 544x960, 5."""
    sess = RIFE(str(write_v23_params(tmp_path)), device="cpu")
    want = {"warp_ds4_pair": 1, "warp_pair": 2, "warp_feat": 4, "warp_u8": 2}
    assert plan.kernel_sites(sess, 1080, 1920) == {**want, "conv3x3": 11}
    assert plan.kernel_sites(sess, 544, 960) == {**want, "conv3x3": 5}


def test_weights_carry_kernel_forms(model_dir):
    """The conv3x3 sites read f32 bias and per-channel f32 slopes, the
    cuDNN sites the storage dtype (ROADMAP queue C: bias rounding)."""
    sess = RIFE(str(model_dir), device="cpu", dtype=torch.bfloat16)
    w = sess.weights["fusionnet"]
    entry = w["conv0_0"]
    assert entry["weight"].dtype == torch.bfloat16
    assert entry["bias"].dtype == torch.bfloat16
    assert entry["bias_f32"].dtype == torch.float32
    assert entry["slope_f32"].shape == (MINI[4],)
    head = w["head"]
    assert head["phase_weight"].shape == (16, MINI[4], 3, 3)
    assert head["phase_bias_f32"].shape == (16,)


def test_cat_conv_folds_parts_beyond_four(monkeypatch):
    """ConvolutionCat with more than four parts folds the tail into the
    fourth part; the result equals the concat conv."""
    from rife_tpu.graph.ir import LayerNode
    from rife_tpu.graph.weights import LayerWeights

    rng = np.random.default_rng(3)
    node = LayerNode("ConvolutionCat", "c", [f"x{i}" for i in range(5)],
                     ["y"], {0: 6, 1: 3, 3: 2, 4: 1, 5: 1, 9: 100})
    raw = {"c": LayerWeights(weight=rng.normal(size=(6, 10, 3, 3)).astype(
        np.float32), bias=rng.normal(size=6).astype(np.float32),
        slope=np.full(6, 0.2, np.float32))}
    graph = type("G", (), {"nodes": [node]})()
    w = torch_ops.prepare_weights(graph, raw)
    parts = [torch.from_numpy(rng.normal(size=(1, 2, 8, 12)).astype(
        np.float32)) for _ in range(5)]
    ctx = {"w": w, "planar_convs": True, "planar_all": True}
    seen = []
    real = CV.conv3x3
    monkeypatch.setattr(CV, "conv3x3",
                        lambda ps, *a, **k: seen.append(len(ps)) or
                        real(ps, *a, **k))
    got = torch_ops.OP_TABLE["ConvolutionCat"](node, parts, None, ctx)[0]
    want = torch_ops.OP_TABLE["ConvolutionCat"](
        node, parts, None, {"w": w})[0]
    assert seen == [4]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_port_never_imports_jax(model_dir):
    code = (
        "import sys, numpy as np\n"
        "from rife_tpu_torch import RIFE\n"
        "s = RIFE(sys.argv[1], device='cpu')\n"
        "a = np.random.default_rng(0).integers(0, 256, (1, 32, 32, 3), np.uint8)\n"
        "o = s.process_batch(a, a[:, ::-1].copy(), np.array([0.5], np.float32))\n"
        "assert o.shape == (1, 32, 32, 3)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'rife_tpu' not in sys.modules, 'rife_tpu was imported'\n"
        "print('ok')\n"
    )
    # one torch thread: the suite runs several test processes at once
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code, str(model_dir)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
