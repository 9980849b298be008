"""The v1 family end to end: rife_tpu_torch.RIFE against rife_tpu.RIFE on the
v1-architecture graphs (in-repo reconstruction, synthetic weights), CPU,
f32, at mini widths: ``rife`` plain, ``-x``, ``-z``, ``-x -z`` and ``-u``,
and ``rife-anime`` plain, each at a 32-aligned size and an unaligned one
(pad and crop), with the conv gates as shipped (at these sizes no site is
large enough) and lowered to 0, so that every conv site the channel gates
admit runs ``conv3x3``'s twin and the fusionnet's ConvPS head its B4 twin.

On the CPU the JAX package runs its NHWC executors (XLA convs, the XLA
``warp_at``); the port runs the twins of the Pallas kernels at the sites
the TPU's planar executors send to them.  The two round differently, so
the bar is that of tests/test_torch_v23_session.py: u8 max |d| <= 1 with
>= 99.9% of pixels exact.  Then the plan: ``plan.kernel_sites`` equals the
kernel wrappers one step calls, in every mode.
"""

import numpy as np
import pytest
import torch

from rife_tpu_torch import RIFE
from rife_tpu_torch.engine import plan
from rife_tpu_torch.models.v1_arch import write_v1_params
from rife_tpu_torch.ops import conv as CV

MINI = (8, 8, 8, 4)
SIZES = [(64, 96), (50, 70)]
MODES = {"plain": {}, "-x": {"tta_mode": True},
         "-z": {"tta_temporal_mode": True},
         "-x -z": {"tta_mode": True, "tta_temporal_mode": True},
         "-u": {"uhd_mode": True}}
CASES = [("rife", m) for m in MODES] + [("rife-anime", "plain")]
HALF = np.full(2, 0.5, np.float32)
WRAPPERS = ("warp_pair", "warp_ds4_pair", "warp_ds2", "warp_render",
            "warp_u8", "warp_feat")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Mini-width tensors gain nothing from torch's thread pool, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, h, w, 3), np.uint8),
            rng.integers(0, 256, (2, h, w, 3), np.uint8))


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("v1sess")
    return {v: write_v1_params(root, MINI, v) for v in ("rife", "rife-anime")}


@pytest.fixture(scope="module")
def jax_reference(model_dirs):
    """rife_tpu outputs, each computed once: {(variant, mode, size): u8}."""
    from rife_tpu.engine.session import RIFE as JaxRIFE

    cache, sessions = {}, {}

    def get(variant, mode, size):
        key = (variant, mode, size)
        if key not in cache:
            if (variant, mode) not in sessions:
                sessions[variant, mode] = JaxRIFE(str(model_dirs[variant]),
                                                  **MODES[mode])
            cache[key] = sessions[variant, mode].process_batch(
                *frames(*size), HALF)
        return cache[key]
    return get


def lower_gates(monkeypatch):
    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)


def assert_u8_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


@pytest.mark.parametrize("sites", ["gated", "all"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("variant,mode", CASES)
def test_matches_rife_tpu(model_dirs, jax_reference, variant, mode, size,
                          sites, monkeypatch):
    if sites == "all":
        lower_gates(monkeypatch)
    sess = RIFE(str(model_dirs[variant]), device="cpu", **MODES[mode])
    if sites == "all":
        assert plan.kernel_sites(sess, *size).get("conv3x3_ps", 0) > 0
    got = sess.process_batch(*frames(*size), HALF)
    assert_u8_close(got, jax_reference(variant, mode, size))


def spy(monkeypatch, calls):
    """Count the kernel wrappers' calls (on the CPU they run the twins); a
    ``conv3x3`` call with ``ps`` > 1 counts as ``conv3x3_ps``, as its
    launch does on the card (the v1 graphs have no DeconvPS)."""
    from rife_tpu_torch.ops import warp as W

    def wrap(mod, name, counter):
        real = getattr(mod, name)

        def fn(*args, **kw):
            key = counter(kw)
            calls[key] = calls.get(key, 0) + 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, fn)

    for name in WRAPPERS:
        wrap(W, name, lambda kw, _n=name: _n)
    # on the CPU a deconv site is one conv3x3 call over its phases
    wrap(CV, "conv3x3", lambda kw: "conv3x3_ps" if kw.get("ps", 1) > 1
         else "conv3x3")


@pytest.mark.parametrize("sites", ["gated", "all"])
@pytest.mark.parametrize("variant,mode", CASES)
def test_kernel_sites_match_dispatch(model_dirs, variant, mode, sites,
                                     monkeypatch):
    """``plan.kernel_sites`` (the step on meta tensors) counts what one
    step hands the kernel wrappers: chip_smoke.py holds the card's launch
    counters to it.  The contextnet runs twice a geometry (frame 0 fed
    ``flow.0``, frame 1 ``flow.1``), four feature warps each."""
    if sites == "all":
        lower_gates(monkeypatch)
    sess = RIFE(str(model_dirs[variant]), device="cpu", **MODES[mode])
    size = SIZES[1]
    want = plan.kernel_sites(sess, *size)
    calls = {}
    spy(monkeypatch, calls)
    sess.process_batch(*frames(*size), HALF)
    assert {k: v for k, v in calls.items() if v} == want
    geoms = 2 if MODES[mode].get("tta_mode") else 1
    feat = 8 * geoms if variant == "rife" and mode != "-u" else None
    if feat:
        assert want["warp_feat"] == feat
    assert (want.get("conv3x3_ps", 0) > 0) == (sites == "all")


def test_contextnet_runs_are_not_batched(model_dirs, monkeypatch):
    """v1 runs the contextnet once per frame, frame 1 through the graph's
    ``flow.1`` negation: the features of frame 1 equal a run fed the negated
    flow as ``flow.0``."""
    sess = RIFE(str(model_dirs["rife"]), device="cpu")
    ex = sess.executors["contextnet"]
    seen = []
    real = ex.run
    monkeypatch.setattr(ex, "run", lambda inputs, *a, **k: seen.append(
        (sorted(inputs), inputs["input.1"].shape[0])) or real(inputs, *a,
                                                               **k))
    sess.process_batch(*frames(32, 64), HALF)
    assert seen == [(["flow.0", "input.1"], 2), (["flow.1", "input.1"], 2)]
    img = torch.rand(1, 3, 32, 64)
    flow = torch.randn(1, 2, 16, 32)
    ctx = {"w": sess.weights["contextnet"]}
    out = ["f1", "f2", "f3", "f4"]
    a = real({"input.1": img, "flow.1": flow}, out, ctx)
    b = real({"input.1": img, "flow.0": -flow}, out, ctx)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_timestep_other_than_half_raises(model_dirs):
    sess = RIFE(str(model_dirs["rife"]), device="cpu")
    a, b = frames(32, 32)
    with pytest.raises(ValueError, match="0.5"):
        sess.process_batch(a, b, np.array([0.5, 0.25], np.float32))


def test_session_weights_carry_the_ps_forms(model_dirs):
    """The ConvPS heads carry the packed tensor-core weights and the f32
    bias; the InnerProducts their (out, in) weights in the storage dtype."""
    sess = RIFE(str(model_dirs["rife"]), device="cpu", dtype=torch.bfloat16)
    graph = sess.executors["fusionnet"].graph
    (head,) = [n for n in graph.nodes if n.type == "rife.ConvPS"]
    e = sess.weights["fusionnet"][head.name]
    assert e["weight_tc"].shape == (9, 16, 16)
    assert e["bias_f32"].dtype == torch.float32
    ips = [n.name for n in graph.nodes if n.type == "InnerProduct"]
    assert ips and all(sess.weights["fusionnet"][n]["weight"].dtype
                       == torch.bfloat16 for n in ips)
