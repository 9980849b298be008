"""UHD ``-u`` on the v2.3-architecture graphs (in-repo reconstruction,
synthetic weights, mini widths) against rife_tpu.RIFE with the same modes.

With ``-u`` the flownet runs on the padded frames halved by ``resize2d``,
with ctx ``no_u8_warp`` (every flownet warp takes the float warp), and its
flow comes back resized x2 and scaled by 2; the contextnet and fusionnet run
at full resolution as without ``-u`` (``rife_tpu/engine/pipelines.py``
``_run_flownet``).

Bars:

* f32 against rife_tpu's default CPU path: u8 max |d| <= 1 with >= 99.9% of
  pixels exact (the bar of tests/test_torch_v23_session.py: the JAX package
  warps with ``warp_at`` there), for ``-u`` alone, with ``-x``, ``-z``,
  ``-x -z`` and with ``fuse_ds2`` (against ``RIFE_TPU_FUSE_DS2=1``);
* bf16 against rife_tpu's Pallas forms (``use_pallas_warp`` on each
  executor's ctx, interpret mode, as tests/test_torch_bf16_session.py
  does): bit-exact for ``-u`` at both sizes and for ``-u -x -z`` and
  ``-u`` with ``fuse_ds2`` at 64x128 (``-x`` and ``-z`` alone are parts of
  ``-x -z``);
* ``resize2d`` equals ``jax_ops.resize2d`` bit for bit on the steps UHD
  takes (1/2 of 3-channel frames, x2 of 4-channel flows), f32 and bf16;
* the launch plan: no u8-origin launch from the UHD flownet, and the plan
  equals the wrappers the session calls.

Sizes: the reconstruction's flownet reaches 1/32 of its input, so ``-u``
needs padded frames whose halves are multiples of 32: 64x128 and 50x110
(padded to 64x128; the transposed ``-x`` group 128x64).  At 64x96 the
halved frames are 32x48, and rife_tpu and the port both raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rife_tpu.ops import jax_ops
from rife_tpu_torch import RIFE
from rife_tpu_torch.engine import plan
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import torch_ops
from rife_tpu_torch.ops import warp as W

ALIGNED, UNALIGNED = (64, 128), (50, 110)
MODES = {"u": {}, "u -x": {"tta_mode": True},
         "u -z": {"tta_temporal_mode": True},
         "u -x -z": {"tta_mode": True, "tta_temporal_mode": True},
         "u fuse_ds2": {"fuse_ds2": True}}
CASES = [("u", ALIGNED), ("u -x", ALIGNED), ("u -z", UNALIGNED),
         ("u -x -z", UNALIGNED), ("u fuse_ds2", ALIGNED)]
HALF = np.full(2, 0.5, np.float32)
WARPS = ("warp_pair", "warp_ds4_pair", "warp_ds2", "warp_render",
         "warp_u8", "warp_feat")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Mini-width tensors gain nothing from torch's thread pool, and the
    suite runs several test processes at once: one thread each keeps them
    from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, h, w, 3), np.uint8),
            rng.integers(0, 256, (2, h, w, 3), np.uint8))


def smooth_frames(h, w, seed=3):
    """u8 frame pairs (2,H,W,3) as tests/test_torch_bf16_session.py makes
    them: smooth colour fields plus texture, frame 1 shifted by a few
    pixels."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.normal(size=(2, 3, 6, 10)).astype(np.float32))
    base = torch.nn.functional.interpolate(
        coarse, size=(h + 16, w + 16), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    base = base * 60 + 128
    base += rng.normal(size=base.shape).astype(np.float32) * 8
    return tuple(np.ascontiguousarray(np.clip(f, 0, 255).astype(np.uint8))
                 for f in (base[:, 8:8 + h, 8:8 + w],
                           base[:, 5:5 + h, 11:11 + w]))


def u8_gap(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(diff.max()), float((diff == 0).mean())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_v23_params(tmp_path_factory.mktemp("uhd23"), (8, 8, 8, 8, 4))


def jax_uhd(model_dir, modes, dtype="float32"):
    """rife_tpu's ``-u`` session with ``modes`` (``fuse_ds2`` as the
    environment switch it reads at construction)."""
    from rife_tpu.engine.session import RIFE as JaxRIFE

    modes = dict(modes)
    fuse = modes.pop("fuse_ds2", False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RIFE_TPU_FUSE_DS2", "1" if fuse else "0")
        return JaxRIFE(str(model_dir), uhd_mode=True, dtype=dtype, **modes)


@pytest.mark.parametrize("mode,size", CASES)
def test_uhd_f32_matches_rife_tpu(model_dir, mode, size):
    a, b = frames(*size)
    want = jax_uhd(model_dir, MODES[mode]).process_batch(a, b, HALF)
    got = RIFE(str(model_dir), device="cpu", uhd_mode=True,
               **MODES[mode]).process_batch(a, b, HALF)
    worst, exact = u8_gap(got, want)
    assert worst <= 1 and exact >= 0.999, (worst, exact)


def bf16_gap_to_pallas_forms(model_dir, mode, size):
    """The port's bf16 ``-u`` session with ``mode`` against rife_tpu's, whose
    warps take their Pallas forms in interpret mode."""
    f0, f1 = smooth_frames(*size)
    jsess = jax_uhd(model_dir, MODES[mode], dtype="bfloat16")
    for ex in jsess.executors.values():
        ex.ctx["use_pallas_warp"] = True
    with pltpu.force_tpu_interpret_mode():
        want = jsess.process_batch(f0, f1, HALF)
    got = RIFE(str(model_dir), device="cpu", dtype=torch.bfloat16,
               uhd_mode=True, **MODES[mode]).process_batch(f0, f1, HALF)
    return u8_gap(got, want)


@pytest.mark.parametrize("size", [ALIGNED, UNALIGNED])
def test_uhd_bf16_bit_exact_with_pallas_forms(model_dir, size):
    assert bf16_gap_to_pallas_forms(model_dir, "u", size) == (0, 1.0)


@pytest.mark.parametrize("mode", ["u -x -z", "u fuse_ds2"])
def test_uhd_tta_and_fused_bf16_bit_exact_with_pallas_forms(model_dir, mode):
    """``-x -z`` takes the transposed view group and the bf16 temporal flow
    average on the resized flows; ``fuse_ds2`` changes no UHD flownet warp
    (``no_u8_warp`` keeps K3 off it) but rewrites the graph."""
    assert bf16_gap_to_pallas_forms(model_dir, mode, ALIGNED) == (0, 1.0)


def test_uhd_at_sizes_the_flownet_cannot_take_raises_as_rife_tpu(model_dir):
    """64x96 pads to itself; halved, 32x48 is not a multiple of 32, and the
    flownet's deepest level comes back on another grid than the frames it
    warps: rife_tpu raises (a broadcast error) and so does the port."""
    a, b = frames(64, 96)
    with pytest.raises(TypeError):
        jax_uhd(model_dir, {}).process_batch(a, b, HALF)
    with pytest.raises(ValueError, match="not on the grid"):
        RIFE(str(model_dir), device="cpu",
             uhd_mode=True).process_batch(a, b, HALF)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("what,shape,step", [
    ("frames 1/2", (2, 64, 128, 3), 0.5), ("flow x2", (2, 16, 32, 4), 2.0),
    ("transposed frames 1/2", (2, 128, 64, 3), 0.5)])
def test_resize2d_matches_jax_on_uhd_steps(what, shape, step, dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32) * 3
    b, h, w, _ = shape
    oh, ow = int(h * step), int(w * step)
    want = np.asarray(jax_ops.resize2d(jnp.asarray(x, dtype), oh, ow),
                      np.float32)
    td = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = torch_ops.resize2d(torch.from_numpy(x).permute(0, 3, 1, 2).to(td),
                             oh, ow)
    np.testing.assert_array_equal(
        got.float().permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("modes", [{}, {"fuse_ds2": True},
                                   {"tta_mode": True,
                                    "tta_temporal_mode": True}])
def test_uhd_plan_has_no_u8_flownet_launch(model_dir, modes):
    """Under ``-u`` every flownet warp is a float warp: no pair, ds4-pair,
    K3 or u8 single-warp launch comes from the flownet; the fusionnet's two
    full-resolution frame warps stay u8 (K4).  The plan's launches equal the
    wrappers the CPU session calls, run by run."""
    sess = RIFE(str(model_dir), device="cpu", uhd_mode=True, **modes)
    base = RIFE(str(model_dir), device="cpu", **modes)
    sites = plan.kernel_sites(sess, *ALIGNED)
    runs = 4 if modes.get("tta_mode") else 1
    sweeps = 2 if modes.get("tta_temporal_mode") else 1
    assert set(sites) == {"warp_feat", "warp_u8"}
    # contextnet: 4 float warps a geometry; flownet: its 6 frame warps, as
    # float warps, every sweep
    geoms = 2 if runs == 4 else 1
    assert sites["warp_feat"] == geoms * (4 + 6 * sweeps)
    assert sites["warp_u8"] == geoms * 2 * sweeps
    assert plan.kernel_sites(base, *ALIGNED)["warp_u8"] == sites["warp_u8"]

    calls = {k: 0 for k in WARPS}

    def spy(name):
        real = getattr(W, name)

        def wrapper(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        for name in WARPS:
            mp.setattr(W, name, spy(name))
        sess.process_batch(*frames(*ALIGNED, seed=2), HALF)
    assert {k: v for k, v in calls.items() if v} == sites


def test_uhd_conv_sites_follow_the_halved_flownet(model_dir, monkeypatch):
    """With the gates lowered to 0, every admissible site takes
    ``conv3x3``'s twin (a deconv site through ``deconv4x4``): the plan's
    sites under ``-u`` (the flownet's at the halved frames) are the calls
    the session makes, input size by input size."""
    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    sess = RIFE(str(model_dir), device="cpu", uhd_mode=True)
    planned = sorted((h, w) for (*_, h, w, _), n in
                     plan.conv_site_counts(sess, *ALIGNED) for _ in range(n))
    seen = []
    real = CV.conv3x3

    def spy(parts, *args, **kw):
        # a deconv site on the CPU is one conv3x3 call over its phases
        seen.append(tuple(parts[0].shape[2:]))
        return real(parts, *args, **kw)
    monkeypatch.setattr(CV, "conv3x3", spy)
    sess.process_batch(*frames(*ALIGNED, seed=4), HALF)
    assert sorted(seen) == planned
    assert plan.kernel_sites(sess, *ALIGNED)["conv3x3"] == len(planned)
    # the flownet's finest level enters at the halved frames
    assert (ALIGNED[0] // 2, ALIGNED[1] // 2) in planned
