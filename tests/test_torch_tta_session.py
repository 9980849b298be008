"""The ``-x``/``-z`` TTA sessions of the v4.6-architecture graph (in-repo
reconstruction, synthetic weights, mini widths) against rife_tpu.RIFE with
the same modes, CPU, f32, and the ``-u`` rule of each family (ignored for
v4, run for v2).

The JAX package on the CPU warps with the XLA ``warp_at`` form and the port
with the twins of the Pallas form, so the bar is that of
tests/test_torch_session.py: u8 max |d| <= 1 with >= 99.9% of pixels exact.
Each case runs a batch of two pairs at t = 0.5 and t = 0.25 (per-item
timesteps, so the view groups' timestep planes are checked item by item), at a
32-aligned size and an unaligned one (pad and crop, and a transposed group of
another padded shape). The last case runs ``fuse_ds2=True`` against rife_tpu
built with ``RIFE_TPU_FUSE_DS2=1``. The port alone is also held to the
properties tests/test_engine.py states for rife_tpu: dihedral equivariance
under ``-x`` and time symmetry under ``-z``.
"""

import numpy as np
import pytest
import torch

from rife_tpu_torch import RIFE
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.models.v46_arch import write_flownet_param

ALIGNED, UNALIGNED = (64, 96), (50, 70)
MODES = {"x": (True, False), "z": (False, True), "xz": (True, True)}
# each mode once, -x -z at both sizes (with and without the switch): the
# JAX references compile once per case, ~5-20 s each on the CPU
CASES = [("x", ALIGNED, False), ("z", UNALIGNED, False),
         ("xz", ALIGNED, False), ("xz", UNALIGNED, True)]
TIMESTEPS = np.array([0.5, 0.25], np.float32)


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


def assert_u8_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


def jax_tta(model_dir, mode, fuse, size, timesteps):
    """rife_tpu's output for one TTA case (the env switch is read when the
    session is built)."""
    from rife_tpu.engine.session import RIFE as JaxRIFE

    tta, temporal = MODES[mode]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RIFE_TPU_FUSE_DS2", "1" if fuse else "0")
        ref = JaxRIFE(str(model_dir), tta_mode=tta,
                      tta_temporal_mode=temporal)
    return ref.process_batch(*frames(*size), timesteps)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_flownet_param(tmp_path_factory.mktemp("tta46"),
                               (16, 16, 16, 16))


@pytest.mark.parametrize("mode,size,fuse", CASES)
def test_tta_matches_rife_tpu(model_dir, mode, size, fuse):
    tta, temporal = MODES[mode]
    sess = RIFE(str(model_dir), device="cpu", tta_mode=tta,
                tta_temporal_mode=temporal, fuse_ds2=fuse)
    got = sess.process_batch(*frames(*size), TIMESTEPS)
    assert_u8_close(got, jax_tta(model_dir, mode, fuse, size, TIMESTEPS))


def test_tta_differs_from_plain_and_keeps_shortcuts(model_dir):
    """TTA changes the result (the views are really merged), and t = 0 / 1
    still return the inputs."""
    a, b = frames(*UNALIGNED, seed=3)
    plain = RIFE(str(model_dir), device="cpu").process_batch(a, b, TIMESTEPS)
    sess = RIFE(str(model_dir), device="cpu", tta_mode=True,
                tta_temporal_mode=True)
    out = sess.process_batch(a, b, TIMESTEPS)
    assert out.shape == plain.shape and not np.array_equal(out, plain)
    assert np.array_equal(sess.process(a[0], b[0], 0.0), a[0])
    assert np.array_equal(sess.process(a[0], b[0], 1.0), b[0])


def test_uhd_mode_is_ignored_for_v4(model_dir):
    """The JAX session drops ``-u`` for the v4 family
    (rife_tpu/engine/session.py:102); so does the port."""
    a, b = frames(*ALIGNED, seed=4)
    want = RIFE(str(model_dir), device="cpu").process_batch(a, b, TIMESTEPS)
    got = RIFE(str(model_dir), device="cpu",
               uhd_mode=True).process_batch(a, b, TIMESTEPS)
    np.testing.assert_array_equal(got, want)


def test_uhd_mode_still_raises_for_v2(tmp_path):
    """Unlike v4, the v2 family takes ``-u``: it runs, and its result
    differs from the plain path's (the flownet sees the frames halved;
    tests/test_torch_uhd_session.py holds it to rife_tpu)."""
    v23 = write_v23_params(tmp_path, (8, 8, 8, 8, 4))
    a, b = frames(64, 128, seed=4)
    half = np.full(2, 0.5, np.float32)
    plain = RIFE(str(v23), device="cpu").process_batch(a, b, half)
    uhd = RIFE(str(v23), device="cpu", uhd_mode=True).process_batch(a, b,
                                                                    half)
    assert uhd.shape == plain.shape and uhd.dtype == np.uint8
    assert not np.array_equal(uhd, plain)


@pytest.mark.parametrize("modes", [{"tta_mode": True},
                                   {"tta_mode": True,
                                    "tta_temporal_mode": True}])
def test_tta_dihedral_equivariance(model_dir, modes):
    """Spatial TTA symmetrises over the 8-element dihedral group, so a
    180-degree rotation of the inputs rotates the output (32-aligned, no
    padding), up to the rounding of reassociated sums (as
    tests/test_engine.py holds rife_tpu)."""
    sess = RIFE(str(model_dir), device="cpu", **modes)
    a, b = frames(32, 64, seed=5)
    ts = np.full(2, 0.5, np.float32)
    rot = lambda x: x[:, ::-1, ::-1].copy()  # noqa: E731
    out = sess.process_batch(a, b, ts)
    diff = np.abs(sess.process_batch(rot(a), rot(b), ts).astype(int)
                  - rot(out).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.98


def test_temporal_tta_time_symmetry(model_dir):
    """With -z at t = 0.5, swapping the pair gives the same frame: the
    forward and reverse passes are averaged symmetrically."""
    sess = RIFE(str(model_dir), device="cpu", tta_temporal_mode=True)
    a, b = frames(32, 32, seed=6)
    ts = np.full(2, 0.5, np.float32)
    diff = np.abs(sess.process_batch(a, b, ts).astype(int)
                  - sess.process_batch(b, a, ts).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.98
