"""The ``-x``/``-z`` TTA sessions of the v2.3-architecture graphs (in-repo
reconstruction, synthetic weights, mini widths) against rife_tpu.RIFE with
the same modes, CPU, f32.

The bar is that of tests/test_torch_v23_session.py: u8 max |d| <= 1 with >=
99.9% of pixels exact, at a 32-aligned size and an unaligned one (pad and
crop, and a transposed view group of another padded shape), t = 0.5 (the v2
family interpolates the midpoint only). The last case runs ``fuse_ds2=True``
against rife_tpu built with ``RIFE_TPU_FUSE_DS2=1``. The port alone is also
held to the properties tests/test_engine.py states for rife_tpu: dihedral
equivariance under ``-x`` and time symmetry under ``-z``.
"""

import numpy as np
import pytest
import torch

from rife_tpu_torch import RIFE
from rife_tpu_torch.models.v23_arch import write_v23_params

ALIGNED, UNALIGNED = (64, 96), (50, 70)
MODES = {"x": (True, False), "z": (False, True), "xz": (True, True)}
# each mode once, -x -z at both sizes (with and without the switch): the
# JAX references compile once per case, ~5-20 s each on the CPU
CASES = [("x", ALIGNED, False), ("z", UNALIGNED, False),
         ("xz", ALIGNED, False), ("xz", UNALIGNED, True)]
TIMESTEPS = np.full(2, 0.5, np.float32)


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


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_v23_params(tmp_path_factory.mktemp("tta23"), (8, 8, 8, 8, 4))


@pytest.mark.parametrize("mode,size,fuse", CASES)
def test_tta_matches_rife_tpu(model_dir, mode, size, fuse):
    from rife_tpu.engine.session import RIFE as JaxRIFE

    tta, temporal = MODES[mode]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RIFE_TPU_FUSE_DS2", "1" if fuse else "0")
        ref = JaxRIFE(str(model_dir), tta_mode=tta,
                      tta_temporal_mode=temporal)
    want = ref.process_batch(*frames(*size), TIMESTEPS)
    sess = RIFE(str(model_dir), device="cpu", tta_mode=tta,
                tta_temporal_mode=temporal, fuse_ds2=fuse)
    assert_u8_close(sess.process_batch(*frames(*size), TIMESTEPS), want)


def test_tta_differs_from_plain(model_dir):
    a, b = frames(*UNALIGNED, seed=3)
    plain = RIFE(str(model_dir), device="cpu").process_batch(a, b, TIMESTEPS)
    for tta, temporal in MODES.values():
        out = RIFE(str(model_dir), device="cpu", tta_mode=tta,
                   tta_temporal_mode=temporal).process_batch(a, b, TIMESTEPS)
        assert out.shape == plain.shape and not np.array_equal(out, plain)


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
