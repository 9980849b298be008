"""The slice end to end: rife_tpu_torch.RIFE against rife_tpu.RIFE on the
v4.6-architecture graph (in-repo reconstruction, synthetic weights), CPU, f32.

The JAX package on the CPU warps with the XLA ``warp_at`` form; the port's
CPU path runs the twins of the Pallas form (ops/warp.py).  The two round
differently, so the bar is u8 max |d| <= 1 with >= 99.9% of pixels exact, at
two sizes (32-aligned, and unaligned: pad and crop) and two timesteps, with
the rewrite chain on and off.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rife_tpu_torch import RIFE
from rife_tpu_torch.engine import session as session_mod
from rife_tpu_torch.models.v46_arch import write_flownet_param

SIZES = [(64, 96), (50, 70)]
TIMESTEPS = [0.5, 0.25]
REPO = Path(__file__).resolve().parent.parent


def frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, h, w, 3), np.uint8),
            rng.integers(0, 256, (2, h, w, 3), np.uint8))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_flownet_param(tmp_path_factory.mktemp("sess"), (16, 16, 16, 16))


@pytest.fixture(scope="module")
def jax_reference(model_dir):
    """rife_tpu outputs, built once per module: {(h, w, t): u8}."""
    from rife_tpu.engine.session import RIFE as JaxRIFE

    ref = JaxRIFE(str(model_dir))
    out = {}
    for h, w in SIZES:
        a, b = frames(h, w)
        for t in TIMESTEPS:
            out[(h, w, t)] = ref.process_batch(a, b, np.full(2, t, np.float32))
    return out


def assert_u8_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


@pytest.mark.parametrize("rewrite", [True, False])
@pytest.mark.parametrize("t", TIMESTEPS)
@pytest.mark.parametrize("size", SIZES)
def test_slice_matches_rife_tpu(model_dir, jax_reference, size, t, rewrite,
                                monkeypatch):
    if not rewrite:  # run the graph as parsed: unfused warps and render
        monkeypatch.setattr(session_mod, "rewrite_flownet",
                            lambda graph, weights, **_: (graph, weights))
    sess = RIFE(str(model_dir), device="cpu")
    assert sess.executor.render_planar == rewrite
    a, b = frames(*size)
    got = sess.process_batch(a, b, np.full(2, t, np.float32))
    assert_u8_close(got, jax_reference[(*size, t)])


def test_session_defaults(model_dir):
    sess = RIFE(str(model_dir), device="cpu")
    assert sess.dtype == torch.float32
    assert sess.executor.render_planar
    out = sess.process_batch_device(*frames(32, 32), np.full(2, 0.5))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.shape == (2, 32, 32, 3) and out.dtype == torch.uint8


def test_kernel_operands_on_main_path(model_dir, monkeypatch):
    """The tensors the session hands the warp wrappers meet the CUDA
    kernels' contract (3-channel contiguous NCHW images, contiguous flows
    and mask, one dtype), checked on the CPU where the twins run."""
    from rife_tpu_torch.ops import torch_ops

    seen = []

    def spy(name):
        real = getattr(torch_ops.W, name)

        def wrapper(*args):
            seen.append(name)
            imgs, flows = args[0:4:2], args[1:4:2]
            for t in (*imgs, *flows, *args[4:]):
                assert t.is_contiguous() and t.dtype == torch.float32
            assert all(t.dim() == 4 and t.shape[1] == 3 for t in imgs)
            assert all(t.dim() == 4 and t.shape[1] == 2 for t in flows)
            return real(*args)
        return wrapper

    for name in ("warp_pair", "warp_render", "warp_ds4_pair"):
        monkeypatch.setattr(torch_ops.W, name, spy(name))
    sess = RIFE(str(model_dir), device="cpu")
    for size in SIZES:
        seen.clear()
        sess.process_batch(*frames(*size), np.full(2, 0.5, np.float32))
        assert sorted(seen) == ["warp_ds4_pair", "warp_pair", "warp_pair",
                                "warp_render"]


def test_t_shortcuts_and_single_pair(model_dir):
    sess = RIFE(str(model_dir), device="cpu")
    a, b = frames(32, 64)
    assert np.array_equal(sess.process(a[0], b[0], 0.0), a[0])
    assert np.array_equal(sess.process(a[0], b[0], 1.0), b[0])
    mid = sess.process(a[0], b[0], 0.5)
    batch = sess.process_batch(a[:1], b[:1], np.array([0.5], np.float32))
    assert np.array_equal(mid, batch[0])


def test_unported_modes_raise(model_dir):
    """Nothing is refused any more: TTA runs on the v4 family and ``-u`` is
    ignored there, as in the JAX session (tests/test_torch_tta_session.py;
    UHD on v2: tests/test_torch_uhd_session.py), and a v1 dir builds, in
    every mode (the v1 family against rife_tpu:
    tests/test_torch_v1_session.py)."""
    from rife_tpu_torch.models.v1_arch import write_v1_params

    for mode in ({"tta_mode": True}, {"tta_temporal_mode": True},
                 {"uhd_mode": True}):
        RIFE(str(model_dir), device="cpu", **mode)
    v1 = write_v1_params(model_dir.parent, (8, 8, 8, 4), "rife-anime")
    for mode in ({}, {"tta_mode": True, "tta_temporal_mode": True},
                 {"uhd_mode": True}):
        sess = RIFE(str(v1), device="cpu", **mode)
        assert sess.model.family == "v1"
        assert sess.uhd_mode == bool(mode.get("uhd_mode"))
        assert set(sess.executors) == {"flownet", "contextnet", "fusionnet"}
        assert all(ex.ctx["planar_convs"] for ex in sess.executors.values())


def test_cuda_without_card_raises(model_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        RIFE(str(model_dir), device="cuda")


def test_bad_frames_raise(model_dir):
    sess = RIFE(str(model_dir), device="cpu")
    a, b = frames(32, 32)
    with pytest.raises(ValueError, match="mismatch"):
        sess.process_batch(a, b[:, :16], np.full(2, 0.5))
    with pytest.raises(ValueError, match="uint8"):
        sess.process_batch(a.astype(np.float32), b.astype(np.float32),
                           np.full(2, 0.5))


def test_port_never_imports_jax(model_dir):
    code = (
        "import sys, numpy as np\n"
        "from rife_tpu_torch import RIFE\n"
        "s = RIFE(sys.argv[1], device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "a = rng.integers(0, 256, (1, 32, 32, 3), np.uint8)\n"
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
