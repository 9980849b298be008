"""The port on the card: each CUDA warp kernel against its plain PyTorch twin,
and the slice on CUDA against the same session on the CPU.

Every test here is marked ``cuda`` and skips without a GPU (a CUDA kernel has
no CPU mode).  The file imports no jax, so it also runs where jax is absent:
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.
Tolerances: those of tests/test_torch_warp.py for the kernels (f32 max
|d| <= 2e-6; bf16 <= 1 ulp and exact on >= 99%); for the slice, u8 max
|d| <= 1 and exact on >= 99.9% of pixels (cuDNN sums in another order than
the CPU).
"""

import numpy as np
import pytest
import torch

from rife_tpu_torch.ops import warp as W

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def inputs(seed, b, h, w, dtype, device):
    """NCHW u8-valued images, flows leaving the frame, a (B,H,W) mask."""
    rng = np.random.default_rng(seed)
    img = lambda: rng.integers(0, 256, (b, 3, h, w)) / 255.0  # noqa: E731
    fa = rng.normal(size=(b, 2, h, w)) * 6
    fa[:, :, : h // 8] += 30.0
    fb = rng.normal(size=(b, 2, h, w)) * 6
    fb[:, 0, :, : w // 10] -= 40.0
    mask = rng.uniform(0, 1, (b, h, w))
    return [torch.from_numpy(x.astype(np.float32)).to(device=device,
                                                       dtype=dtype)
            for x in (img(), fa, img(), fb, mask)]


def check(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs().cpu()
    if want.dtype == torch.float32:
        assert float(diff.max()) <= 2e-6
    else:
        r = want.float().abs().cpu().clamp_min(2.0 ** -126)
        assert bool((diff <= torch.pow(2.0, torch.floor(torch.log2(r)) - 7)).all())
        assert float((diff == 0).float().mean()) >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 68, 260), (1, 1088, 1920)])
def test_kernels_match_twins(cuda_device, shape, dtype):
    ia, fa, ib, fb, m = inputs(6, *shape, dtype, cuda_device)
    W.reset_launches()
    got = [*W.warp_pair(ia, fa, ib, fb), W.warp_render(ia, fa, ib, fb, m),
           *W.warp_ds4_pair(ia, fa, ib, fb)]
    want = [*W.warp_pair_ref(ia, fa, ib, fb),
            W.warp_render_ref(ia, fa, ib, fb, m),
            *W.warp_ds4_pair_ref(ia, fa, ib, fb)]
    torch.cuda.synchronize()
    assert W.LAUNCHES == {"warp_pair": 1, "warp_render": 1, "warp_ds4_pair": 1}
    for g, r in zip(got, want):
        check(g, r)


def test_wrappers_reject_bad_operands(cuda_device):
    ia, fa, ib, fb, _ = inputs(7, 1, 16, 24, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        W.warp_pair(ia, fa.transpose(2, 3).contiguous().transpose(2, 3),
                    ib, fb)
    with pytest.raises(ValueError, match="flow"):
        W.warp_pair(ia, fa[:, :1].contiguous(), ib, fb)
    with pytest.raises(TypeError):
        W.warp_pair(ia.half(), fa.half(), ib.half(), fb.half())
    with pytest.raises(ValueError, match="divisible by 4"):
        W.warp_ds4_pair(*[t[..., :22].contiguous() for t in (ia, fa, ib, fb)])


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from rife_tpu_torch.models.v46_arch import write_flownet_param

    return write_flownet_param(tmp_path_factory.mktemp("cuda"), (16, 16, 16, 16))


def frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, h, w, 3), np.uint8),
            rng.integers(0, 256, (2, h, w, 3), np.uint8))


def test_slice_f32_matches_cpu(cuda_device, model_dir, monkeypatch):
    from rife_tpu_torch import RIFE

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    a, b = frames(64, 96)
    ts = np.full(2, 0.5, np.float32)
    want = RIFE(str(model_dir), device="cpu").process_batch(a, b, ts)
    got = RIFE(str(model_dir), device=cuda_device,
               dtype=torch.float32).process_batch(a, b, ts)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_slice_launches_each_kernel_per_step(cuda_device, model_dir):
    from rife_tpu_torch import RIFE

    sess = RIFE(str(model_dir), device=cuda_device)
    assert sess.dtype == torch.bfloat16
    a, b = frames(64, 96)
    W.reset_launches()
    out = sess.process_batch_device(a, b, np.full(2, 0.5, np.float32))
    torch.cuda.synchronize()
    assert out.shape == (2, 64, 96, 3) and out.device.type == "cuda"
    assert W.LAUNCHES == {"warp_pair": 2, "warp_render": 1, "warp_ds4_pair": 1}


def test_unfused_warp_raises_on_cuda(cuda_device, model_dir, monkeypatch):
    """Without the rewrites the graph runs unpaired warps, whose kernel (K4)
    is not ported: the card raises instead of taking plain torch."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine import session

    monkeypatch.setattr(session, "rewrite_flownet",
                        lambda graph, weights: (graph, weights))
    sess = RIFE(str(model_dir), device=cuda_device)
    a, b = frames(32, 32)
    with pytest.raises(NotImplementedError, match="K4"):
        sess.process_batch(a, b, np.full(2, 0.5, np.float32))
