"""The single-warp twins of rife_tpu_torch.ops.warp against the Pallas kernels
they port (the CUDA kernel against the twins: tests/test_torch_cuda.py).

* ``warp_feat_ref`` (float mode) against K1 ``_warp_pallas_impl`` (f32) and
  K2 ``_warp_pallas_packed_impl`` (bf16): its multi-channel path at C=32 and
  C=64 (``_warp_kernel_packed_mct``), its single-pair path (odd word count,
  C=5), an odd C on the multi-channel path (C=7), and the ``abs_pos`` form;
* ``warp_u8_ref`` (u8 mode) against K4 ``_warp_pallas_u8_impl_any``, by a
  raw flow and at absolute positions.

All run under ``pltpu.force_tpu_interpret_mode`` (as tests/test_warp_pallas.py
does), i.e. against the Pallas form, not the XLA ``jax_ops.warp_at`` form the
JAX package runs on the CPU.  Shapes are lane-unaligned and the flows leave
the frame.  Tolerances: f32 max |d| <= 2e-6, because the Pallas kernels group
the four corner terms otherwise where x0 and x1 straddle a 128-lane tile or
the corners clamp together; bf16 <= 1 ulp (the same f32 difference can move
the one rounding), exact on >= 99% of elements.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rife_tpu.ops.warp_pallas import (
    _warp_pallas_impl,
    _warp_pallas_packed_impl,
    _warp_pallas_u8_impl_any,
)
from rife_tpu_torch.ops import warp as W
from rife_tpu_torch.ops import launch as L
from torch_other_device import elsewhere

KERNELS = {jnp.float32: _warp_pallas_impl, jnp.bfloat16: _warp_pallas_packed_impl}
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def feat_inputs(seed, b, h, w, c):
    """A feature map and a flow leaving the frame, NHWC numpy f32."""
    rng = np.random.default_rng(seed)
    img = (rng.normal(size=(b, h, w, c)) * 2.0).astype(np.float32)
    flow = (rng.normal(size=(b, h, w, 2)) * 5).astype(np.float32)
    flow[:, : h // 6] += 20.0
    flow[:, :, : w // 8, 0] -= 25.0
    return img, flow


def bf16_ulp(x):
    """Spacing of bf16 at |x| (bf16 keeps 8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def nchw(x, dt):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).to(dt)


def check(got, want, jd):
    got = np.moveaxis(got.float().numpy(), 1, -1)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if jd == jnp.float32:
        assert diff.max() <= 2e-6, diff.max()
    else:
        assert np.all(diff <= bf16_ulp(want)), diff.max()
        assert (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("jd,c,shape", [
    (jnp.float32, 32, (2, 20, 136)),
    (jnp.float32, 5, (1, 36, 132)),
    (jnp.bfloat16, 32, (2, 20, 136)),   # multi-channel, one group of 16 words
    (jnp.bfloat16, 64, (1, 12, 130)),   # multi-channel, two groups
    (jnp.bfloat16, 5, (1, 36, 132)),    # single-pair kernel (odd word count)
    (jnp.bfloat16, 7, (2, 16, 140)),    # odd C on the multi-channel kernel
])
def test_feat_twin_matches_pallas(jd, c, shape):
    img, flow = feat_inputs(c, *shape, c)
    ji, jf = jnp.asarray(img).astype(jd), jnp.asarray(flow).astype(jd)
    with pltpu.force_tpu_interpret_mode():
        ref = KERNELS[jd](ji, jf)
    td = TORCH[jd]
    # the port takes the flow in the storage dtype, as the graph hands it over
    got = W.warp_feat_ref(nchw(np.asarray(ji, np.float32), td),
                          nchw(np.asarray(jf, np.float32), td))
    assert got.dtype == td
    check(got, ref, jd)


@pytest.mark.parametrize("jd", [jnp.float32, jnp.bfloat16])
def test_feat_twin_abs_pos_matches_pallas(jd):
    """The ``abs_pos`` form (``rife.WarpDs4`` on a float image): sampled at
    the tap grid's absolute positions, a decoupled (H/2, W/2) output grid."""
    img, flow = feat_inputs(9, 2, 24, 136, 6)
    td = TORCH[jd]
    pos = W.ds4_positions(nchw(flow, torch.float32).to(td))
    ji = jnp.asarray(img).astype(jd)
    with pltpu.force_tpu_interpret_mode():
        ref = KERNELS[jd](ji, jnp.asarray(np.moveaxis(pos.numpy(), 1, -1)),
                          abs_pos=True)
    got = W.warp_feat_ref(nchw(np.asarray(ji, np.float32), td), pos,
                          abs_pos=True)
    assert got.shape == (2, 6, 12, 68)
    check(got, ref, jd)


@pytest.mark.parametrize("jd", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("abs_pos", [False, True])
def test_u8_twin_matches_pallas(jd, abs_pos):
    """K4, the single u8-origin warp (an unpaired ``rife.Warp`` of a frame
    copy), in its slab variant (the ``warp_pallas`` default)."""
    rng = np.random.default_rng(11)
    img = (rng.integers(0, 256, (2, 40, 200, 3)) / 255.0).astype(np.float32)
    _, flow = feat_inputs(12, 2, 40, 200, 3)
    td = TORCH[jd]
    f = nchw(flow, td)
    arg = W.ds4_positions(f) if abs_pos else f
    with pltpu.force_tpu_interpret_mode():
        ref = _warp_pallas_u8_impl_any(
            jnp.asarray(img).astype(jd),
            jnp.asarray(np.moveaxis(arg.float().numpy(), 1, -1)).astype(
                jnp.float32 if abs_pos else jd),
            slab_mode=True, abs_pos=abs_pos)
    got = W.warp_u8_ref(nchw(img, td), arg, abs_pos=abs_pos)
    check(got, ref, jd)


def test_feat_twin_zero_flow_is_identity():
    img, _ = feat_inputs(13, 1, 12, 20, 4)
    x = nchw(img, torch.float32)
    assert torch.equal(W.warp_feat_ref(x, torch.zeros(1, 2, 12, 20)), x)


def test_cpu_single_wrappers_take_twins_without_counting():
    img, flow = feat_inputs(14, 1, 16, 24, 3)
    x, f = nchw(img, torch.float32), nchw(flow, torch.float32)
    W.reset_launches()
    assert torch.equal(W.warp_feat(x, f), W.warp_feat_ref(x, f))
    u = torch.rand(1, 3, 16, 24)
    assert torch.equal(W.warp_u8(u, f), W.warp_u8_ref(u, f))
    pos = W.ds4_positions(f)
    assert torch.equal(W.warp_feat(x, pos, abs_pos=True),
                       W.warp_feat_ref(x, pos, abs_pos=True))
    assert all(v == 0 for v in W.LAUNCHES.values())


def test_single_wrappers_reject_other_devices():
    """A device neither the CPU, a card nor a plan's meta raises; meta
    tensors pass the checks and launch nothing."""
    img, flow = elsewhere(1, 4, 8, 8), elsewhere(1, 2, 8, 8)
    for call in (lambda: W.warp_feat(img, flow),
                 lambda: W.warp_u8(elsewhere(1, 3, 8, 8), flow)):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()
    meta = torch.empty(1, 4, 8, 8, device="meta")
    flow = torch.empty(1, 2, 8, 8, device="meta")
    with L.planning("cuda") as calls:
        assert W.warp_feat(meta, flow).shape == (1, 4, 8, 8)
        assert W.warp_u8(meta[:, :3].contiguous(), flow).shape == (1, 3, 8, 8)
        with pytest.raises(ValueError, match="3 channels"):
            W.warp_u8(meta, flow)
    assert calls == [("warp_feat", None), ("warp_u8", None)]


def test_ds4_twin_is_tap_grid_composition():
    """``warp_ds4_u8_ref`` is the u8 twin at the tap positions, halved
    twice (the form the unpaired ``rife.WarpDs4`` takes)."""
    rng = np.random.default_rng(15)
    u = torch.from_numpy((rng.integers(0, 256, (1, 3, 16, 24)) / 255.0)
                         .astype(np.float32))
    f = torch.from_numpy((rng.normal(size=(1, 2, 16, 24)) * 3)
                         .astype(np.float32))
    want = W.half_sum2(W.warp_u8_ref(u, W.ds4_positions(f), abs_pos=True))
    assert torch.equal(W.warp_ds4_u8_ref(u, f), want)
    assert want.shape == (1, 3, 4, 6)
