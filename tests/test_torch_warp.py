"""The three warp twins of rife_tpu_torch.ops.warp against the Pallas kernels
they port (the CUDA kernels against the twins: tests/test_torch_cuda.py).

Reference: ``warp_pallas_pair`` run under ``pltpu.force_tpu_interpret_mode``
(as tests/test_warp_pallas.py does), i.e. the Pallas form of the u8-origin
warp, not the XLA ``jax_ops.warp_at`` form.  Shapes are lane-unaligned and
the flows leave the frame.  Tolerances: f32 max |d| <= 2e-6, because the
Pallas core sums per-tile partials in another order
(warp_pallas.py:1096-1099); bf16 <= 1 ulp, exact on >= 99% of elements.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rife_tpu.ops import jax_ops
from rife_tpu.ops.warp_pallas import warp_pallas_pair
from rife_tpu_torch.ops import warp as W
from rife_tpu_torch.ops import launch as L
from torch_other_device import elsewhere

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
SHAPES = [(2, 40, 200), (1, 36, 132)]


def make_inputs(seed, b, h, w):
    """u8-valued images, flows that leave the frame, a mask (numpy, NHWC)."""
    rng = np.random.default_rng(seed)
    img = lambda: (rng.integers(0, 256, (b, h, w, 3)) / 255.0).astype(  # noqa: E731
        np.float32)
    fa = (rng.normal(size=(b, h, w, 2)) * 6).astype(np.float32)
    fa[:, : h // 8] += 30.0
    fb = (rng.normal(size=(b, h, w, 2)) * 6).astype(np.float32)
    fb[:, :, : w // 10, 0] -= 40.0
    mask = rng.uniform(0, 1, (b, h, w)).astype(np.float32)
    return img(), fa, img(), fb, mask


def to_jax(xs, jd):
    return [jnp.asarray(x).astype(jd) for x in xs]


def to_torch(xs, td, device="cpu"):
    """NHWC numpy -> NCHW torch in the storage dtype (mask stays (B,H,W))."""
    out = []
    for x in xs:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if x.ndim == 4:
            t = t.permute(0, 3, 1, 2).contiguous()
        out.append(t.to(device=device, dtype=td))
    return out


def nhwc(t):
    return t.float().cpu().permute(0, 2, 3, 1).numpy()


def bf16_ulp(x):
    """Spacing of bf16 at |x| (bf16 keeps 8 significant bits)."""
    x = np.abs(x).astype(np.float32)
    e = np.floor(np.log2(np.maximum(x, 2.0 ** -126)))
    return 2.0 ** (e - 7)


def check(got, want, jd):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if jd == jnp.float32:
        assert diff.max() <= 2e-6, diff.max()
    else:
        assert np.all(diff <= bf16_ulp(want)), diff.max()
        assert (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_pair_twin_matches_pallas(shape, jd, td):
    ia, fa, ib, fb, _ = make_inputs(1, *shape)
    with pltpu.force_tpu_interpret_mode():
        ref = warp_pallas_pair.__wrapped__(*to_jax([ia, fa, ib, fb], jd))
    got = W.warp_pair_ref(*to_torch([ia, fa, ib, fb], td))
    for r, g in zip(ref, got):
        assert g.dtype == td
        check(nhwc(g), r, jd)


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_render_twin_matches_pallas(shape, jd, td):
    ia, fa, ib, fb, m = make_inputs(2, *shape)
    with pltpu.force_tpu_interpret_mode():
        ref = warp_pallas_pair.__wrapped__(
            *to_jax([ia, fa, ib, fb, m], jd), blend=True, planar_out=True)
    got = W.warp_render_ref(*to_torch([ia, fa, ib, fb, m], td))
    assert got.shape == (shape[0], shape[1], 3, shape[2]) and got.dtype == td
    # planar (B,H,3,W) -> NHWC on both sides
    check(got.float().permute(0, 1, 3, 2).numpy(),
          np.asarray(ref, np.float32).transpose(0, 1, 3, 2), jd)


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_ds4_pair_twin_matches_pallas(shape, jd, td):
    """K7's composed form: the abs-position pair on the tap grid, then the
    two 0.5/0.5 downsample passes (jax_ops._op_warp_ds4_pair)."""
    ia, fa, ib, fb, _ = make_inputs(3, *shape)
    ja, jfa, jb, jfb = to_jax([ia, fa, ib, fb], jd)
    sxa, sya = jax_ops._ds4_abs_positions(ja, jfa)
    sxb, syb = jax_ops._ds4_abs_positions(jb, jfb)
    with pltpu.force_tpu_interpret_mode():
        ya, yb = warp_pallas_pair.__wrapped__(
            ja, jnp.stack([sxa, sya], -1), jb, jnp.stack([sxb, syb], -1),
            abs_pos=True)
    ds = jax_ops._downsample_axis
    ref = [ds(ds(y, 2, 1), 2, 2) for y in (ya, yb)]
    got = W.warp_ds4_pair_ref(*to_torch([ia, fa, ib, fb], td))
    for r, g in zip(ref, got):
        assert g.shape == (shape[0], 3, shape[1] // 4, shape[2] // 4)
        check(nhwc(g), r, jd)


def test_twin_zero_flow_is_identity():
    ia, _, ib, _, _ = make_inputs(4, 1, 16, 24)
    a, b = to_torch([ia, ib], torch.float32)
    z = torch.zeros(1, 2, 16, 24)
    oa, ob = W.warp_pair_ref(a, z, b, z)
    assert torch.allclose(oa, a, atol=1e-7) and torch.allclose(ob, b, atol=1e-7)


def test_cpu_wrappers_take_twins_without_counting():
    ia, fa, ib, fb, m = to_torch(make_inputs(5, 1, 16, 24), torch.float32)
    W.reset_launches()
    for got, want in zip(W.warp_pair(ia, fa, ib, fb),
                         W.warp_pair_ref(ia, fa, ib, fb)):
        assert torch.equal(got, want)
    assert torch.equal(W.warp_render(ia, fa, ib, fb, m),
                       W.warp_render_ref(ia, fa, ib, fb, m))
    for got, want in zip(W.warp_ds4_pair(ia, fa, ib, fb),
                         W.warp_ds4_pair_ref(ia, fa, ib, fb)):
        assert torch.equal(got, want)
    assert all(v == 0 for v in W.LAUNCHES.values())


def test_non_cpu_tensors_never_take_the_twins(monkeypatch):
    """Only a CPU tensor takes the plain twin; any other device goes to the
    kernel path, which validates: a plan's meta tensors pass and launch
    nothing, any other device raises rather than fall back."""
    def twin(*args):
        raise AssertionError("a twin ran off the CPU")

    for name in ("warp_pair_ref", "warp_ds4_pair_ref", "warp_render_ref"):
        monkeypatch.setattr(W, name, twin)
    meta = [torch.empty(1, c, 8, 8, device="meta") for c in (3, 2, 3, 2)]
    mask = torch.empty(1, 8, 8, device="meta")
    with L.planning("cuda") as calls:
        shapes = [tuple(W.warp_pair(*meta)[1].shape),
                  tuple(W.warp_ds4_pair(*meta)[1].shape),
                  tuple(W.warp_render(*meta, mask).shape)]
    assert [name for name, _ in calls] == ["warp_pair", "warp_ds4_pair",
                                           "warp_render"]
    assert shapes == [(1, 3, 8, 8), (1, 3, 2, 2), (1, 8, 3, 8)]
    other = [elsewhere(1, c, 8, 8) for c in (3, 2, 3, 2)]
    for call in (lambda: W.warp_pair(*other),
                 lambda: W.warp_ds4_pair(*other),
                 lambda: W.warp_render(*other, elsewhere(1, 8, 8))):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without nvcc the kernel build raises; nothing falls back."""
    from rife_tpu_torch.native import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.compile_library()
