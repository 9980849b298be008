"""A CPU mirror of S, the sharded warp's kernel (``csrc/warp.cu``
``warp_spatial_kernel``): the positions it computes in registers from a
shard's raw flow rows and row0, and its 1/4 taps' averaging order, against
the positions tensors (``_grid_positions``, ``ds4_positions``) and
``half_sum2`` that ``warp_spatial``'s twin builds, bit for bit; and the
twin's rows against the unsharded twin's.  Cases: row0 0 and not, odd W,
flows that leave the frame, f32 and bf16, u8 and float modes.  On the card
the kernel against the twin: tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from rife_tpu_torch.ops import warp as W

DTYPES = [torch.float32, torch.bfloat16]


def inputs(seed, b, c, h, w, dtype, reach=6.0):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 1, (b, c, h, w)).astype(
        np.float32)).to(dtype)
    flow = rng.normal(size=(b, 2, h, w)).astype(np.float32) * reach
    flow[:, 1, : h // 5] += 3 * h  # rows whose samples leave the frame
    flow[:, 0, :, : w // 7] -= 2 * w
    return img, torch.from_numpy(flow).to(dtype)


def q(v, dtype):
    return v.to(dtype).float()


def kernel_positions(fl, row0):
    """The kernel's (sx, sy) of each output pixel (x, y) of the shard: f32(x)
    + f32(fx) and f32(row0 + y) + f32(fy), one f32 add each."""
    rows, w = fl.shape[2], fl.shape[3]
    xs = torch.tensor([float(x) for x in range(w)], dtype=torch.float32)
    ys = torch.tensor([float(row0 + y) for y in range(rows)],
                      dtype=torch.float32)
    return xs.reshape(1, 1, w) + fl[:, 0].float(), \
        ys.reshape(1, rows, 1) + fl[:, 1].float()


def kernel_ds4(full, fl, row0, u8):
    """The kernel's ds4 output: per 1/4 output (i, j) its taps (4i+1+ty,
    4j+1+tx) of the shard's flow rows at (lx + fx, (row0 + ly) + fy), each
    warp cast to the dtype; col[tx] = q(q(v0*.5) + q(v1*.5)) over ty, then
    q(q(col0*.5) + q(col1*.5))."""
    dt = full.dtype
    rows, w = fl.shape[2], fl.shape[3]
    taps = {}
    for ty in (0, 1):
        for tx in (0, 1):
            ly = torch.arange(rows // 4) * 4 + 1 + ty
            lx = torch.arange(w // 4) * 4 + 1 + tx
            f = fl[:, :, ly][:, :, :, lx].float()
            sx = lx.float().reshape(1, 1, -1) + f[:, 0]
            sy = (ly + row0).float().reshape(1, -1, 1) + f[:, 1]
            acc = W._warp_acc(full, sx, sy, u8=u8)
            taps[ty, tx] = q(acc * W.INV255 if u8 else acc, dt)
    half = lambda a, b: q(q(a * 0.5, dt) + q(b * 0.5, dt), dt)  # noqa: E731
    col = [half(taps[0, tx], taps[1, tx]) for tx in (0, 1)]
    return half(col[0], col[1]).to(dt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row0,rows,w", [(0, 8, 13), (12, 9, 13),
                                         (24, 12, 20)])
def test_in_register_positions_equal_the_positions_tensor(dtype, row0, rows,
                                                          w):
    _, flow = inputs(row0 + w, 2, 1, 36, w, dtype)
    fl = flow[:, :, row0:row0 + rows].contiguous()
    sx, sy = kernel_positions(fl, row0)
    gx, gy = W._grid_positions(fl, row0)
    assert torch.equal(sx, gx) and torch.equal(sy, gy)
    if rows % 4 == 0 and w % 4 == 0:
        pos = W.ds4_positions(fl, row0)
        taps = torch.arange(rows // 2) // 2 * 4 + 1 + torch.arange(
            rows // 2) % 2
        cols = torch.arange(w // 2) // 2 * 4 + 1 + torch.arange(w // 2) % 2
        assert torch.equal(pos[:, 0], sx[:, taps][:, :, cols])
        assert torch.equal(pos[:, 1], sy[:, taps][:, :, cols])


@pytest.mark.parametrize("u8", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row0,rows", [(0, 12), (12, 8), (24, 12)])
def test_ds4_averaging_order_equals_half_sum2(dtype, u8, row0, rows):
    c = 3 if u8 else 5
    full, flow = inputs(7 * row0 + c, 2, c, 36, 20, dtype)
    fl = flow[:, :, row0:row0 + rows].contiguous()
    got = kernel_ds4(full, fl, row0, u8)
    want = W.warp_spatial(full, fl, row0, u8=u8, ds4=True)
    assert want.shape == (2, c, rows // 4, 5)
    assert torch.equal(got, want)
    # the shard's rows of the unsharded fused warp (row0 a multiple of 4)
    whole = W.warp_spatial(full, flow, 0, u8=u8, ds4=True)
    assert torch.equal(want, whole[:, :, row0 // 4:(row0 + rows) // 4])


@pytest.mark.parametrize("u8", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row0,rows,w", [(0, 7, 13), (11, 9, 13),
                                         (29, 7, 20)])
def test_shard_rows_equal_the_unsharded_warp(dtype, u8, row0, rows, w):
    c = 3 if u8 else 4
    full, flow = inputs(row0 * w + c, 2, c, 36, w, dtype)
    fl = flow[:, :, row0:row0 + rows].contiguous()
    sx, sy = kernel_positions(fl, row0)
    acc = W._warp_acc(full, sx, sy, u8=u8)
    mirror = (acc * W.INV255 if u8 else acc).to(dtype)
    got = W.warp_spatial(full, fl, row0, u8=u8)
    assert torch.equal(got, mirror)
    whole = (W.warp_u8_ref if u8 else W.warp_feat_ref)(full, flow)
    assert torch.equal(got, whole[:, :, row0:row0 + rows])
