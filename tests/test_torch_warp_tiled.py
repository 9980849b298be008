"""A CPU mirror of how the K1/K2/K4/K5 kernels of csrc/warp.cu address their
data, held bit for bit to the plain twins (``warp_u8_ref``,
``warp_pair_ref``, ``warp_feat_ref``) at mini sizes, in f32 and bf16.

The mirror walks the launch as the kernels do, reading the tiles from
``ops/warp.py``: blocks of TILE_W x TILE_H (u8 modes, two pixels a thread)
or FEAT_TILE_W x FEAT_TILE_H (float mode, one pixel a thread, also over
channel groups of ``feat_group`` channels) output pixels, in whole warps of
at most 256 threads; each pixel gathers its four corners from the image and
sums them in the kernels' order.  Every output is written once.  The kernels
themselves against the twins: tests/test_torch_cuda.py, on the card."""

import numpy as np
import pytest
import torch

from rife_tpu_torch.ops import warp as W


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Mini-size tensors gain nothing from torch's thread pool, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def taps(sx, sy, h, w):
    """Corner coordinates and bilinear weights, as the kernels' ``taps``."""
    x0 = torch.floor(sx).to(torch.int32).clamp(0, w - 1).long()
    y0 = torch.floor(sy).to(torch.int32).clamp(0, h - 1).long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    a = (sx - x0.float()).clamp(0.0, 1.0)
    b = (sy - y0.float()).clamp(0.0, 1.0)
    return (x0, x1, y0, y1), ((1.0 - a) * (1.0 - b), a * (1.0 - b),
                              (1.0 - a) * b, a * b)


def u8_sum(v, wt):
    return (v[0] * wt[0] + v[1] * wt[1]) + (v[2] * wt[2] + v[3] * wt[3])


def feat_sum(v, wt):
    acc = v[0] * wt[0]
    acc = acc + v[1] * wt[1]
    acc = acc + v[2] * wt[2]
    return acc + v[3] * wt[3]


def mirror(img, pos, abs_pos: bool, u8: bool):
    """The launch of ``warp_u8`` (u8) or ``warp_feat`` as the kernels address
    it, with the constants ops/warp.py holds now."""
    b, c, h, w = img.shape
    sx_all, sy_all = W._positions(pos, abs_pos)
    ho, wo = sx_all.shape[1:]
    if u8:
        tw, th, px = W.TILE_W, W.TILE_H, 2
    else:
        tw, th, px = W.FEAT_TILE_W, W.FEAT_TILE_H, 1
    # what the kernels accept: whole warps of at most 256 threads
    assert tw % px == 0 and (tw // px * th) % 32 == 0 and tw // px * th <= 256
    group = 3 if u8 else W.feat_group(b, c, ho, wo)
    ngroups = -(-c // group)
    vals = img.float()
    if u8:
        vals = torch.round(vals.clamp(0.0, 1.0) * 255.0)
    acc = torch.full((b, c, ho, wo), float("nan"))
    for bi in range(b):
        for y0 in range(0, ho, th):
            for x0 in range(0, wo, tw):
                sl = (slice(y0, min(ho, y0 + th)), slice(x0, min(wo, x0 + tw)))
                (xa, xb, ya, yb), wt = taps(sx_all[bi][sl].reshape(-1),
                                            sy_all[bi][sl].reshape(-1), h, w)
                for g in range(ngroups):
                    chans = range(g * group, min(c, (g + 1) * group))
                    flat = vals[bi, chans.start:chans.stop].reshape(
                        len(chans), -1)
                    res = (u8_sum if u8 else feat_sum)(
                        [flat[:, yy * w + xx] for yy, xx in
                         ((ya, xa), (ya, xb), (yb, xa), (yb, xb))], wt)
                    block = acc[bi, chans.start:chans.stop][(slice(None),) + sl]
                    assert torch.isnan(block).all()  # each output written once
                    block.copy_(res.reshape(block.shape))
    assert not torch.isnan(acc).any()
    return W._scaled(acc, img.dtype) if u8 else acc.to(img.dtype)


def flows(kind, b, h, w, seed):
    """(B,2,H,W) f32: smooth, spatially white, or smooth and leaving the
    frame (top rows down, left columns further left)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 2, h), np.linspace(0, 3, w),
                         indexing="ij")
    smooth = np.stack([np.sin(xx + yy) * 2.5, np.cos(xx - yy) * 1.5])[None]
    f = np.repeat(smooth, b, 0) + rng.normal(size=(b, 2, h, w)) * 0.3
    if kind == "iid":
        f = rng.normal(size=(b, 2, h, w)) * 6.0
    elif kind == "out":
        f[:, 1, : h // 4] += 30.0
        f[:, 0, :, : w // 5] -= 40.0
    return torch.from_numpy(f.astype(np.float32))


SHAPES = [(2, 19, 48), (1, 13, 37), (1, 33, 64)]  # ragged H; ragged H and W
# ops/warp.py's tiles; one that splits mini sizes; a flat one wider than them
TILES = [None, (16, 4), (128, 2)]


@pytest.fixture
def consts(monkeypatch):
    def set_(tile, **extra):
        if tile is not None:
            for name, value in zip(("TILE_W", "TILE_H", "FEAT_TILE_W",
                                    "FEAT_TILE_H"), tile * 2):
                monkeypatch.setattr(W, name, value)
        for k, v in extra.items():
            monkeypatch.setattr(W, k, v)
    return set_


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["smooth", "iid", "out"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile", TILES)
def test_u8_mirror_matches_twins(consts, dtype, kind, shape, tile):
    """K4 and K5: each image of a pair is one u8 launch over its own tiles."""
    consts(tile)
    b, h, w = shape
    rng = np.random.default_rng(1)
    imgs = [torch.from_numpy(rng.integers(0, 256, (b, 3, h, w)) / 255.0)
            .float().to(dtype) for _ in range(2)]
    fl = [flows(kind, b, h, w, s).to(dtype) for s in (2, 3)]
    pair = W.warp_pair_ref(imgs[0], fl[0], imgs[1], fl[1])
    for img, f, want in zip(imgs, fl, pair):
        assert torch.equal(W.warp_u8_ref(img, f), want)
        assert torch.equal(mirror(img, f, False, u8=True), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", TILES)
def test_u8_mirror_abs_pos_matches_twin(consts, dtype, tile):
    """K4 at absolute positions (the tap grid of a 1/4 downsample, Wo =
    W/2)."""
    consts(tile)
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.integers(0, 256, (2, 3, 24, 64)) / 255.0) \
        .float().to(dtype)
    pos = W.ds4_positions(flows("out", 2, 24, 64, 5).to(dtype))
    assert torch.equal(mirror(img, pos, True, u8=True),
                       W.warp_u8_ref(img, pos, abs_pos=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 7, 32])
@pytest.mark.parametrize("kind", ["smooth", "iid", "out"])
@pytest.mark.parametrize("threads", [None, 0])
def test_feat_mirror_matches_twin(consts, dtype, c, kind, threads):
    """K1/K2 over channel groups (``feat_group`` at ops/warp.py's constants:
    groups of FEAT_MIN_GROUP channels at mini sizes where C allows;
    FEAT_THREADS 0: one group)."""
    consts((16, 4), **({} if threads is None else {"FEAT_THREADS": threads}))
    b, h, w = 2, 19, 48
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.normal(size=(b, c, h, w)) * 2).float().to(dtype)
    f = flows(kind, b, h, w, 7).to(dtype)
    assert torch.equal(mirror(img, f, False, u8=False),
                       W.warp_feat_ref(img, f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 13, 37), (2, 20, 64)])
def test_feat_mirror_abs_pos_and_module_tile(dtype, shape):
    """The float mode at absolute positions on ops/warp.py's own tile, on a
    ragged and an aligned width."""
    b, h, w = shape
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.normal(size=(b, 5, h, w))).float().to(dtype)
    pos = W.ds4_positions(flows("smooth", b, h, w, 9).to(dtype))
    assert torch.equal(mirror(img, pos, True, u8=False),
                       W.warp_feat_ref(img, pos, abs_pos=True))


def test_feat_group_fills_the_launch(monkeypatch):
    """One group where the pixels alone reach FEAT_THREADS; the deep
    contextnet levels of a 1080p B=8 step split into groups, none narrower
    than FEAT_MIN_GROUP channels (unless C is)."""
    monkeypatch.setattr(W, "FEAT_THREADS", 2_000_000)
    monkeypatch.setattr(W, "FEAT_MIN_GROUP", 8)
    assert W.feat_group(16, 32, 272, 480) == 32
    assert W.feat_group(16, 64, 136, 240) == 16
    assert W.feat_group(16, 128, 68, 120) == 8
    assert W.feat_group(16, 256, 34, 60) == 8
    assert W.feat_group(1, 7, 3, 3) == 7
    assert W.feat_group(1, 32, 3, 3) == 8
    assert W.feat_group(1, 5, 1100, 1000) == 5
    monkeypatch.setattr(W, "FEAT_MIN_GROUP", 1)
    assert W.feat_group(1, 7, 3, 3) == 2  # 4 groups: 8 would leave one empty
    monkeypatch.setattr(W, "FEAT_THREADS", 0)
    assert W.feat_group(1, 7, 3, 3) == 7


# ---------------------------------------------------------------------------
# K6 (warp_render_kernel) and K7 (warp_ds4_pair_kernel)
# ---------------------------------------------------------------------------

def u8_vals(img):
    b, c, h, w = img.shape
    return torch.round(img.float().clamp(0.0, 1.0) * 255.0).reshape(b, c, h * w)


def gather_u8(vals, sx, sy, h, w):
    """The u8-origin sum at f32 positions (sx, sy) of one image's planes
    (C, H*W) -> (C, N) f32, unscaled; every corner lies in the plane."""
    (xa, xb, ya, yb), wt = taps(sx, sy, h, w)
    idx = [yy * w + xx for yy, xx in ((ya, xa), (ya, xb), (yb, xa), (yb, xb))]
    assert all(int(i.min()) >= 0 and int(i.max()) < h * w for i in idx)
    return u8_sum([vals[:, i] for i in idx], wt)


def render_mirror(img_m, flow_m, img_i, flow_i, mask):
    """K6's launch as the kernel addresses it: TILE_W x TILE_H pixels a
    block, two adjacent x a thread (a second pixel past an odd
    right edge reads flow 0, gathers at clamped corners and is not stored);
    warp m's planes cast to the storage dtype first, then warp i's and the
    blend -> (B,H,3,W)."""
    b, _, h, w = img_m.shape
    tw, th, dt = W.TILE_W, W.TILE_H, img_m.dtype
    assert tw % 2 == 0 and (tw // 2 * th) % 32 == 0 and tw // 2 * th <= 256
    vm, vi = u8_vals(img_m), u8_vals(img_i)
    out = torch.full((b, h, 3, w), float("nan"))
    for bi in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                ys = torch.arange(y0, min(h, y0 + th))
                # the block's threads cover x0 .. x0+tw-1, two pixels each,
                # up to the pair that holds the last column
                xs = torch.arange(x0, min(x0 + tw, w + w % 2))
                yy, xx = torch.meshgrid(ys, xs, indexing="ij")
                yy, xx = yy.reshape(-1), xx.reshape(-1)
                live = xx < w
                xc = xx.clamp(max=w - 1)

                def warp(vals, flow):
                    fx = torch.where(live, flow[bi, 0, yy, xc].float(), 0.0)
                    fy = torch.where(live, flow[bi, 1, yy, xc].float(), 0.0)
                    acc = gather_u8(vals[bi], xx.float() + fx, yy.float() + fy,
                                    h, w)
                    return W._scaled(acc, dt)

                st = warp(vm, flow_m)
                m = torch.where(live, mask[bi, yy, xc], 0.0).to(dt)
                om = 1 - m
                res = st * m + warp(vi, flow_i) * om
                dst = out[bi][yy[live], :, xx[live]]
                assert torch.isnan(dst).all()  # each output written once
                out[bi][yy[live], :, xx[live]] = res[:, live].t().float()
    assert not torch.isnan(out).any()
    return out.to(dt)


def ds4_mirror(img, flow):
    """K7's launch for one image of the pair as the kernel addresses it:
    DS4_BLOCK outputs a block, one a thread; a thread gathers its four
    taps' planes, casts each to the storage dtype, and halves and sums the rows, then the columns, in
    that dtype -> (B,3,H/4,W/4)."""
    b, _, h, w = img.shape
    ho, wo = h // 4, w // 4
    (tw, th), dt = DS4_BLOCK, img.dtype
    half = torch.tensor(0.5, dtype=dt)
    vals = u8_vals(img)
    out = torch.full((b, 3, ho, wo), float("nan"))
    for bi in range(b):
        for i0 in range(0, ho, th):
            for j0 in range(0, wo, tw):
                ii, jj = torch.meshgrid(torch.arange(i0, min(ho, i0 + th)),
                                        torch.arange(j0, min(wo, j0 + tw)),
                                        indexing="ij")
                ii, jj = ii.reshape(-1), jj.reshape(-1)
                taps_ = {}
                for ty in range(2):
                    for tx in range(2):
                        ys, xs = 4 * ii + 1 + ty, 4 * jj + 1 + tx
                        acc = gather_u8(
                            vals[bi], xs.float() + flow[bi, 0][ys, xs].float(),
                            ys.float() + flow[bi, 1][ys, xs].float(), h, w)
                        taps_[ty, tx] = W._scaled(acc, dt)
                col = [taps_[0, tx] * half + taps_[1, tx] * half
                       for tx in range(2)]
                o = col[0] * half + col[1] * half
                dst = out[bi][:, ii, jj]
                assert torch.isnan(dst).all()  # each output written once
                out[bi][:, ii, jj] = o.float()
    assert not torch.isnan(out).any()
    return out.to(dt)


RENDER_SHAPES = [(2, 19, 48), (1, 13, 37), (1, 33, 64)]  # odd W: 37
RENDER_TILES = [None, (16, 4), (128, 2)]
DS4_SHAPES = [(2, 20, 52), (1, 12, 196), (1, 32, 64)]  # W/4 odd: 13, 49
DS4_BLOCK = (32, 8)  # csrc/warp.cu kBx x kBy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["smooth", "iid", "out"])
@pytest.mark.parametrize("shape", RENDER_SHAPES)
@pytest.mark.parametrize("tile", RENDER_TILES)
def test_render_mirror_matches_twin(monkeypatch, dtype, kind, shape, tile):
    """K6 on ops/warp.py's u8 tile and on others, ragged sizes."""
    if tile is not None:
        monkeypatch.setattr(W, "TILE_W", tile[0])
        monkeypatch.setattr(W, "TILE_H", tile[1])
    b, h, w = shape
    rng = np.random.default_rng(10)
    imgs = [torch.from_numpy(rng.integers(0, 256, (b, 3, h, w)) / 255.0)
            .float().to(dtype) for _ in range(2)]
    fl = [flows(kind, b, h, w, s).to(dtype) for s in (11, 12)]
    mask = torch.from_numpy(rng.uniform(0, 1, (b, h, w))).float().to(dtype)
    want = W.warp_render_ref(imgs[0], fl[0], imgs[1], fl[1], mask)
    assert torch.equal(render_mirror(imgs[0], fl[0], imgs[1], fl[1], mask),
                       want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["smooth", "iid", "out"])
@pytest.mark.parametrize("shape", DS4_SHAPES)
def test_ds4_mirror_matches_twin(dtype, kind, shape):
    """K7 on its fixed block, ragged right and bottom edges (W/4 odd, not a
    multiple of the block)."""
    b, h, w = shape
    rng = np.random.default_rng(13)
    imgs = [torch.from_numpy(rng.integers(0, 256, (b, 3, h, w)) / 255.0)
            .float().to(dtype) for _ in range(2)]
    fl = [flows(kind, b, h, w, s).to(dtype) for s in (14, 15)]
    want = W.warp_ds4_pair_ref(imgs[0], fl[0], imgs[1], fl[1])
    for img, f, ref in zip(imgs, fl, want):
        assert torch.equal(ds4_mirror(img, f), ref)
