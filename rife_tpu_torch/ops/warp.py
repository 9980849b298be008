"""The warps of the ported paths: CUDA kernel wrappers, plain PyTorch twins
and launch counters.

Each function computes what a ``rife_tpu/ops/warp_pallas.py`` kernel
computes, from the math (the kernels themselves live in
``rife_tpu_torch/csrc/warp.cu``):

* ``warp_pair``      <- ``_warp_kernel_u8_sheared_flow_pair`` (K5,
  ``warp_pallas_pair`` with a raw flow; ``rife.WarpPair``)
* ``warp_render``    <- ``_warp_kernel_u8_sheared_flow_render`` (K6,
  ``warp_pallas_pair(blend=True)``; ``rife.RenderBlend``)
* ``warp_ds4_pair``  <- ``_warp_kernel_u8_slab_tall_flow_pair`` with
  ``abs_pos=True`` plus the two ``_downsample_axis`` passes of
  ``jax_ops._op_warp_ds4_pair`` (K7; K8 computes the same function;
  ``rife.WarpDs4Pair``)
* ``warp_feat``      <- ``_warp_pallas_impl`` (K1, f32) and
  ``_warp_pallas_packed_impl`` (K2, bf16: ``_warp_kernel_packed``,
  ``_packed_mc``, ``_packed_mct``): one warp of a float image of any C
  (the v2 contextnet's feature maps), raw flow or absolute positions
* ``warp_u8``        <- ``_warp_pallas_u8_impl_any`` (K4): one u8-origin
  warp (a ``rife.Warp`` of a frame copy that no sibling pairs with, as in
  the v2 fusionnet); the same kernel as ``warp_feat`` in its u8 mode
* ``warp_ds2``       <- ``_warp_pallas_u8_ds2_impl`` ->
  ``_warp_kernel_u8_slab_ds2`` (K3): the u8-origin warp of a frame copy
  fused with the exact half-pixel 1/2 downsample (``rife.WarpDs2``)
* ``warp_spatial``   <- ``warp_pallas_spatial`` (S, the height-sharded
  warp): one shard's output rows sampled from the whole (gathered) source
  at global positions that the kernel computes from the shard's raw flow
  rows and their first row (no positions tensor), u8 or float mode,
  optionally at the 1/4 taps with the two 0.5/0.5 passes

The shared u8-origin warp, per output pixel and channel:

* source sample ``u = round(clip(v, 0, 1) * 255)`` (the warped images are
  Split copies of the u8 frames, so this is exact);
* position ``sx = f32(x) + f32(flow_x)``, likewise ``sy``;
* corners ``x0 = clip(floor(sx), 0, W-1)``, ``x1 = min(x0+1, W-1)``,
  fractions ``a = clip(sx - x0, 0, 1)`` (likewise y, b);
* ``acc = (u00*w00 + u01*w01) + (u10*w10 + u11*w11)`` in f32 with
  ``w00=(1-a)(1-b)``, ``w01=a(1-b)``, ``w10=(1-a)b``, ``w11=ab``;
* output ``(acc * f32(1/255))`` cast to the storage dtype.

The float warp (K1/K2) takes the image values ``v`` themselves, the same
corners and weights, and sums in the order the Pallas kernels do where the
four corners fall in one 128-lane tile: ``((v00*w00 + v01*w01) + v10*w10)
+ v11*w11`` in f32, then one cast to the storage dtype.  (Where x0 and x1
straddle a lane tile, or the corners clamp together, the Pallas kernels
group the terms otherwise: ~1 ulp of f32.)

Numeric trap: on the CPU the JAX package never runs this Pallas form
(``use_pallas_warp`` is off there); it runs ``jax_ops.warp_at``, which lerps
``v/255`` values with UNCLAMPED fractions in the storage dtype.  The two agree
algebraically and round differently, so a test states which one it holds the
port to: the twins below follow the Pallas form.

Layout: NCHW.  Images (B,3,H,W) (any C for ``warp_feat``) and flows
(B,2,H,W) in one float dtype (f32 or bf16); absolute positions are (B,2,Ho,Wo)
float32 ``(sx, sy)``; ``warp_render`` takes the mask as (B,H,W) and writes
(B,H,3,W) planes for ``frame.postprocess_planar``.

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches the kernel or
raises; a meta tensor takes the kernel's branch and launches nothing
(``ops/launch.py``).  ``LAUNCHES`` counts kernel launches per wrapper.

The kernels but ``warp_ds4_pair``, ``warp_ds2`` and ``warp_spatial`` take
their tiles (and ``warp_feat`` its channel groups) from the module
constants below at each call; tests/test_torch_warp_tiled.py mirrors their
addressing on the CPU with the same values, and the card tests run them at
these and at other tiles.
"""

from __future__ import annotations

import torch

from . import launch as L

INV255 = 1.0 / 255.0  # used as f32(1/255), as the Pallas kernels do

# K4/K5 (u8 modes) and K6: a block owns TILE_W x TILE_H output pixels, two
# adjacent x a thread; K1/K2 (float mode): FEAT_TILE_W x FEAT_TILE_H, one a
# thread; K7 and K3 keep fixed blocks of 32 x 8 1/4-resolution and 32 x 4
# 1/2-resolution outputs, one a thread (csrc/warp.cu kBx, kBy, kDs2Bx,
# kDs2By).  A block is whole warps of at most 256 threads.  Float mode: a
# tile's C channels split into the fewest groups, a power of two of them,
# that bring the output pixels times groups to FEAT_THREADS, each of at
# least FEAT_MIN_GROUP channels (feat_group).
TILE_W, TILE_H = 64, 8
FEAT_TILE_W, FEAT_TILE_H = 16, 16
FEAT_THREADS = 2_000_000
FEAT_MIN_GROUP = 8

LAUNCHES = {"warp_pair": 0, "warp_render": 0, "warp_ds4_pair": 0,
            "warp_feat": 0, "warp_u8": 0, "warp_ds2": 0, "warp_spatial": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def _warp_acc(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
              u8: bool = True):
    """f32 bilinear sum of ``img`` (B,C,H,W) at absolute positions
    (B,Ho,Wo) -> (B,C,Ho,Wo) f32.  ``u8``: of the u8 values of the image,
    not yet scaled; otherwise of the values themselves, in the float
    warp's order."""
    b, c, h, w = img.shape
    ho, wo = sx.shape[1], sx.shape[2]
    v = img.float()
    if u8:
        v = torch.round(v.clamp(0.0, 1.0) * 255.0)
    v = v.reshape(b, c, h * w)
    x0 = torch.floor(sx).to(torch.int32).clamp(0, w - 1)
    y0 = torch.floor(sy).to(torch.int32).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    a = (sx - x0.float()).clamp(0.0, 1.0).unsqueeze(1)
    bb = (sy - y0.float()).clamp(0.0, 1.0).unsqueeze(1)

    def g(yy, xx):
        idx = (yy.long() * w + xx.long()).reshape(b, 1, ho * wo)
        return torch.gather(v, 2, idx.expand(b, c, ho * wo)).reshape(
            b, c, ho, wo)

    w00 = (1.0 - a) * (1.0 - bb)
    w01 = a * (1.0 - bb)
    w10 = (1.0 - a) * bb
    w11 = a * bb
    if u8:
        return (g(y0, x0) * w00 + g(y0, x1) * w01) + (
            g(y1, x0) * w10 + g(y1, x1) * w11)
    acc = g(y0, x0) * w00
    acc = acc + g(y0, x1) * w01
    acc = acc + g(y1, x0) * w10
    return acc + g(y1, x1) * w11


def _grid_positions(flow: torch.Tensor, row0: int = 0):
    """Raw flow (B,2,H,W) -> absolute f32 positions (sx, sy); ``row0`` is
    the global row of the flow's first row."""
    h, w = flow.shape[2], flow.shape[3]
    gx = torch.arange(w, device=flow.device, dtype=torch.float32)
    gy = torch.arange(row0, row0 + h, device=flow.device,
                      dtype=torch.float32)
    sx = gx.reshape(1, 1, w) + flow[:, 0].float()
    sy = gy.reshape(1, h, 1) + flow[:, 1].float()
    return sx, sy


def _scaled(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (acc * INV255).to(dtype)


def _positions(flow: torch.Tensor, abs_pos: bool):
    if abs_pos:
        return flow[:, 0].float(), flow[:, 1].float()
    return _grid_positions(flow)


def warp_u8_ref(img: torch.Tensor, flow: torch.Tensor,
                abs_pos: bool = False) -> torch.Tensor:
    """Twin of K4: one u8-origin warp by a raw flow (B,2,H,W), or at
    absolute positions (B,2,Ho,Wo); (B,C,H,W) -> (B,C,Ho,Wo)."""
    return _scaled(_warp_acc(img, *_positions(flow, abs_pos)), img.dtype)


def warp_feat_ref(img: torch.Tensor, flow: torch.Tensor,
                  abs_pos: bool = False) -> torch.Tensor:
    """Twin of K1/K2: one warp of a float image of any C, by a raw flow or
    at absolute positions, summed in f32 and cast once."""
    return _warp_acc(img, *_positions(flow, abs_pos), u8=False).to(img.dtype)


def warp_pair_ref(img_a, flow_a, img_b, flow_b):
    """Twin of K5: two independent u8-origin warps."""
    return warp_u8_ref(img_a, flow_a), warp_u8_ref(img_b, flow_b)


def warp_render_ref(img_m, flow_m, img_i, flow_i, mask):
    """Twin of K6: ``wm*m + wi*(1-m)`` in the storage dtype, each warp cast
    to it first; mask (B,H,W) -> (B,H,3,W) planes."""
    wm = warp_u8_ref(img_m, flow_m)
    wi = warp_u8_ref(img_i, flow_i)
    m = mask.unsqueeze(1).to(wm.dtype)
    out = wm * m + wi * (1 - m)
    return out.permute(0, 2, 1, 3).contiguous()


def _ds4_taps(n: int, device) -> torch.Tensor:
    """Rows/cols {4i+1, 4i+2} interleaved: the only ones a half-pixel 1/4
    downsample reads."""
    i = torch.arange(n // 2, device=device)
    return (i // 2) * 4 + 1 + (i % 2)


def _half_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """0.5*even + 0.5*odd along ``dim`` in the storage dtype (0.5 is exact
    in every float dtype: as a Python scalar it needs no copy to the
    device)."""
    half = 0.5
    ev = x.narrow(dim, 0, x.shape[dim] // 2 * 2)
    shape = list(ev.shape)
    shape[dim:dim + 1] = [shape[dim] // 2, 2]
    pairs = ev.reshape(shape)
    return pairs.select(dim + 1, 0) * half + pairs.select(dim + 1, 1) * half


def ds4_positions(flow: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """Raw flow (B,2,H,W) -> absolute f32 positions (B,2,H/2,W/2) of the
    taps a 1/4 half-pixel downsample reads: tap + flow(tap)
    (``jax_ops._ds4_abs_positions``).  ``row0``: the global row of the
    flow's first row (a multiple of 4), for one shard's rows."""
    h, w = flow.shape[2], flow.shape[3]
    ry, rx = _ds4_taps(h, flow.device), _ds4_taps(w, flow.device)
    fc = flow.index_select(2, ry).index_select(3, rx).float()
    sx = rx.float().reshape(1, 1, -1) + fc[:, 0]
    sy = (ry + row0).float().reshape(1, -1, 1) + fc[:, 1]
    return torch.stack([sx, sy], dim=1)


def half_sum2(y: torch.Tensor) -> torch.Tensor:
    """The two 0.5/0.5 passes (rows, then columns) that finish a warp on
    the tap grid into the 1/4-resolution result."""
    return _half_sum(_half_sum(y, 2), 3)


def warp_ds4_u8_ref(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp then 1/4 half-pixel downsample, evaluated on the tap grid:
    (B,C,H,W) -> (B,C,H/4,W/4)."""
    return half_sum2(warp_u8_ref(img, ds4_positions(flow), abs_pos=True))


def warp_ds4_pair_ref(img_a, flow_a, img_b, flow_b):
    """Twin of K7: both fused warp + 1/4 downsample taps of a block entry."""
    return warp_ds4_u8_ref(img_a, flow_a), warp_ds4_u8_ref(img_b, flow_b)


def warp_spatial_ref(full, flow, row0: int, *, u8: bool, ds4: bool = False):
    """Twin of S: the shard's absolute positions (``_grid_positions`` or,
    ``ds4``, ``ds4_positions`` with ``row0``), the single-warp twin at them
    over the whole source, and with ``ds4`` the two 0.5/0.5 passes."""
    if ds4:
        pos = ds4_positions(flow, row0)
    else:
        pos = torch.stack(_grid_positions(flow, row0), dim=1)
    out = (warp_u8_ref if u8 else warp_feat_ref)(full, pos, abs_pos=True)
    return half_sum2(out) if ds4 else out


def warp_ds2_ref(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Twin of K3: the u8-origin warp of every full-resolution pixel, cast
    to the storage dtype, then the exact half-pixel 1/2 downsample (rows,
    then columns, 0.5/0.5 in that dtype): (B,C,H,W) -> (B,C,H/2,W/2)."""
    return half_sum2(warp_u8_ref(img, flow))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(imgs, flows, mask=None):
    """Validate the kernel's operands; returns (B, H, W, dtype code)."""
    ref = imgs[0]
    if ref.device.type not in ("cuda", "meta"):
        raise ValueError(f"warp kernels take CUDA or CPU tensors, got "
                         f"{ref.device}")
    if ref.dtype not in _DTYPE_CODE:
        raise TypeError(f"warp kernels take float32 or bfloat16, got "
                        f"{ref.dtype}")
    if ref.dim() != 4 or ref.shape[1] != 3:
        raise ValueError(f"images must be (B,3,H,W), got {tuple(ref.shape)}")
    b, _, h, w = ref.shape
    named = [("image", t, (b, 3, h, w)) for t in imgs]
    named += [("flow", t, (b, 2, h, w)) for t in flows]
    if mask is not None:
        named.append(("mask", mask, (b, h, w)))
    for what, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{what} on {t.device}/{t.dtype}, expected "
                             f"{ref.device}/{ref.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    return b, h, w, _DTYPE_CODE[ref.dtype]


def _launch(fn_name: str, tensors, ints, device: torch.device) -> None:
    L.launch(fn_name, device, *[L.ptr(t) for t in tensors], *ints)


def warp_pair(img_a, flow_a, img_b, flow_b):
    """K5 on CUDA, its twin on the CPU: two u8-origin warps by raw flows."""
    if img_a.device.type == "cpu":
        return warp_pair_ref(img_a, flow_a, img_b, flow_b)
    b, h, w, code = _check([img_a, img_b], [flow_a, flow_b])
    out_a = torch.empty_like(img_a)
    out_b = torch.empty_like(img_b)
    _launch("rife_warp_pair", [img_a, flow_a, img_b, flow_b, out_a, out_b],
            (b, h, w, code, TILE_W, TILE_H), img_a.device)
    L.count(LAUNCHES, "warp_pair")
    return out_a, out_b


def warp_render(img_m, flow_m, img_i, flow_i, mask):
    """K6 on CUDA, its twin on the CPU: both render warps and the mask blend;
    mask (B,H,W) -> (B,H,3,W) planes."""
    if img_m.device.type == "cpu":
        return warp_render_ref(img_m, flow_m, img_i, flow_i, mask)
    b, h, w, code = _check([img_m, img_i], [flow_m, flow_i], mask)
    out = img_m.new_empty((b, h, 3, w))
    _launch("rife_warp_render", [img_m, flow_m, img_i, flow_i, mask, out],
            (b, h, w, code, TILE_W, TILE_H), img_m.device)
    L.count(LAUNCHES, "warp_render")
    return out


def warp_ds4_pair(img_a, flow_a, img_b, flow_b):
    """K7 on CUDA, its twin on the CPU: both warp + 1/4 downsample taps,
    (B,3,H,W) -> (B,3,H/4,W/4) each."""
    if img_a.device.type == "cpu":
        return warp_ds4_pair_ref(img_a, flow_a, img_b, flow_b)
    b, h, w, code = _check([img_a, img_b], [flow_a, flow_b])
    if h % 4 or w % 4:
        raise ValueError(f"warp_ds4_pair needs H, W divisible by 4, got "
                         f"{h}x{w}")
    shape = (b, 3, h // 4, w // 4)
    out_a = img_a.new_empty(shape)
    out_b = img_b.new_empty(shape)
    _launch("rife_warp_ds4_pair", [img_a, flow_a, img_b, flow_b, out_a, out_b],
            (b, h, w, code), img_a.device)
    L.count(LAUNCHES, "warp_ds4_pair")
    return out_a, out_b


def warp_ds2(img, flow):
    """K3 on CUDA, its twin on the CPU: the u8-origin warp of a (B,3,H,W)
    frame copy fused with the 1/2 downsample -> (B,3,H/2,W/2); H, W even."""
    if img.device.type == "cpu":
        return warp_ds2_ref(img, flow)
    b, h, w, code = _check([img], [flow])
    if h % 2 or w % 2:
        raise ValueError(f"warp_ds2 needs even H and W, got {h}x{w}")
    out = img.new_empty((b, 3, h // 2, w // 2))
    _launch("rife_warp_ds2", [img, flow, out], (b, h, w, code), img.device)
    L.count(LAUNCHES, "warp_ds2")
    return out


def _check_single(img, pos, abs_pos: bool):
    """Validate the single-warp kernel's operands; returns (B,C,H,W,Ho,Wo,
    dtype code)."""
    if img.device.type not in ("cuda", "meta"):
        raise ValueError(f"warp kernels take CUDA or CPU tensors, got "
                         f"{img.device}")
    if img.dtype not in _DTYPE_CODE:
        raise TypeError(f"warp kernels take float32 or bfloat16, got "
                        f"{img.dtype}")
    if img.dim() != 4:
        raise ValueError(f"image must be (B,C,H,W), got {tuple(img.shape)}")
    b, c, h, w = img.shape
    want_dtype = torch.float32 if abs_pos else img.dtype
    if pos.dim() != 4 or pos.shape[0] != b or pos.shape[1] != 2 or (
            not abs_pos and tuple(pos.shape[2:]) != (h, w)):
        what = "positions (B,2,Ho,Wo)" if abs_pos else f"flow {(b, 2, h, w)}"
        raise ValueError(f"{what} expected, got {tuple(pos.shape)}")
    if pos.device != img.device or pos.dtype != want_dtype:
        raise ValueError(f"flow/positions on {pos.device}/{pos.dtype}, "
                         f"expected {img.device}/{want_dtype}")
    if not (img.is_contiguous() and pos.is_contiguous()):
        raise ValueError("image and flow/positions must be contiguous")
    return b, c, h, w, pos.shape[2], pos.shape[3], _DTYPE_CODE[img.dtype]


def feat_group(b: int, c: int, ho: int, wo: int) -> int:
    """Channels a block of the float mode takes: all C where the B x Ho x Wo
    output pixels reach FEAT_THREADS, else C split into the fewest groups, a
    power of two of them, that bring the pixels times groups to it, while a
    group keeps at least FEAT_MIN_GROUP channels."""
    groups = 1
    while (groups * b * ho * wo < FEAT_THREADS
           and c // (2 * groups) >= FEAT_MIN_GROUP):
        groups *= 2
    return -(-c // groups)


def _warp_single(name: str, img, pos, abs_pos: bool, u8: bool):
    b, c, h, w, ho, wo, code = _check_single(img, pos, abs_pos)
    if u8 and c != 3:
        raise ValueError(f"the u8-origin warp takes 3 channels, got {c}")
    out = img.new_empty((b, c, ho, wo))
    tile = (TILE_W, TILE_H) if u8 else (FEAT_TILE_W, FEAT_TILE_H)
    group = 3 if u8 else feat_group(b, c, ho, wo)
    _launch("rife_warp_single", [img, pos, out],
            (b, c, h, w, ho, wo, int(abs_pos), int(u8), code, *tile, group),
            img.device)
    L.count(LAUNCHES, name)
    return out


def warp_feat(img, flow, abs_pos: bool = False):
    """K1/K2 on CUDA, the twin on the CPU: a float image (B,C,H,W) warped by
    a raw flow (B,2,H,W) in its dtype, or sampled at float32 absolute
    positions (B,2,Ho,Wo)."""
    if img.device.type == "cpu":
        return warp_feat_ref(img, flow, abs_pos)
    return _warp_single("warp_feat", img, flow, abs_pos, u8=False)


def warp_u8(img, flow, abs_pos: bool = False):
    """K4 on CUDA, the twin on the CPU: one u8-origin warp of a
    (B,3,H,W) frame copy, by a raw flow or at absolute positions."""
    if img.device.type == "cpu":
        return warp_u8_ref(img, flow, abs_pos)
    return _warp_single("warp_u8", img, flow, abs_pos, u8=True)


def warp_spatial(full, flow, row0: int, *, u8: bool, ds4: bool = False):
    """S on CUDA, its twin on the CPU (``warp_pallas_spatial``): ``full`` is
    the whole source image (B,C,H,W) on the shard's device, ``flow`` the
    shard's rows [row0, row0 + h) of the raw flow (B,2,h,W) in its dtype on
    the image's grid.  Output row y samples at the f32 global position (x +
    flow_x, (row0 + y) + flow_y), so its rows equal those of the unsharded
    warp bit for bit (``u8``: the u8-origin sampling of a frame copy, C=3;
    else the float warp).  ``ds4``: the fused warp + 1/4 downsample, as
    under sharding in ``rife_tpu``: the warps at the taps' positions, then
    the two 0.5/0.5 passes (row0 a multiple of 4) -> (B,C,h/4,W/4)."""
    if full.device.type == "cpu":
        return warp_spatial_ref(full, flow, row0, u8=u8, ds4=ds4)
    if full.dtype not in _DTYPE_CODE:
        raise TypeError(f"warp kernels take float32 or bfloat16, got "
                        f"{full.dtype}")
    if full.dim() != 4 or flow.dim() != 4:
        raise ValueError(f"image (B,C,H,W) and flow (B,2,h,W) expected, got "
                         f"{tuple(full.shape)} and {tuple(flow.shape)}")
    b, c, h, w = full.shape
    rows = flow.shape[2]
    if (flow.shape[0], flow.shape[1], flow.shape[3]) != (b, 2, w):
        raise ValueError(f"flow {tuple(flow.shape)} does not match image "
                         f"{tuple(full.shape)}")
    if flow.device != full.device or flow.dtype != full.dtype:
        raise ValueError(f"flow on {flow.device}/{flow.dtype}, expected "
                         f"{full.device}/{full.dtype}")
    if not (full.is_contiguous() and flow.is_contiguous()):
        raise ValueError("image and flow must be contiguous")
    if not (rows >= 1 and 0 <= row0 and row0 + rows <= h):
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside the "
                         f"source's {h}")
    if u8 and c != 3:
        raise ValueError(f"the u8-origin warp takes 3 channels, got {c}")
    if ds4 and (rows % 4 or w % 4):
        raise ValueError(f"the 1/4 warp needs rows and width divisible by 4, "
                         f"got {rows}x{w}")
    ho, wo = (rows // 4, w // 4) if ds4 else (rows, w)
    out = full.new_empty((b, c, ho, wo))
    group = 3 if u8 else feat_group(b, c, ho, wo)
    _launch("rife_warp_spatial", [full, flow, out],
            (b, c, h, w, rows, row0, int(u8), int(ds4),
             _DTYPE_CODE[full.dtype], group), full.device)
    L.count(LAUNCHES, "warp_spatial")
    return out
