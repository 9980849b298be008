"""The main path's three warps: CUDA kernel wrappers, plain PyTorch twins and
launch counters.

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

The shared u8-origin warp, per output pixel and channel:

* source sample ``u = round(clip(v, 0, 1) * 255)`` (the warped images are
  Split copies of the u8 frames, so this is exact);
* position ``sx = f32(x) + f32(flow_x)``, likewise ``sy``;
* corners ``x0 = clip(floor(sx), 0, W-1)``, ``x1 = min(x0+1, W-1)``,
  fractions ``a = clip(sx - x0, 0, 1)`` (likewise y, b);
* ``acc = (u00*w00 + u01*w01) + (u10*w10 + u11*w11)`` in f32 with
  ``w00=(1-a)(1-b)``, ``w01=a(1-b)``, ``w10=(1-a)b``, ``w11=ab``;
* output ``(acc * f32(1/255))`` cast to the storage dtype.

Numeric trap: on the CPU the JAX package never runs this Pallas form
(``use_pallas_warp`` is off there); it runs ``jax_ops.warp_at``, which lerps
``v/255`` values with UNCLAMPED fractions in the storage dtype.  The two agree
algebraically and round differently, so a test states which one it holds the
port to: the twins below follow the Pallas form.

Layout: NCHW.  Images (B,3,H,W) and flows (B,2,H,W) in one float dtype
(f32 or bf16); ``warp_render`` takes the mask as (B,H,W) and writes
(B,H,3,W) planes for ``frame.postprocess_planar``.

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from ..native import build

INV255 = 1.0 / 255.0  # used as f32(1/255), as the Pallas kernels do

LAUNCHES = {"warp_pair": 0, "warp_render": 0, "warp_ds4_pair": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def _warp_acc(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    """f32 bilinear sum of the u8 values of ``img`` (B,C,H,W) at absolute
    positions (B,Ho,Wo) -> (B,C,Ho,Wo) f32, the sum not yet scaled."""
    b, c, h, w = img.shape
    ho, wo = sx.shape[1], sx.shape[2]
    u = torch.round(img.float().clamp(0.0, 1.0) * 255.0).reshape(b, c, h * w)
    x0 = torch.floor(sx).to(torch.int32).clamp(0, w - 1)
    y0 = torch.floor(sy).to(torch.int32).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    a = (sx - x0.float()).clamp(0.0, 1.0).unsqueeze(1)
    bb = (sy - y0.float()).clamp(0.0, 1.0).unsqueeze(1)

    def g(yy, xx):
        idx = (yy.long() * w + xx.long()).reshape(b, 1, ho * wo)
        return torch.gather(u, 2, idx.expand(b, c, ho * wo)).reshape(
            b, c, ho, wo)

    w00 = (1.0 - a) * (1.0 - bb)
    w01 = a * (1.0 - bb)
    w10 = (1.0 - a) * bb
    w11 = a * bb
    return (g(y0, x0) * w00 + g(y0, x1) * w01) + (
        g(y1, x0) * w10 + g(y1, x1) * w11)


def _grid_positions(flow: torch.Tensor):
    """Raw flow (B,2,H,W) -> absolute f32 positions (sx, sy)."""
    h, w = flow.shape[2], flow.shape[3]
    gx = torch.arange(w, device=flow.device, dtype=torch.float32)
    gy = torch.arange(h, device=flow.device, dtype=torch.float32)
    sx = gx.reshape(1, 1, w) + flow[:, 0].float()
    sy = gy.reshape(1, h, 1) + flow[:, 1].float()
    return sx, sy


def _scaled(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (acc * INV255).to(dtype)


def warp_u8_ref(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """One u8-origin warp by a raw flow, (B,C,H,W) -> (B,C,H,W)."""
    return _scaled(_warp_acc(img, *_grid_positions(flow)), img.dtype)


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
    """0.5*even + 0.5*odd along ``dim`` in the storage dtype."""
    half = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    ev = x.narrow(dim, 0, x.shape[dim] // 2 * 2)
    shape = list(ev.shape)
    shape[dim:dim + 1] = [shape[dim] // 2, 2]
    pairs = ev.reshape(shape)
    return pairs.select(dim + 1, 0) * half + pairs.select(dim + 1, 1) * half


def warp_ds4_u8_ref(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp then 1/4 half-pixel downsample, evaluated on the tap grid:
    (B,C,H,W) -> (B,C,H/4,W/4)."""
    h, w = img.shape[2], img.shape[3]
    ry, rx = _ds4_taps(h, img.device), _ds4_taps(w, img.device)
    fc = flow.index_select(2, ry).index_select(3, rx).float()
    sx = rx.float().reshape(1, 1, -1) + fc[:, 0]
    sy = ry.float().reshape(1, -1, 1) + fc[:, 1]
    y = _scaled(_warp_acc(img, sx, sy), img.dtype)
    return _half_sum(_half_sum(y, 2), 3)


def warp_ds4_pair_ref(img_a, flow_a, img_b, flow_b):
    """Twin of K7: both fused warp + 1/4 downsample taps of a block entry."""
    return warp_ds4_u8_ref(img_a, flow_a), warp_ds4_u8_ref(img_b, flow_b)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(imgs, flows, mask=None):
    """Validate the kernel's operands; returns (B, H, W, dtype code)."""
    ref = imgs[0]
    if ref.device.type != "cuda":
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


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(fn_name: str, tensors, b: int, h: int, w: int, code: int,
            device: torch.device) -> None:
    lib = build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn_name)(*[_ptr(t) for t in tensors], b, h, w, code,
                               ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} "
                           f"({build.error_string(rc)})")


def warp_pair(img_a, flow_a, img_b, flow_b):
    """K5 on CUDA, its twin on the CPU: two u8-origin warps by raw flows."""
    if img_a.device.type == "cpu":
        return warp_pair_ref(img_a, flow_a, img_b, flow_b)
    b, h, w, code = _check([img_a, img_b], [flow_a, flow_b])
    out_a = torch.empty_like(img_a)
    out_b = torch.empty_like(img_b)
    _launch("rife_warp_pair", [img_a, flow_a, img_b, flow_b, out_a, out_b],
            b, h, w, code, img_a.device)
    LAUNCHES["warp_pair"] += 1
    return out_a, out_b


def warp_render(img_m, flow_m, img_i, flow_i, mask):
    """K6 on CUDA, its twin on the CPU: both render warps and the mask blend;
    mask (B,H,W) -> (B,H,3,W) planes."""
    if img_m.device.type == "cpu":
        return warp_render_ref(img_m, flow_m, img_i, flow_i, mask)
    b, h, w, code = _check([img_m, img_i], [flow_m, flow_i], mask)
    out = torch.empty((b, h, 3, w), dtype=img_m.dtype, device=img_m.device)
    _launch("rife_warp_render", [img_m, flow_m, img_i, flow_i, mask, out],
            b, h, w, code, img_m.device)
    LAUNCHES["warp_render"] += 1
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
    out_a = torch.empty(shape, dtype=img_a.dtype, device=img_a.device)
    out_b = torch.empty(shape, dtype=img_b.dtype, device=img_b.device)
    _launch("rife_warp_ds4_pair", [img_a, flow_a, img_b, flow_b, out_a, out_b],
            b, h, w, code, img_a.device)
    LAUNCHES["warp_ds4_pair"] += 1
    return out_a, out_b
