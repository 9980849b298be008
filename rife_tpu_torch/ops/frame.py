"""Frame pre/post-processing (port of ``rife_tpu/ops/frame.py:32-60``).

The public layout is the JAX package's: ``(B,H,W,3)`` u8 frames in and out.
Inside, the port carries NCHW tensors; ``postprocess_planar`` takes the
``(B,H,C,W)`` planes the render kernel writes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def preprocess(img_u8: torch.Tensor, pad_h: int, pad_w: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,H,W,3) u8 -> contiguous (B,3,pad_h,pad_w) in [0,1], zero-padded
    bottom/right.

    The multiply by 1/255 runs in the storage dtype, as the reference does
    (``frame.py:37``): in bf16 the constant is bf16(1/255)."""
    b, h, w, _ = img_u8.shape
    x = img_u8.permute(0, 3, 1, 2).to(dtype) * torch.tensor(
        1.0 / 255.0, dtype=dtype, device=img_u8.device)
    # the permuted view carries channels-last strides; the warp kernels
    # take contiguous NCHW planes
    return F.pad(x, (0, pad_w - w, 0, pad_h - h)).contiguous()


def _to_u8(v: torch.Tensor) -> torch.Tensor:
    """floor(v*255 + 0.5) in f32, saturated to u8."""
    return torch.floor(v.float() * 255.0 + 0.5).clamp(0.0, 255.0).to(
        torch.uint8)


def postprocess(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B,C,H,W) -> crop the pad -> (B,out_h,out_w,C) u8."""
    return _to_u8(x[:, :, :out_h, :out_w]).permute(0, 2, 3, 1).contiguous()


def postprocess_planar(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``postprocess`` on (B,H,C,W) planes; the one layout change runs on the
    u8 result."""
    return _to_u8(x[:, :out_h, :, :out_w]).permute(0, 1, 3, 2).contiguous()


def timestep_plane(t: torch.Tensor, b: int, pad_h: int, pad_w: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Constant-t plane, (B,1,pad_h,pad_w) (a broadcast view)."""
    return t.to(dtype).reshape(-1, 1, 1, 1).expand(b, 1, pad_h, pad_w)
