"""The clips the traffic plays: one seeded smooth scene panning a fixed
number of pixels a frame (the arithmetic of ``chip_smoke.py``'s
``smooth_field`` / ``moving_frames``), made on the run's device.

The scene is a bilinear upsampling of a coarse 6x10 grid of normal colours,
times 60 plus 128, plus per-pixel normal texture of std 8, saturated to u8;
frame k is the crop at columns ``step * k`` onward."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .seeds import derive


def clip(seed: int, n: int, h: int, w: int, step: int,
         device) -> torch.Tensor:
    """(n, h, w, 3) u8 frames on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "scene"))
    hh, ww = h + 16, w + 16 + step * n
    coarse = torch.randn(1, 3, 6, 10, generator=gen, device=device)
    base = F.interpolate(coarse, size=(hh, ww), mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0) * 60 + 128
    base = base + torch.randn(hh, ww, 3, generator=gen, device=device) * 8
    base = base.clamp(0, 255).to(torch.uint8)
    return torch.stack([base[8:8 + h, step * k:step * k + w]
                        for k in range(n)]).contiguous()
