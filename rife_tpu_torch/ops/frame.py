"""Frame pre/post-processing and the TTA view algebra (port of
``rife_tpu/ops/frame.py``).

The public layout is the JAX package's: ``(B,H,W,3)`` u8 frames in and out.
Inside, the port carries NCHW tensors; ``postprocess_planar`` takes the
``(B,H,C,W)`` planes the render kernel writes.

TTA views: view k of an image A (H,W) is, as in the JAX package,
``0: A  1: A[:, ::-1]  2: A[::-1, ::-1]  3: A[::-1, :]`` and views 4-7 the
same flips of ``A.T``.  Views 0-3 keep the canonical (H,W) geometry, 4-7 are
transposed (W,H); they travel as two groups ``(B,4,C,H,W)`` and
``(B,4,C,W,H)``, each run through the nets as one batch of 4B.  Every
function here takes the channel axis at dim -3, so it serves single frames
(B,C,H,W) and groups alike, and returns contiguous tensors (the warp kernels
take contiguous planes only).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .torch_ops import scalar


def preprocess(img_u8: torch.Tensor, pad_h: int, pad_w: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,H,W,3) u8 -> contiguous (B,3,pad_h,pad_w) in [0,1], zero-padded
    bottom/right.

    The multiply by 1/255 runs in the storage dtype, as the reference does
    (``frame.py:37``): in bf16 the constant is bf16(1/255)."""
    b, h, w, _ = img_u8.shape
    x = img_u8.permute(0, 3, 1, 2).to(dtype) * scalar(1.0 / 255.0, dtype)
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


# --- 8-view spatial TTA ------------------------------------------------------

_FLIPS = ((), (-1,), (-2, -1), (-2,))  # spatial dims to flip, per view-in-group


def _flip(x: torch.Tensor, dims) -> torch.Tensor:
    return torch.flip(x, dims) if dims else x


def expand_views8(x: torch.Tensor):
    """(B,C,H,W) -> group A (B,4,C,H,W) + group B (B,4,C,W,H)."""
    xt = x.transpose(-1, -2)
    return (torch.stack([_flip(x, f) for f in _FLIPS], dim=1),
            torch.stack([_flip(xt, f) for f in _FLIPS], dim=1))


def _inverse_views(ga: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """Bring each view back to canonical geometry -> (B,8,C,H,W)."""
    outs = [_flip(ga[:, k], _FLIPS[k]) for k in range(4)]
    outs += [_flip(gb[:, k], _FLIPS[k]).transpose(-1, -2) for k in range(4)]
    return torch.stack(outs, dim=1)


def _mean8(x: torch.Tensor) -> torch.Tensor:
    """Mean over dim 1 as ``jnp.mean`` reduces it: a bf16 operand upcast to
    f32, the views summed in order, divided by the count, cast back."""
    acc = x[:, 0].float()
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k].float()
    return (acc / x.shape[1]).to(x.dtype)


def merge_views8_mean(ga: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """Inverse-transform all 8 views and average -> (B,C,H,W)."""
    return _mean8(_inverse_views(ga, gb))


# Signed channel permutations of a flow (u, v) pair under each view, as
# ((source channel, sign), (source channel, sign)) for the output (u, v):
# _GATHER takes view-k components to canonical, _SCATTER canonical to view k.
_GATHER = (
    ((0, 1), (1, 1)), ((0, -1), (1, 1)), ((0, -1), (1, -1)), ((0, 1), (1, -1)),
    ((1, 1), (0, 1)), ((1, 1), (0, -1)), ((1, -1), (0, -1)), ((1, -1), (0, 1)),
)
_SCATTER = (
    ((0, 1), (1, 1)), ((0, -1), (1, 1)), ((0, -1), (1, -1)), ((0, 1), (1, -1)),
    ((1, 1), (0, 1)), ((1, -1), (0, 1)), ((1, -1), (0, -1)), ((1, 1), (0, -1)),
)


def _flow_channel_map(x: torch.Tensor, view: int, n_pairs: int, mask_ch,
                      table) -> torch.Tensor:
    """Apply the signed channel permutation of ``view`` to the flow pairs
    of ``x``; mask and further channels pass unchanged."""
    chans = []
    for p in range(n_pairs):
        for src, sign in table[view]:
            c = x.select(-3, 2 * p + src)
            chans.append(c if sign > 0 else -c)
    chans += [x.select(-3, m) for m in mask_ch]
    chans += [x.select(-3, e)
              for e in range(2 * n_pairs + len(mask_ch), x.shape[-3])]
    return torch.stack(chans, dim=-3)


def flow_views_avg(ga: torch.Tensor, gb: torch.Tensor, n_pairs: int,
                   has_mask: bool):
    """Spatial-TTA flow consensus: bring the 8 per-view flows to canonical
    geometry and components, average, and scatter the consensus back into
    all 8 view layouts.  Channels beyond ``2*n_pairs + has_mask`` keep their
    per-view values (the 6th channel of the v4.6 taps).  Returns groups of
    the input shapes."""
    mask_ch = [2 * n_pairs] if has_mask else []
    n_sig = 2 * n_pairs + len(mask_ch)
    canon = _inverse_views(ga, gb)
    contribs = torch.stack([
        _flow_channel_map(canon[:, k], k, n_pairs, mask_ch, _GATHER)
        for k in range(8)], dim=1)
    consensus = _mean8(contribs)[:, :n_sig]

    def scatter(view):
        f = _flow_channel_map(consensus, view, n_pairs, mask_ch, _SCATTER)
        if view >= 4:
            return _flip(f.transpose(-1, -2), _FLIPS[view - 4])
        return _flip(f, _FLIPS[view])

    new_a = torch.stack([scatter(k) for k in range(4)], dim=1)
    new_b = torch.stack([scatter(k) for k in range(4, 8)], dim=1)
    if ga.shape[-3] > n_sig:
        new_a = torch.cat([new_a, ga[:, :, n_sig:]], dim=2)
        new_b = torch.cat([new_b, gb[:, :, n_sig:]], dim=2)
    return new_a, new_b


# --- temporal TTA ------------------------------------------------------------

def _swap_half4(f: torch.Tensor) -> torch.Tensor:
    return torch.cat([f[..., 2:4, :, :], f[..., 0:2, :, :]], dim=-3)


def flow_temporal_avg_v1(flow: torch.Tensor, flow_rev: torch.Tensor):
    """v1: 2-channel flows; consensus (flow - flow_rev)/2, reversed = its
    negation."""
    merged = (flow - flow_rev) * 0.5
    return merged, -merged


def flow_temporal_avg_v2(flow: torch.Tensor, flow_rev: torch.Tensor):
    """v2: 4 channels (flow01 | flow10); the forward pairs average with the
    swapped halves of the reverse run."""
    merged = (flow + _swap_half4(flow_rev)) * 0.5
    return merged, _swap_half4(merged)


def flow_temporal_avg_v4(flow: torch.Tensor, flow_rev: torch.Tensor):
    """v4: the 4 flow channels as in v2, channel 4 (mask) merged with a sign
    flip, further channels untouched."""
    f4 = (flow[..., :4, :, :] + _swap_half4(flow_rev[..., :4, :, :])) * 0.5
    m = (flow[..., 4:5, :, :] - flow_rev[..., 4:5, :, :]) * 0.5
    merged = torch.cat([f4, m, flow[..., 5:, :, :]], dim=-3)
    reverse = torch.cat([_swap_half4(f4), -m, flow_rev[..., 5:, :, :]], dim=-3)
    return merged, reverse


def out_temporal_avg(out: torch.Tensor, out_rev: torch.Tensor) -> torch.Tensor:
    """Plain mean of the forward and reverse renders."""
    return (out + out_rev) * 0.5
