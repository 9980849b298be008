#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

Drives ``rife_tpu_torch`` on one card, through the entry points a user calls
(``RIFE(...).process_batch`` / ``process_batch_device``, and the CLI
``rife_tpu_torch.cli.main``), on ten session paths at full width: the
v4.6-architecture graph and the v2.3-architecture graphs (in-repo
reconstructions, synthetic weights), each plain, with ``fuse_ds2`` and with
``-x -z`` TTA plus ``fuse_ds2``, v2.3 with UHD ``-u`` at 4K, and the
v1-architecture ``rife`` graphs plain, with ``-x -z`` and with ``-u``; then
three CLI paths through the load -> proc -> save runner and the image
codecs; then the multi-device layer (batch and height sharding, ``-g all``)
on the one card named several times:

1. prints the card (nvidia-smi name, power limit) and the torch/CUDA versions;
2. builds the CUDA kernels from ``rife_tpu_torch/csrc`` (one nvcc per source,
   in parallel) and prints each kernel's registers and spills;
3. holds each kernel against its plain PyTorch twin on the card, in bf16 and
   f32, and times both with CUDA events: the three u8 pair warps (K5-K7,
   bit for bit) at the B=8 1088x1920 of a step (the kernels' report; K7
   also beside its sector floor) and at B=2 (plus an unaligned shape); the
   bf16 sigmoid on the card against the CPU's, timed beside
   ``torch.sigmoid``; ``warp_ds2`` (K3, bit for bit) at B=8 and B=2
   1088x1920, the transposed 1920x1088, an unaligned shape, B=1, odd H/2 and
   W/2, the smallest grid and a flow off its 2-element alignment (the
   kernel's scalar flow loads), timed beside the unfused
   form the graph runs without the switch (the ``warp_pair`` kernel, then
   ``resize2d``); ``warp_feat`` at the v2.3
   contextnet's four feature warps of a 1080p B=8 step (C=32..256, the batch
   of 16 both frames make; each level beside its own bound), an odd C and
   an unaligned size, raw flow and absolute positions; ``warp_u8`` at the
   fusionnet's frame warps; and
   ``conv3x3`` at every site the gates route to it in a bf16 1080p B=8
   v2.3 step, per site with cuDNN's bf16 time on the same call, the site's
   bound and the kernel's share of it, and each summed over the step;
   ``conv3x3_ps`` (B4's conv form, its own kernel ``csrc/conv_ps.cu``) at
   the v1 fusionnet's head site of a 1080p B=8 step (TMA in and out), bit
   for bit against the plain kernel's output shuffled (the same sum order)
   and against its twin, timed beside the unfused kernel +
   ``pixel_shuffle`` and cuDNN + ``pixel_shuffle``, and at the same site
   one column narrower (an odd width: the per-thread branch); the deconv
   kernel
   (``deconv4x4``, B4's deconv form among its sites) at every 4x4 stride-2
   deconv site of the bf16 v4.6, v2.3 and v1 1080p B=8 steps and the v2.3
   ``-u`` 4K B=2 step, in the site's order (planar: against its twin and
   bit for bit with the phase conv (``conv3x3`` over the phase weights);
   XLA's: its sums against the twin,
   its bias and activation bit for bit), timed beside cuDNN's
   ``conv_transpose2d`` + bias (+ activation, + ``pixel_shuffle``), the
   route it replaced; f32 planar sites on the f32 kernel's deconv mode.
   The f32 conv kernel (``phase_conv_f32``) at every f32 ``conv3x3`` site
   of a 1080p B=8 v2.3 and v1 step (``plan.conv_sites`` of f32 sessions:
   conv sites, deconv sites in its deconv mode, v1's head with ``ps`` 2),
   one launch each, against its twin, timed beside its twin, cuDNN f32
   with TF32 off and its f32 bound (f32 bytes over 3.35 TB/s or 2 x MACs
   over the FP32 pipes at ``clocks.max.sm``), summed over each step, each
   site weighted by its launches a step; then the f32 v2.3 step's device
   time.  The library conv sites' epilogue kernel (``phase_bias_act``) at
   each distinct site of the bf16 1080p B=8 v4.6 and v2.3 steps (recorded
   from the wrapper's calls, as many as ``plan.kernel_sites`` says), on the
   site's own bias and slope: bit for bit with its twin in bf16 and f32,
   and its device time (``torch.profiler``) beside its bound (the output
   read and written once), its twin's and that of the eager bias ``add_``
   + activation it replaced (the report's library time), each summed over
   a step.
   Every other timed kernel is printed beside its
   bound (bytes once over 3.35 TB/s, or bf16 FLOP over 989 TFLOP/s) and,
   for ``warp_feat``, ``grid_sample`` on a prebuilt grid.  Bars: warps f32
   max |d| <= 2e-6, conv3x3 f32 max |d| <= 1e-5 of the largest output;
   bf16 <= 1 ulp (for conv3x3 of max(|out|, 2^-14 x the sum of its absolute
   products), >= 99% exact;
4. runs the v4.6 slice: (a) f32 on the card (TF32 off) against the same
   session on the CPU at 256x448, u8 max |d| <= 1 and >= 99.9% exact; (b)
   bf16 1080p B=8 on smooth synthetic frames, every launch counter set to 0
   just before and read just after: 1 ds4-pair, 2 pair, 1 render, 4
   deconv and 40 ``bias_act`` (the library conv sites' epilogue) per step;
5. runs the v2.3 slice: (a) f32 on the card against the CPU session at
   544x960 (a size at which the gates route conv sites to ``conv3x3``), same
   bar, launches equal to ``plan.kernel_sites``; (b) bf16 1080p B=8, PSNR of
   its first two frames against f32 on the CPU, frames/s, and launch counts
   per step equal to ``plan.kernel_sites`` (printed beside them);
6. runs both slices with ``fuse_ds2=True``: f32 on the card against the CPU
   at the sizes of 4a and 5a, then bf16 1080p B=8 frames/s beside the
   unfused figure; launches equal ``plan.kernel_sites``, ``warp_ds2`` 2 per
   step;
7. runs both slices with ``-x -z`` and ``fuse_ds2=True``: f32 on the card
   against the CPU at 256x448 B=1 (for v2.3 a size at which the fusionnet's
   deconv sites reach ``conv3x3``), then bf16 1080p B=2 frames/s; launches
   equal ``plan.kernel_sites``;
8. runs v2.3 with ``-u`` (UHD: the flownet on the frames halved, its warps
   float warps): ``warp_feat`` against its twin at the UHD flownet's C=3
   frame warps of a 4K B=2 step (raw flow, timed, and the ds4 absolute
   positions); f32 on the card against the CPU at 576x1024 B=1 (conv sites
   on ``conv3x3``); then bf16 4K (2160x3840) B=2 frames/s, launches equal to
   ``plan.kernel_sites`` (no u8-origin launch from the flownet), and the PSNR
   of its first item against f32 on the CPU;
9. runs v1 ``rife``: f32 on the card against the CPU on the first pair of
   the 1080p bench frames (launches equal to the plan, ``conv3x3_ps``
   among them), bf16 1080p B=8 frames/s with the plan's launches and the
   PSNR of its first item against that f32 CPU frame (>= 30 dB, or within
   3 dB of the CPU's own bf16 session: bf16 costs this synthetic network
   that much on the CPU too), the flow statistics
   of the reconstruction; then ``-x -z`` at 256x448 and ``-u`` at 576x1024,
   f32 on the card against the CPU with the plan's launches;
10. runs the CLI in this process (bf16 on cuda:0): (a) directory mode, v4.6,
   32 smooth 1280x720 frames written as PNG by the port's encoder, ``-j
   2:8:<cores, at most 16>``: 64 outputs of the frame size, the t=0/1
   copies equal to their inputs and the 31 midpoints equal to
   ``RIFE.process_batch`` on the same batches of 8 (tail padded) byte for
   byte, launches equal to the plan times the batches; its wall frames/s
   beside the runner's stage summary, the device-only frames/s of the same
   step, the core count and the codec in use; then the runner alone on 256
   in-memory tasks (no codecs), its pinned side-stream path and its sync
   path in turns, byte for byte equal, each beside the device-only rate; (b) pair mode, v2.3 at 1080p,
   equal to ``RIFE.process`` byte for byte, launches as the plan says; (c)
   ``-g 0,0 -j 1:4,4:2`` over the first 8 frames, byte for byte equal to
   one session at ``-j 1:4:2``; and the rows of B=1, 3, 4 and 7 steps
   against the same rows of a B=8 step, u8 max |d| <= 1 unless
   ``batch_witness`` (each node of a B=2 step run again inside a B=4 step)
   names a cuDNN conv node whose rows follow B; every deconv, hand-kernel
   and PyTorch node bit for bit across B;
11. runs ``parallel/sharding.py`` (bf16 on cuda:0; ``phase_sharded``): the
   sharded warp (S, ``warp_spatial``: the kernel computes the global
   positions from a shard's flow rows and row0, over the whole source, a
   quarter of a 1080p frame's rows, u8 and float modes, with and without
   the 1/4 taps) bit for bit against its twin and the rows of the
   unsharded kernel, timed beside its bound (the source rows its positions
   reach read once, the flow rows, the output), the earlier form and
   ``grid_sample``; batch
   sharding over ``make_mesh()`` (every visible card) at v4.6 1080p B=8
   equal to the session byte for byte, and over [cuda:0, cuda:0] equal to
   a session at B=4 per shard; height sharding over four shards of cuda:0
   (v4.6 1080p B=2, v2.3 ``-u`` 4K B=1, v1 1080p B=1, v4.6 on a 2x2 mesh
   at B=4) against the unsharded session at the shard batch, >= 99.9%
   exact, u8 max |d| <= 1 (in bf16 unless ``node_witness`` names a cuDNN
   conv node that differs: each node run unsharded and sharded on the same
   inputs, every deconv, hand-kernel and PyTorch node bit for bit; a probe
   prints what cuDNN does to a window of rows, with
   ``torch.backends.cudnn.deterministic`` off and on); ``-g all`` in
   directory mode equal to ``-g 0``;
   each run's launches equal to ``ShardedRIFE.kernel_sites`` (no fused
   warp when height-sharded), its step time beside the unsharded step's
   and its halo and all-gather bytes;
12. traces the plain v4.6 bf16 1080p B=8 session for 3 steps after its
   warm-up inside ``utils/profiling.trace`` (``phase_profiling``): the
   Chrome trace it writes holds CUDA kernel events, and each hand kernel
   of the step, found by its CUDA symbol, launches ``plan.kernel_sites``
   x 3 times; each kernel's summed device ms from the trace is printed;
13. runs ``models/calibrate.py`` on the card (``phase_calibrate``, f32, TF32
   off) at ``TEST_HW`` (544x960) on smooth synthetic frames from the numpy
   seed, for the three reconstructions under their zoo names (``rife-v4.6``,
   ``rife-v2.3``, ``rife``): the flow std at the baked scale, the scale the
   bisection finds and its std, whether it ended at an edge of its bracket,
   and (v2.3, v1) the fusionnet scale the sweep finds and its u8 output
   std; and the flow std at the baked scale on 1088x1920 frames (a 1080p
   step's padded size, where the bench fixtures run); finite and positive.
   The stds at the baked scales are a finding about the fixtures, not a
   bar.  Then, on the same 544x960 frames at the baked scales, the raw
   flownet's flow tap (the f32 float warp on the raw graphs' ``rife.Warp``
   nodes) and the f32 fusionnet step (u8 frame) on the card against the
   CPU element by element: flow tap max |d| <= ``CAL_TAP_ABS`` px, u8 max
   |d| <= ``CAL_U8_ABS`` with >= ``CAL_U8_EXACT`` of the values equal; the
   path's launches are read from these card runs.  Last, the evaluations
   at 64x96: flow std within 1e-3 relative, u8 output std within 0.05;
14. prints the ``WallTimer`` report of the phases, the kernels' JSON line
   (launches of each path's counted run), the nvidia-smi line and, last,
   the ``{"ok": true, "device": ...}`` line.

Any failed check raises and exits non-zero before the last line.  Without a
card, or without the rest of the repository beside it, it exits non-zero.

Run from the repository root: ``python3 chip_smoke.py``
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
STEP_SHAPE = (8, 1088, 1920)  # the warps of one 1080p B=8 step
MAIN_SHAPE = (2, 1088, 1920)
ODD_SHAPE = (2, 52, 196)
DS2_SHAPES = [STEP_SHAPE, MAIN_SHAPE, (2, 1920, 1088), ODD_SHAPE]
# K3 edge shapes: B=1, odd H/2 and W/2 (27x99), the smallest grid
DS2_EDGE = [(1, 1088, 1920), (1, 54, 198), (1, 2, 2)]
V46_CHECK = (1, 256, 448)
V23_CHECK = (2, 544, 960)
# v1: the fusionnet's head conv (B4) takes the half-resolution decoder
# output, which the planar gate admits from 1080p on
V1_CHECK = (1, 1080, 1920)
# the card's bf16 and the CPU's (oneDNN's convs) sum in other orders, and
# the v1 reconstruction's SE gates amplify such differences: the card's
# bf16 may lie a few dB further from f32 than the CPU's (PERF.md §6)
V1_BF16_SLACK_DB = 3.0
TTA_CHECK = (1, 256, 448)
# -u: the flownet halves the padded frames and reaches 1/32 of them, so the
# padded sides are multiples of 64; 576x1024 is large enough for the gates
# to send the contextnet's and fusionnet's sites to conv3x3
UHD_CHECK = (1, 576, 1024)
UHD_BENCH = (2, 2160, 3840)
BENCH = (8, 1080, 1920)
# the CLI phase: directory mode over CLI_FRAMES frames of CLI_SIZE at
# -j 2:CLI_BATCH:<cores, at most 16>; pair mode at 1080p; two sessions on
# one card over the first CLI_MULTI frames
CLI_FRAMES = 32
CLI_SIZE = (720, 1280)
CLI_BATCH = 8
CLI_MULTI = 8
CLI_MULTI_BATCH = 4
RUNNER_TASKS = 256  # the runner without codecs: 32 steps of B=8 at 720p
TTA_BATCH = 2
BENCH_STEPS = 5
V23_PSNR_ITEMS = 2
# v2.3 contextnet feature warps of a 1080p B=8 step: (C, H, W) at batch 16
FEAT_SHAPES = [(32, 272, 480), (64, 136, 240), (128, 68, 120), (256, 34, 60)]
FEAT_EXTRA = [(2, 7, 68, 120), (2, 32, 33, 61)]  # odd C, unaligned size
# height sharding on four shards of cuda:0: (path, model, modes, mesh,
# (B, H, W)); and the sharded warp's cases: (kernel, u8, (B, C, H, W)),
# a quarter of the rows sampled over the whole source
SHARDED_CASES = [
    ("height 1x4 v4.6", "v4.6", {}, (1, 4), (2, 1080, 1920)),
    ("height 1x4 v2.3 -u", "v2.3", {"uhd_mode": True}, (1, 4),
     (1, 2160, 3840)),
    ("height 1x4 v1", "v1", {}, (1, 4), (1, 1080, 1920)),
    ("height 2x2 v4.6", "v4.6", {}, (2, 2), (4, 1080, 1920)),
]
SHARDED_WARPS = [("u8", True, (2, 3, 1088, 1920)),
                 ("float", False, (2, 32, 544, 960))]
# bf16 height sharding against the unsharded session: u8 max |d| <= 1 and
# >= 99.9% exact, as every other path.  Every deconv site of a bf16 run
# takes the deconv kernel, whose sums do not depend on the window or the
# batch; cuDNN picks its algorithms by shape, so a cuDNN conv node can
# still round a window of rows otherwise than the whole frame (and a bf16
# flow one ulp apart moves a few samples across the frames' texture).  A
# case above 1 passes only where ``node_witness`` names such a cuDNN conv
# node (C15, left open for it), and then at >= 99.9% exact and PSNR above
# SHARDED_BF16_PSNR_DB; every deconv, hand-kernel and PyTorch node must be
# bit for bit.
SHARDED_BF16_PSNR_DB = 50.0
HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
BF16_FLOP_S = 989e12    # H100 SXM dense bf16 tensor-core rate
FP32_LANES = 128        # FP32 FMA lanes an SM (Hopper)
F32_SEED = 20261017     # the f32 conv sites' inputs
WARP_SRC = "rife_tpu/ops/warp_pallas.py"
CONV_SRC = "rife_tpu/ops/conv_planar.py"
KERNELS = {
    # name: (source, replaced TPU kernel, further TPU kernels it covers)
    "warp_ds4_pair": ("warp.cu", f"{WARP_SRC}:1662", [f"{WARP_SRC}:1610"]),
    "warp_pair": ("warp.cu", f"{WARP_SRC}:1274", []),
    "warp_render": ("warp.cu", f"{WARP_SRC}:1304", []),
    "warp_feat": ("warp.cu", f"{WARP_SRC}:146", [f"{WARP_SRC}:515"]),
    "warp_u8": ("warp.cu", f"{WARP_SRC}:2321", []),
    "warp_ds2": ("warp.cu", f"{WARP_SRC}:2052", [f"{WARP_SRC}:1899"]),
    "warp_spatial": ("warp.cu", f"{WARP_SRC}:2901", []),
    "conv3x3": ("conv.cu", f"{CONV_SRC}:309",
                [f"{CONV_SRC}:485", f"{CONV_SRC}:97", f"{CONV_SRC}:190"]),
    "conv3x3_ps": ("conv_ps.cu", f"{CONV_SRC}:756", []),
    "deconv4x4": ("deconv.cu", f"{CONV_SRC}:784", [f"{CONV_SRC}:732"]),
    # the port's own: XLA fuses a conv's bias and activation into the conv
    "bias_act": ("bias_act.cu", "none", []),
}
# the B4 deconv form's reference site: the v4.6 block tail,
# deconv 64 -> 24 then PixelShuffle 2, at the 1/4 grid of a 1080p B=8 step
DECONV_PS_SITE = ((64,), 24, 2, 272, 480)
# the CUDA symbol of each launch counter the traced v4.6 step runs, as
# ``kernel_symbol`` reads the trace's demangled names (``warp_pair`` is the
# u8 form of ``warp_gather_kernel``)
KERNEL_SYMBOLS = {
    "warp_pair": "warp_gather_kernel", "warp_render": "warp_render_kernel",
    "warp_ds4_pair": "warp_ds4_pair_kernel", "deconv4x4": "deconv4x4_kernel",
    "bias_act": "bias_act_kernel",
}
TRACE_STEPS = 3
# the calibration: the three reconstructions under their zoo names; the
# card against the CPU element by element at TEST_HW and the baked scales
# (bars set from the card's readings, PERF.md section 6, PR 13), and by the
# std at CAL_SMALL
CAL_SMALL = (64, 96)
CAL_SEED = 20261016  # the frames' own seed: readings independent of the
                     # phases before
CAL_FLOW_REL = 1e-3
CAL_OUT_ABS = 0.05
CAL_TAP_ABS = 1e-3   # px, the flow tap's max |d| (read: <= 1.011e-4)
CAL_U8_ABS = 1       # the u8 frame's max |d| (read: 1)
CAL_U8_EXACT = 0.999  # the share of u8 values equal (read: >= 0.999578)
PAIR_KERNELS = {  # name: (wrapper, twin)
    "warp_ds4_pair": ("warp_ds4_pair", "warp_ds4_pair_ref"),
    "warp_pair": ("warp_pair", "warp_pair_ref"),
    "warp_render": ("warp_render", "warp_render_ref"),
}


# launches per step of the fused plain paths at 1080p
FUSED_PER_STEP = {
    "v4.6": {"warp_ds4_pair": 1, "warp_pair": 1, "warp_ds2": 2,
             "warp_render": 1, "deconv4x4": 4, "bias_act": 40},
    "v2.3": {"conv3x3": 8, "deconv4x4": 9, "warp_feat": 4, "warp_u8": 2,
             "warp_pair": 1, "warp_ds2": 2, "warp_ds4_pair": 1,
             "bias_act": 44},
}


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def smooth_field(rng, b, h, w, c, cells=(6, 10)) -> np.ndarray:
    """Smooth random field (b,h,w,c): bilinear upsampling of a coarse grid."""
    coarse = rng.normal(size=(b, c, *cells)).astype(np.float32)
    t = torch.nn.functional.interpolate(
        torch.from_numpy(coarse), size=(h, w), mode="bilinear",
        align_corners=False)
    return np.ascontiguousarray(t.permute(0, 2, 3, 1).numpy())


def smooth_frames(rng, b, h, w):
    """u8 frame pairs: smooth colour fields plus texture; frame 1 is frame 0
    shifted by a few pixels."""
    base = smooth_field(rng, b, h + 16, w + 16, 3) * 60 + 128
    base += rng.normal(size=base.shape).astype(np.float32) * 8
    f0 = base[:, 8:8 + h, 8:8 + w]
    f1 = base[:, 5:5 + h, 11:11 + w]
    # C-contiguous (B,H,W,3), as decoded frames arrive
    return (np.ascontiguousarray(np.clip(f0, 0, 255).astype(np.uint8)),
            np.ascontiguousarray(np.clip(f1, 0, 255).astype(np.uint8)))


def smooth_flow(rng, b, h, w, dtype, device, shift=25.0):
    """(B,2,H,W) smooth flow plus noise whose top rows leave the frame."""
    f = smooth_field(rng, b, h, w, 2) * 12
    f += rng.normal(size=f.shape).astype(np.float32) * 0.7
    f[:, : h // 10] += shift
    return torch.from_numpy(f).permute(0, 3, 1, 2).to(
        device=device, dtype=dtype).contiguous()


def kernel_inputs(rng, shape, dtype, device):
    """NCHW images (u8/255 as preprocess makes them), flows that leave the
    frame, and a mask, in ``dtype`` on ``device``."""
    from rife_tpu_torch.ops import frame

    b, h, w = shape
    f0, f1 = smooth_frames(rng, b, h, w)
    imgs = [frame.preprocess(torch.from_numpy(f).to(device), h, w, dtype)
            for f in (f0, f1)]
    flows = [smooth_flow(rng, b, h, w, dtype, device, 25.0 * (1 - 2 * k))
             for k in range(2)]
    mask = torch.sigmoid(torch.from_numpy(smooth_field(rng, b, h, w, 1)[..., 0])
                         * 3).to(device=device, dtype=dtype)
    return imgs[0], flows[0], imgs[1], flows[1], mask


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def compare(got, want, dtype, f32_rel=None, scale=None) -> float:
    """Tolerances of tests/test_torch_warp.py and tests/test_torch_cuda.py;
    returns max |d|.  ``scale`` (conv3x3): the sum of the absolute products
    of each output; bf16 ulps are then taken of max(|want|, 2^-14 scale),
    since two f32 sums in different orders differ by up to ~2^-23 scale,
    more than one ulp of an output that cancels to near zero."""
    g, r = got.float(), want.float()
    require(g.shape == r.shape, f"shape {tuple(g.shape)} vs {tuple(r.shape)}")
    require(bool(torch.isfinite(g).all()), "non-finite kernel output")
    diff = (g - r).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        bound = 2e-6 if f32_rel is None else f32_rel * float(r.abs().max())
        require(err <= bound, f"f32 max |d| {err} > {bound}")
    else:
        mag = r if scale is None else torch.maximum(r.abs(),
                                                    scale * 2.0 ** -14)
        require(bool((diff <= bf16_ulp(mag)).all()), f"bf16 |d| {err} > 1 ulp")
        exact = float((diff == 0).float().mean())
        require(exact >= 0.99, f"bf16 exact share {exact} < 0.99")
    return err


def time_ms(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str | None, iters=20) -> float:
    """The device time of one launch of the kernel whose name contains
    ``kernel`` (``None``: of one call of ``fn``, all its kernels summed),
    from ``torch.profiler`` over ``iters`` calls of ``fn`` (no host launch
    cost in it, unlike CUDA events around back-to-back calls of a kernel
    shorter than its launch)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    if kernel is None:
        cuda = torch.autograd.DeviceType.CUDA
        ns = sum(e.duration_ns()
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == cuda and not e.is_user_annotation())
        require(ns > 0, "the profiler recorded no device time")
        return ns / 1e6 / iters
    hits = [e for e in prof.key_averages() if kernel in e.key]
    require(bool(hits), f"the profiler saw no {kernel} launch")
    return (sum(e.self_device_time_total for e in hits)
            / sum(e.count for e in hits) / 1e3)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(n_bytes, flops=0.0):
    """(least time in ms, what sets it): the bytes over 3.35 TB/s or the
    bf16 operations over 989 TFLOP/s (H100 SXM data sheet), the larger."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_S, flops / BF16_FLOP_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def check_pair(report, name, kfn, tfn, args, dtype, label, timed,
               f32_rel=None, iters=20, tally=True, bound=None, library=None,
               scale=None):
    """Run a kernel and its twin on the same inputs, compare, and (timed)
    print both times and (tally) add them, the bound (ms, what sets it) and
    the library call's time to the kernel's report; returns (kernel ms,
    library ms), None where not timed."""
    got, want = kfn(*args), tfn(*args)
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max(compare(g, r, dtype, f32_rel, scale) for g, r in zip(got, want))
    rep = report.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                   "plain_ms": 0.0, "bound_ms": 0.0,
                                   "bound_by": None, "library_ms": None})
    rep["max_abs_err"] = max(rep["max_abs_err"], err)
    line = f"kernel {name} {str(dtype)[6:]} {label}: max|d| vs twin {err:.3g}"
    ms = lib = None
    if timed:
        ms = time_ms(lambda: kfn(*args), iters)
        plain = time_ms(lambda: tfn(*args), max(2, iters // 4))
        line += (f", kernel {ms:.4f} ms, plain twin {plain:.4f} ms "
                 f"(CUDA events)")
        if bound is not None:
            line += f", bound {bound[0]:.4f} ms ({bound[1]})"
        lib = time_ms(library, iters) if library is not None else None
        if lib is not None:
            line += f", library call {lib:.4f} ms"
        if tally:
            rep["ms"] += ms
            rep["plain_ms"] += plain
            if bound is not None:
                rep["bound_ms"] += bound[0]
                rep["bound_by"] = bound[1]
            if lib is not None:
                rep["library_ms"] = (rep["library_ms"] or 0.0) + lib
    print(line, flush=True)
    return ms, lib


def phase_pair_kernels(device, rng, report):
    """The u8 pair warps (K5-K7): bf16 timed at STEP_SHAPE (the report) and
    MAIN_SHAPE."""
    from rife_tpu_torch.ops import warp as W

    for dtype in (torch.bfloat16, torch.float32):
        shapes = ((STEP_SHAPE, MAIN_SHAPE, ODD_SHAPE) if dtype == torch.bfloat16
                  else (MAIN_SHAPE, ODD_SHAPE))
        for shape in shapes:
            ia, fa, ib, fb, m = kernel_inputs(rng, shape, dtype, device)
            args = {"warp_pair": (ia, fa, ib, fb),
                    "warp_ds4_pair": (ia, fa, ib, fb),
                    "warp_render": (ia, fa, ib, fb, m)}
            # each input byte the function reads once, each output byte
            # written once; ds4 reads the flows at the 1/4 tap grid only
            n_bytes = {
                "warp_pair": nbytes(ia, fa, ib, fb) + 2 * nbytes(ia),
                "warp_ds4_pair": (nbytes(ia, fa, ib, fb) + nbytes(ia) // 2) / 4,
                "warp_render": nbytes(ia, fa, ib, fb, m) + nbytes(ia)}
            timed = dtype == torch.bfloat16 and shape != ODD_SHAPE
            for name, (wrap, twin) in PAIR_KERNELS.items():
                ms, _ = check_pair(report, name, getattr(W, wrap),
                                   getattr(W, twin), args[name], dtype,
                                   f"B,H,W={shape}", timed,
                                   tally=shape == STEP_SHAPE,
                                   bound=bound_ms(n_bytes[name]))
                require(report[name]["max_abs_err"] == 0.0,
                        f"{name} differs from its twin at {shape}")
                if name == "warp_ds4_pair" and timed:
                    floor = ds4_sector_floor_ms(ia, fa, ib, fb)
                    print(f"  warp_ds4_pair {shape}: sector floor "
                          f"{floor:.4f} ms beside its bound "
                          f"{bound_ms(n_bytes[name])[0]:.4f} ms; kernel at "
                          f"{100 * floor / ms:.1f}% of the floor", flush=True)
            del ia, fa, ib, fb, m, args
            torch.cuda.empty_cache()


def ds4_sector_floor_ms(ia, fa, ib, fb) -> float:
    """The least time K7's stride-4 taps can take, counted in the 32-byte
    sectors device memory moves: every sector of flow rows 4i+1 and 4i+2
    (half the flows), of at least three image rows in four (the taps'
    corner rows 4i+1..4i+3 at zero flow), and the outputs once."""
    n_bytes = (nbytes(fa, fb) / 2 + nbytes(ia, ib) * 3 / 4
               + nbytes(ia, ib) / 16)
    return n_bytes / HBM_BYTES_S * 1e3


def phase_sigmoid(device, rng):
    """The bf16 sigmoid of ``torch_ops`` (``1 / (1 + exp(-x))``, each step
    in bf16, as XLA:CPU computes ``jax.nn.sigmoid``) on the card against the
    same function on the CPU, over every finite bf16 value and over the
    v4.6 mask of a 1080p B=8 step: <= 1 ulp and >= 99.9% exact (the card's
    ``exp`` may round its f32 result otherwise than the CPU's).  Timed
    beside ``torch.sigmoid`` at the v4.6 mask (B,1,H,W) and the v2.3
    fusionnet's four sigmoid channels (B,4,H,W)."""
    from rife_tpu_torch.ops.torch_ops import sigmoid

    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    every = bits.view(np.float32)
    b, h, w = STEP_SHAPE
    logits = smooth_field(rng, b, h, w, 1)[..., 0] * 6
    for label, x in (("every finite bf16 value",
                      torch.from_numpy(every[np.isfinite(every)])),
                     (f"v4.6 mask {(b, 1, h, w)}",
                      torch.from_numpy(logits).unsqueeze(1))):
        x = x.to(torch.bfloat16)
        want = sigmoid(x).float()
        got = sigmoid(x.to(device)).float().cpu()
        diff = (got - want).abs()
        ulp_ok = bool((diff <= bf16_ulp(want)).all())
        exact = float((diff == 0).float().mean())
        print(f"sigmoid bf16 cuda vs cpu, {label}: max |d| "
              f"{float(diff.max()):.3g}, exact {exact:.6f}", flush=True)
        require(ulp_ok and exact >= 0.999,
                f"bf16 sigmoid on the card differs from the CPU ({label})")
    for c in (1, 4):
        x = torch.from_numpy(smooth_field(rng, b, h, w, c)).permute(
            0, 3, 1, 2).contiguous().to(device=device, dtype=torch.bfloat16)
        stepwise = time_ms(lambda: sigmoid(x))
        once = time_ms(lambda: torch.sigmoid(x))
        print(f"sigmoid bf16 {tuple(x.shape)}: stepwise {stepwise:.4f} ms, "
              f"torch.sigmoid {once:.4f} ms, cost {stepwise - once:.4f} ms "
              f"(CUDA events)", flush=True)
    del x
    torch.cuda.empty_cache()


def phase_warp_ds2(device, rng, report):
    """``warp_ds2`` (K3) bit for bit with its twin at DS2_SHAPES and DS2_EDGE
    in bf16 and f32 (STEP_SHAPE in bf16 only), and with a flow one element
    off its 2-element alignment (the scalar flow loads); bf16 at STEP_SHAPE
    (the report) and MAIN_SHAPE it is timed against its twin, and at
    MAIN_SHAPE a block entry's two fused warps against the unfused form on
    the same inputs (one ``warp_pair`` launch, then ``resize2d`` of each
    warp)."""
    from rife_tpu_torch.ops import warp as W
    from rife_tpu_torch.ops.torch_ops import resize2d

    for dtype in (torch.bfloat16, torch.float32):
        for shape in DS2_SHAPES + DS2_EDGE:
            if dtype == torch.float32 and shape == STEP_SHAPE:
                continue
            ia, fa, ib, fb, _ = kernel_inputs(rng, shape, dtype, device)
            main = shape == MAIN_SHAPE and dtype == torch.bfloat16
            check_pair(report, "warp_ds2", W.warp_ds2, W.warp_ds2_ref,
                       (ia, fa), dtype, f"B,H,W={shape}",
                       main or shape == STEP_SHAPE,
                       tally=shape == STEP_SHAPE,
                       bound=bound_ms(nbytes(ia, fa) + nbytes(ia) / 4))
            if shape == ODD_SHAPE:
                odd = torch.empty(fa.numel() + 1, device=device,
                                  dtype=dtype)[1:].view(fa.shape)
                odd.copy_(fa)
                require(odd.data_ptr() % (2 * odd.element_size()) != 0,
                        "the unaligned flow is aligned")
                check_pair(report, "warp_ds2", W.warp_ds2,
                           lambda i, f: W.warp_ds2_ref(i, fa), (ia, odd),
                           dtype, f"B,H,W={shape}, flow off its alignment",
                           False)
            require(report["warp_ds2"]["max_abs_err"] == 0.0,
                    f"warp_ds2 differs from its twin at {shape}")
            if main:
                h, w = shape[1], shape[2]
                fused = time_ms(lambda: (W.warp_ds2(ia, fa),
                                         W.warp_ds2(ib, fb)))
                unfused = time_ms(lambda: [
                    resize2d(y, h // 2, w // 2)
                    for y in W.warp_pair(ia, fa, ib, fb)])
                report["warp_ds2"].update(fused_pair_ms=fused,
                                          unfused_pair_ms=unfused)
                print(f"  two warps + 1/2 downsample {shape}: fused 2x "
                      f"warp_ds2 {fused:.4f} ms, unfused warp_pair + 2x "
                      f"resize2d {unfused:.4f} ms (CUDA events)", flush=True)
            del ia, fa, ib, fb
    torch.cuda.empty_cache()


def sample_grid(flow):
    """grid_sample's (B,H,W,2) grid of pixel + flow, normalised for
    align_corners=True."""
    b, _, h, w = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device),
                            torch.arange(w, device=flow.device), indexing="ij")
    gx = (xs + flow[:, 0].float()) * (2.0 / max(w - 1, 1)) - 1
    gy = (ys + flow[:, 1].float()) * (2.0 / max(h - 1, 1)) - 1
    return torch.stack([gx, gy], dim=-1).to(flow.dtype)


def phase_single_warp(device, rng, report):
    """``warp_feat`` (K1/K2) at the contextnet's feature-warp shapes of one
    1080p B=8 step (timed in f32 and bf16; the bf16 sum, one step's, goes to
    the report), plus an odd C,
    an unaligned size and the absolute-position form; ``warp_u8`` (K4) at
    the fusionnet's two 1088x1920 frame warps of that step (timed: one)."""
    from rife_tpu_torch.ops import warp as W

    b2 = 2 * BENCH[0]
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        levels = [0.0, 0.0]
        for c, h, w in FEAT_SHAPES:
            img = torch.randn(b2, c, h, w, device=device).mul_(2).to(dtype)
            flow = smooth_flow(rng, b2, h, w, dtype, device, shift=6.0)
            # f32 (K1's form) is timed too, the report keeps bf16 (K2's);
            # the library call: grid_sample on a grid built beforehand
            grid = sample_grid(flow)
            bound = bound_ms(nbytes(img, flow) + nbytes(img))
            ms, _ = check_pair(
                report, "warp_feat", W.warp_feat, W.warp_feat_ref,
                (img, flow), dtype, f"B,C,H,W={(b2, c, h, w)}", True,
                tally=timed, bound=bound,
                library=lambda: torch.nn.functional.grid_sample(
                    img, grid, mode="bilinear", padding_mode="border",
                    align_corners=True))
            levels[0] += ms
            levels[1] += bound[0]
            print(f"  level C={c} {h}x{w}: kernel {ms:.4f} ms, bound "
                  f"{bound[0]:.4f} ms, {100 * bound[0] / ms:.1f}% of it",
                  flush=True)
        print(f"warp_feat {str(dtype)[6:]} over the four levels of a step: "
              f"kernel {levels[0]:.4f} ms, bound {levels[1]:.4f} ms, "
              f"{100 * levels[1] / levels[0]:.1f}% of it", flush=True)
        for b, c, h, w in FEAT_EXTRA:
            img = torch.randn(b, c, h, w, device=device).to(dtype)
            flow = smooth_flow(rng, b, h, w, dtype, device)
            check_pair(report, "warp_feat", W.warp_feat, W.warp_feat_ref,
                       (img, flow), dtype, f"B,C,H,W={(b, c, h, w)}", False)
            pos = W.ds4_positions(flow)
            check_pair(report, "warp_feat",
                       lambda i, p: W.warp_feat(i, p, abs_pos=True),
                       lambda i, p: W.warp_feat_ref(i, p, abs_pos=True),
                       (img, pos), dtype, f"abs_pos B,C,Ho,Wo={(b, c, *pos.shape[2:])}",
                       False)
        ia, fa, _, _, _ = kernel_inputs(rng, STEP_SHAPE, dtype, device)
        check_pair(report, "warp_u8", W.warp_u8, W.warp_u8_ref, (ia, fa),
                   dtype, f"B,H,W={STEP_SHAPE}", timed,
                   bound=bound_ms(nbytes(ia, fa) + nbytes(ia)))
        ia, fa, _, _, _ = kernel_inputs(rng, ODD_SHAPE, dtype, device)
        check_pair(report, "warp_u8",
                   lambda i, f: W.warp_u8(i, W.ds4_positions(f), abs_pos=True),
                   lambda i, f: W.warp_u8_ref(i, W.ds4_positions(f),
                                              abs_pos=True),
                   (ia, fa), dtype, f"abs_pos B,H,W={ODD_SHAPE}", False)
        del ia, fa
    torch.cuda.empty_cache()


def conv_site_bound(b, parts, cout, stride, h, w, deconv):
    """(ms, what sets it) of one conv3x3 site: bf16 input, weights and
    output once, f32 bias and slope; the MACs of the 3x3 conv (a deconv
    site: the 4x4 transposed conv's 16 taps, not the phase form's zeros)."""
    cin = sum(parts)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = b * cout * ho * wo
    taps = 16 * cout // 4 if deconv else 9 * cout
    n_bytes = 2 * b * cin * h * w + 2 * taps * cin + 8 * cout + 2 * out
    macs = (16 * cin * (cout // 4) * h * w * b if deconv
            else 9 * cin * out)
    return bound_ms(n_bytes, 2.0 * macs)


def phase_conv(device, rng, report, sites):
    """bf16 ``conv3x3`` at each site of one bf16 1080p B=8 v2.3 step (none
    is a deconv site: bf16 deconvs take the deconv kernel), random weights,
    every activation as the site has it, against its twin; per site the
    kernel's time, cuDNN's on the same call (``conv2d`` on the concat), the
    site's bound and the kernel's share of it; then each summed over the
    step.  (The f32 sites: ``phase_conv_f32``.)"""
    from rife_tpu_torch.ops import conv as CV

    F = torch.nn.functional
    dtype = torch.bfloat16
    sums = {"kernel": 0.0, "cudnn": 0.0, "bound": 0.0}
    for i, (factor, parts, cout, stride, act, h, w, deconv) in \
            enumerate(sites):
        require(not deconv, f"bf16 conv3x3 site {i} is a deconv site")
        b = factor * BENCH[0]
        xs = [torch.randn(b, c, h, w, device=device).to(dtype)
              for c in parts]
        cin = sum(parts)
        bias = torch.randn(cout, device=device) * 0.1
        slope = torch.rand(cout, device=device) * 0.3
        weight = (torch.randn(cout, cin, 3, 3, device=device)
                  * (1.0 / (3.0 * cin ** 0.5))).to(dtype)
        packed = CV.pack_weight_tc(weight)
        kfn = lambda x, wt, bi, sl: CV.conv3x3(  # noqa: E731
            x, wt, bi, sl, stride=stride, act=act, weight_tc=packed)
        tfn = lambda x, wt, bi, sl: CV.conv3x3_ref(  # noqa: E731
            x, wt, bi, sl, stride=stride, act=act)
        scale = CV.conv3x3_ref([x.float().abs() for x in xs],
                               weight.float().abs(), stride=stride)
        cat = torch.cat(xs, dim=1)
        library = lambda: F.conv2d(  # noqa: E731
            cat, weight, None, stride=stride, padding=1)
        bound = conv_site_bound(b, parts, cout, stride, h, w, deconv)
        ms, lib = check_pair(
            report, "conv3x3", kfn, tfn, (xs, weight, bias, slope), dtype,
            f"site {i}: B={b} parts={parts} cout={cout} s{stride} act{act} "
            f"{h}x{w}", True, iters=10, bound=bound, library=library,
            scale=scale)
        sums["kernel"] += ms
        sums["cudnn"] += lib
        sums["bound"] += bound[0]
        print(f"  site {i}: kernel {ms:.4f} ms, cuDNN bf16 {lib:.4f} "
              f"ms, bound {bound[0]:.4f} ms ({bound[1]}), kernel at "
              f"{100 * bound[0] / ms:.1f}% of its bound", flush=True)
        del xs, weight, scale, library
    print(f"conv3x3 bf16 over the {len(sites)} sites of one step: "
          f"kernel {sums['kernel']:.4f} ms, cuDNN bf16 "
          f"{sums['cudnn']:.4f} ms, bound {sums['bound']:.4f} ms, "
          f"kernel at {100 * sums['bound'] / sums['kernel']:.1f}% of "
          f"the bound", flush=True)
    torch.cuda.empty_cache()


def fp32_peak():
    """(FLOP/s, SM clock MHz, SMs) of the FP32 pipes outside the tensor
    cores: 2 x 128 FMA lanes an SM x the SMs x the card's maximum SM clock
    (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    mhz = float(out.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 2.0 * FP32_LANES * sms * mhz * 1e6, mhz, sms


def conv_site_bound_f32(b, parts, cout, stride, h, w, deconv, flop_s):
    """(ms, what sets it) of one f32 conv3x3 site: f32 input, weights and
    output once, f32 bias and slope; 2 x the MACs over ``flop_s`` (the FP32
    pipes' peak, ``fp32_peak``).  A deconv site (``cout`` = 4 x its O
    channels) counts the 4x4 transposed conv's 16 taps, not the phase
    form's zeros, and its (B, O, 2H, 2W) output."""
    cin = sum(parts)
    if deconv:
        o = cout // 4
        out = b * o * 4 * h * w
        n_bytes = 4 * (b * cin * h * w + 16 * cin * o + out) + 8 * o
        macs = 16 * cin * o * h * w * b
    else:
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        out = b * cout * ho * wo
        n_bytes = 4 * (b * cin * h * w + 9 * cin * cout + out) + 8 * cout
        macs = 9 * cin * out
    by_bytes, by_ops = n_bytes / HBM_BYTES_S, 2.0 * macs / flop_s
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def f32_site_fns(device, gen, site, ps):
    """(kernel, twin, cuDNN) thunks of one f32 conv3x3 site on random
    inputs from ``gen``: ``deconv4x4`` / ``deconv4x4_ref`` /
    ``conv_transpose2d`` on the raw weights at a deconv site, else
    ``conv3x3`` / ``conv3x3_ref`` / ``conv2d`` on the concat (with ``ps`` >
    1 each followed by its PixelShuffle)."""
    from rife_tpu_torch.ops import conv as CV

    F = torch.nn.functional
    factor, parts, cout, stride, act, h, w, deconv = site
    b, cin = factor * BENCH[0], sum(parts)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=device, generator=gen) * scale
    xs = [randn(b, c, h, w) for c in parts]
    if deconv:
        o = cout // 4
        raw = randn(cin, o, 4, 4, scale=1.0 / (2.0 * cin ** 0.5))
        w3 = CV.deconv_phase_weights(raw).contiguous()
        t4 = CV.pack_weight_t4(raw)
        b4 = randn(o, scale=0.1).repeat(4)
        s4 = (randn(o).abs() * 0.3).repeat(4)
        x = xs[0]
        return (lambda: CV.deconv4x4(x, w3, b4, s4, act=act, weight_t4=t4,
                                     ps=ps),
                lambda: CV.deconv4x4_ref(x, w3, b4, s4, act=act, ps=ps),
                lambda: F.conv_transpose2d(x, raw, None, stride=2,
                                           padding=1))
    weight = randn(cout, cin, 3, 3, scale=1.0 / (3.0 * cin ** 0.5))
    tc = CV.pack_weight_tc(weight)
    bias, slope = randn(cout, scale=0.1), randn(cout).abs() * 0.3
    cat = torch.cat(xs, dim=1)

    def library():
        y = F.conv2d(cat, weight, None, stride=stride, padding=1)
        return F.pixel_shuffle(y, ps) if ps > 1 else y
    return (lambda: CV.conv3x3(xs, weight, bias, slope, stride=stride,
                               act=act, weight_tc=tc, ps=ps),
            lambda: CV.conv3x3_ref(xs, weight, bias, slope, stride=stride,
                                   act=act, ps=ps),
            library)


@contextlib.contextmanager
def count_interleaves():
    """Calls of ``ops/conv.py`` ``interleave_phases`` while it runs (the
    f32 deconv mode writes the interleaved output itself: none)."""
    from rife_tpu_torch.ops import conv as CV

    calls, plain = [], CV.interleave_phases

    def counted(y4):
        calls.append(tuple(y4.shape))
        return plain(y4)
    CV.interleave_phases = counted
    try:
        yield calls
    finally:
        CV.interleave_phases = plain


def phase_conv_f32(device, report, paths, card):
    """f32 ``conv3x3`` at every f32 site of a 1080p B=8 step of each path
    ({path: [(site, PixelShuffle factor, launches a step)]} from
    ``plan.conv_site_counts`` of an f32 session: the conv sites, the deconv
    sites (``deconv4x4``, the deconv mode) and v1's head (``ps`` 2)),
    random inputs from their own seed: one launch of the kernel, held
    against its twin at the f32 bar; per site the kernel's time, the
    twin's, cuDNN's f32 with TF32 off (``full_f32``), the f32 bound and the
    kernel's share; the sums over each step, each site times its launches;
    then the f32 v2.3 step's device time and the conv kernel's part of it
    (``torch.profiler``)."""
    from rife_tpu_torch.ops import conv as CV

    flop_s, mhz, sms = fp32_peak()
    print(f"f32 bound: HBM {HBM_BYTES_S / 1e12:.2f} TB/s, FP32 pipes "
          f"{flop_s / 1e12:.2f} TFLOP/s ({sms} SMs x {FP32_LANES} FMA lanes "
          f"x 2 x {mhz:.0f} MHz, nvidia-smi clocks.max.sm); card {card}",
          flush=True)
    gen = torch.Generator(device=device).manual_seed(F32_SEED)
    rep = report["conv3x3"].setdefault("f32", {})
    for path, sites in paths.items():
        sums = dict.fromkeys(("kernel", "twin", "cudnn", "bound"), 0.0)
        for i, (site, ps, n) in enumerate(sites):
            factor, parts, cout, stride, act, h, w, deconv = site
            kfn, tfn, library = f32_site_fns(device, gen, site, ps)
            CV.reset_launches()
            with count_interleaves() as copies:
                got = kfn()
            torch.cuda.synchronize()
            counter = "conv3x3_ps" if ps > 1 else "conv3x3"
            launched = {k: v for k, v in CV.LAUNCHES.items() if v}
            require(launched == {counter: 1},
                    f"f32 {path} site {i}: {launched}, not one {counter}")
            require(not copies, f"f32 {path} site {i}: interleave_phases ran")
            err = compare(got, tfn(), torch.float32, f32_rel=1e-5)
            del got
            ms = time_ms(kfn, 10)
            twin = time_ms(tfn, 3)
            with CV.full_f32():
                lib = time_ms(library, 10)
            bound = conv_site_bound_f32(factor * BENCH[0], parts, cout, stride,
                                        h, w, deconv, flop_s)
            label = (f"B={factor * BENCH[0]} parts={parts} cout={cout} "
                     f"s{stride} act{act} {h}x{w}"
                     f"{' deconv' if deconv else ''}"
                     f"{f' ps{ps}' if ps > 1 else ''}")
            print(f"conv3x3 f32 {path} site {i} ({label}, {n} launch"
                  f"{'es' if n > 1 else ''} a step): max|d| vs twin "
                  f"{err:.3g}, kernel {ms:.4f} ms, twin {twin:.4f} ms, cuDNN "
                  f"f32 TF32 off {lib:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]}), kernel at {100 * bound[0] / ms:.1f}% of "
                  f"its bound, cuDNN at {100 * bound[0] / lib:.1f}%",
                  flush=True)
            for key, val in (("kernel", ms), ("twin", twin), ("cudnn", lib),
                             ("bound", bound[0])):
                sums[key] += n * val
            rep["max_abs_err"] = max(rep.get("max_abs_err", 0.0), err)
            del kfn, tfn, library
            torch.cuda.empty_cache()
        launches = sum(n for _, _, n in sites)
        print(f"conv3x3 f32 over a {path} 1080p B={BENCH[0]} step ({launches} "
              f"launches at {len(sites)} distinct sites): kernel "
              f"{sums['kernel']:.4f} ms, twin {sums['twin']:.4f} ms, cuDNN "
              f"f32 TF32 off {sums['cudnn']:.4f} ms, bound "
              f"{sums['bound']:.4f} ms, kernel at "
              f"{100 * sums['bound'] / sums['kernel']:.1f}% of the bound; "
              f"card {card}", flush=True)
        rep[path] = {"sites": len(sites), "launches_a_step": launches,
                     "ms": sums["kernel"], "plain_ms": sums["twin"],
                     "library_ms": sums["cudnn"], "bound_ms": sums["bound"]}


def f32_step_device_ms(device, model_dir, report, card):
    """Device time of one f32 v2.3 1080p B=8 step (``torch.profiler``, the
    step after a warm-up): every kernel, and the f32 conv kernel's launches
    (symbols with ``conv3x3``) in it."""
    from torch.profiler import ProfilerActivity, profile

    from rife_tpu_torch import RIFE

    b, h, w = BENCH
    sess = RIFE(str(model_dir), device=device, dtype=torch.float32)
    f0, f1 = smooth_frames(np.random.default_rng(7), b, h, w)
    d0, d1 = (torch.from_numpy(f).to(device) for f in (f0, f1))
    ts = np.full(b, 0.5, np.float32)
    sess.process_batch_device(d0, d1, ts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sess.process_batch_device(d0, d1, ts)
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(e.self_device_time_total for e in events) / 1e3
    conv = [e for e in events if "conv3x3" in e.key]
    conv_ms = sum(e.self_device_time_total for e in conv) / 1e3
    n = sum(e.count for e in conv)
    print(f"f32 v2.3 1080p B={b} step: device time {total:.4f} ms, of it "
          f"the f32 conv kernel {conv_ms:.4f} ms over {n} launches "
          f"({100 * conv_ms / total:.1f}%); card {card}", flush=True)
    report["conv3x3"]["f32"]["v2.3 step_device_ms"] = total
    report["conv3x3"]["f32"]["v2.3 step_conv_ms"] = conv_ms
    del sess
    torch.cuda.empty_cache()


def phase_conv_ps(device, rng, report, sites):
    """B4's conv form, ``conv3x3_ps`` (``csrc/conv_ps.cu``): at each gated
    ``rife.ConvPS`` site of a v1 1080p B=8 step (the fusionnet's head),
    random weights, bf16 and f32: (1) bit for bit against the plain kernel's
    output shuffled by ``F.pixel_shuffle`` (in bf16 the two kernels sum in
    the same tap and channel order; in f32 it is the same kernel), (2)
    against its twin at the conv bar.  bf16 per site: kernel, twin, the
    unfused kernel + ``F.pixel_shuffle``, cuDNN's bf16 conv +
    ``F.pixel_shuffle`` and the bound; then the same checks at the site
    one column narrower and B=2 (an odd width, which TMA cannot stage: the
    kernel's per-thread branch), timed but not tallied.  (B4's deconv form
    is the deconv kernel's: ``phase_deconv``.)"""
    from rife_tpu_torch.ops import conv as CV

    F = torch.nn.functional
    cases = [(site, BENCH[0] * site[0], site[6], False) for site in sites]
    cases += [(site, 2, site[6] - 1, True) for site in sites]
    for dtype in (torch.bfloat16, torch.float32):
        for i, (site, b, w, odd) in enumerate(cases):
            _, parts, cout, stride, act, h, _, _ = site
            if odd and dtype == torch.float32:
                continue
            timed = dtype == torch.bfloat16
            cin = sum(parts)
            x = torch.randn(b, cin, h, w, device=device).to(dtype)
            bias = torch.randn(cout, device=device) * 0.1
            slope = torch.rand(cout, device=device) * 0.3
            weight = (torch.randn(cout, cin, 3, 3, device=device)
                      * (1.0 / (3.0 * cin ** 0.5))).to(dtype)
            packed = CV.pack_weight_tc(weight)

            def kfn(x, wt, bi, sl, ps=2):
                return CV.conv3x3([x], wt, bi, sl, stride=stride, act=act,
                                  weight_tc=packed, ps=ps)

            def tfn(x, wt, bi, sl):
                return CV.conv3x3_ref([x], wt, bi, sl, stride=stride,
                                      act=act, ps=2)
            scale = CV.conv3x3_ref([x.float().abs()], weight.float().abs(),
                                   stride=stride, ps=2)

            def library():
                return F.pixel_shuffle(F.conv2d(
                    x, weight, None, stride=stride, padding=1), 2)
            args = (x, weight, bias, slope)
            fused = kfn(*args)
            unfused = F.pixel_shuffle(kfn(*args, ps=1), 2)
            torch.cuda.synchronize()
            require(torch.equal(fused, unfused),
                    f"conv3x3_ps case {i}: not bit for bit with the plain "
                    f"kernel shuffled")
            bound = conv_site_bound(b, parts, cout, stride, h, w, False)
            geo = CV.ps_geometry(b, cin, cout, h, w, stride)
            label = (f"case {i}: B={b} cin={cin} cout={cout} (x{cout // 4} "
                     f"after the shuffle) s{stride} act{act} {h}x{w} (TMA in "
                     f"{geo.tma_in}, out {geo.tma_out}; tiles of "
                     f"{geo.tile_rows}x{CV.PS_TILE_COLS}, {geo.stages} "
                     f"stages)")
            ms, lib = check_pair(
                report, "conv3x3_ps", kfn, tfn, args, dtype, label, timed,
                f32_rel=1e-5, iters=10, tally=not odd,
                bound=bound if timed else None,
                library=library if timed else None, scale=scale)
            if timed:
                plain = time_ms(lambda: F.pixel_shuffle(kfn(*args, ps=1), 2),
                                10)
                if not odd:
                    report["conv3x3_ps"]["unfused_ms"] = plain
                print(f"  conv3x3_ps {label}: kernel {ms:.4f} ms, unfused "
                      f"kernel + pixel_shuffle {plain:.4f} ms, cuDNN bf16 + "
                      f"pixel_shuffle {lib:.4f} ms, bound {bound[0]:.4f} ms "
                      f"({bound[1]}), kernel at "
                      f"{100 * bound[0] / ms:.1f}% of its bound", flush=True)
            del x, weight, scale, fused, unfused
    torch.cuda.empty_cache()


def deconv_bound(b, cin, co, ps, h, w):
    """(ms, what sets it) of one deconv site: bf16 input, packed weights and
    output once, f32 bias and slope; the 16 x Cin x O multiply-adds of each
    input pixel (4 taps a phase), not the phase conv's zeros."""
    cp = (cin + 15) // 16 * 16
    n_bytes = (2 * b * cin * h * w + 2 * 16 * co * cp + 8 * co
               + 2 * b * co * 4 * h * w)
    return bound_ms(n_bytes, 2.0 * 16 * cin * co * h * w * b)


def phase_deconv(device, rng, report, paths):
    """The deconv kernel (``deconv4x4`` / ``deconv4x4_xla``) at every 4x4
    stride-2 deconv site of the bf16 steps of ``paths`` ({path: (batch,
    sites from ``plan.conv_sites(..., "deconv4x4")``)}), random weights.
    Planar order: against ``deconv_t4_ref`` at the conv bar, and bit for bit
    with the phase conv (``conv3x3`` over the phase weights,
    interleaved, shuffled) wherever that conv's resident weights fit (Cin
    <= 128).  XLA order (it rounds twice): the sums (the kernel without
    bias or activation) against the twin at the conv bar, and the output
    bit for bit with XLA's epilogue on those sums.  Each bf16 site is timed
    beside its twin, its bound and cuDNN's ``conv_transpose2d`` with the
    bias (+ the activation in bf16, + ``pixel_shuffle``), the route it
    replaced; the v4.6 step's sites are the kernel's report.  f32 at the
    planar sites: ``deconv4x4`` on the f32 conv kernel's deconv mode (no
    ``interleave_phases``) against its twin."""
    from rife_tpu_torch.ops import conv as CV

    F = torch.nn.functional
    rep = report.setdefault("deconv4x4", {
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bound_by": None, "library_ms": 0.0, "sites": {}})
    for path, (b, sites) in paths.items():
        sums = [0.0, 0.0, 0.0]
        for i, (factor, parts, co, ps, act, h, w, xla) in enumerate(sites):
            bb = factor * b
            cin = parts[0]
            x = torch.randn(bb, cin, h, w, device=device).to(torch.bfloat16)
            raw = (torch.randn(cin, co, 4, 4, device=device)
                   * (1.0 / (2.0 * cin ** 0.5))).to(torch.bfloat16)
            bias = (torch.randn(co, device=device) * 0.1).to(
                torch.bfloat16).float()
            slope = (torch.rand(co, device=device) * 0.3).to(
                torch.bfloat16).float()
            packed = CV.pack_weight_t4(raw)
            scale = CV.deconv_t4_ref(x.float().abs(), CV.pack_weight_t4(
                raw.float().abs()))
            label = (f"{path} site {i}: B={bb} {cin} -> {co}, ps {ps}, act "
                     f"{act}, {h}x{w}, {'XLA' if xla else 'planar'} order")
            if xla:
                def kfn(x, bias, slope):
                    return CV.deconv4x4_xla(x, packed, bias, slope, act=act,
                                            ps=ps)
                base = CV.deconv4x4_xla(x, packed)
                err = compare(base, CV.deconv_t4_ref(x, packed, xla=True),
                              torch.bfloat16, scale=scale)
                y = CV.activate_storage(
                    base + bias.to(base.dtype).reshape(1, -1, 1, 1), act,
                    float(torch.tensor(0.2, dtype=torch.bfloat16)), slope)
                want = F.pixel_shuffle(y, ps) if ps > 1 else y
                require(torch.equal(kfn(x, bias, slope), want),
                        f"deconv4x4 {label}: XLA's epilogue differs")
            else:
                b4, s4 = bias.repeat(4), slope.repeat(4)

                def kfn(x, bias, slope):
                    return CV.deconv4x4(x, None, bias.repeat(4),
                                        slope.repeat(4), act=act,
                                        weight_t4=packed, ps=ps)
                sc = F.pixel_shuffle(scale, ps) if ps > 1 else scale
                err = compare(kfn(x, bias, slope), CV.deconv_t4_ref(
                    x, packed, bias, slope, act=act, ps=ps), torch.bfloat16,
                    scale=sc)
            if cin <= 128:
                w3 = CV.deconv_phase_weights(raw).contiguous()
                b4, s4 = bias.repeat(4), slope.repeat(4)
                got = CV.deconv4x4(x, w3, b4, s4, act=act, weight_t4=packed,
                                   ps=ps)
                y = CV.interleave_phases(CV.conv3x3(
                    [x], w3, b4, s4, act=act,
                    weight_tc=CV.pack_weight_tc(w3)))
                require(torch.equal(got, F.pixel_shuffle(y, ps) if ps > 1
                                    else y),
                        f"deconv4x4 {label}: differs from the phase conv")
                del w3, got, y
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            bound = deconv_bound(bb, cin, co, ps, h, w)
            raw_b = bias.to(torch.bfloat16)
            slope_b = slope.to(torch.bfloat16)

            def library():
                y = F.conv_transpose2d(x, raw, raw_b, stride=2, padding=1)
                if act:
                    y = CV.activate_storage(y, act, 0.2, slope_b)
                return F.pixel_shuffle(y, ps) if ps > 1 else y
            ms = time_ms(lambda: kfn(x, bias, slope), 10)
            plain = time_ms(lambda: CV.deconv_t4_ref(
                x, packed, bias, slope, act=act, ps=ps, xla=xla), 3)
            lib = time_ms(library, 10)
            print(f"kernel deconv4x4 bf16 {label}: max|d| vs twin {err:.3g}, "
                  f"kernel {ms:.4f} ms, plain twin {plain:.4f} ms, cuDNN "
                  f"conv_transpose2d + bias{' + act' if act else ''}"
                  f"{' + pixel_shuffle' if ps > 1 else ''} {lib:.4f} ms, "
                  f"bound {bound[0]:.4f} ms ({bound[1]}), kernel at "
                  f"{100 * bound[0] / ms:.1f}% of its bound (CUDA events)",
                  flush=True)
            rep["sites"][f"{path} {i}"] = {
                "site": [bb, cin, co, ps, act, h, w, bool(xla)], "ms": ms,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bound[0],
                "bound_by": bound[1]}
            if path == "v4.6":
                rep["ms"] += ms
                rep["plain_ms"] += plain
                rep["bound_ms"] += bound[0]
                rep["bound_by"] = bound[1]
                rep["library_ms"] += lib
            sums[0] += ms
            sums[1] += lib
            sums[2] += bound[0]
            if ((cin,), co, ps, h, w) == DECONV_PS_SITE and bb == 8:
                print(f"  B4 deconv form (v4.6 block tail, 64 -> 24 + "
                      f"PixelShuffle 2 at 272x480, B=8): kernel {ms:.4f} ms "
                      f"(the phase-conv form took 1.0851), cuDNN + "
                      f"pixel_shuffle {lib:.4f} ms, bound {bound[0]:.4f} ms",
                      flush=True)
            del x, raw, packed, scale
        print(f"deconv4x4 over the {len(sites)} deconv sites of a {path} "
              f"step (B={b}): kernel {sums[0]:.4f} ms, cuDNN route "
              f"{sums[1]:.4f} ms, bound {sums[2]:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    # f32 planar sites take the f32 conv kernel's deconv mode
    for path, (b, sites) in paths.items():
        for factor, parts, co, ps, act, h, w, xla in sites:
            if xla:
                continue
            cin = parts[0]
            x = torch.randn(2, cin, h, w, device=device)
            raw = torch.randn(cin, co, 4, 4, device=device) / (2 * cin ** 0.5)
            w3 = CV.deconv_phase_weights(raw).contiguous()
            b4 = (torch.randn(co, device=device) * 0.1).repeat(4)
            CV.reset_launches()
            with count_interleaves() as copies:
                got = CV.deconv4x4(x, w3, b4, None, act=CV.ACT_RELU,
                                   weight_t4=CV.pack_weight_t4(raw), ps=ps)
            want = CV.deconv4x4_ref(x, w3, b4, None, act=CV.ACT_RELU, ps=ps)
            torch.cuda.synchronize()
            require(CV.LAUNCHES["conv3x3" if ps == 1 else "conv3x3_ps"] == 1
                    and CV.LAUNCHES["deconv4x4"] == 0 and not copies,
                    f"f32 deconv site {path}: not the f32 kernel's deconv "
                    f"mode")
            compare(got, want, torch.float32, f32_rel=1e-5)
    print("deconv4x4: f32 planar sites on the f32 kernel's deconv mode "
          "match the twin", flush=True)


def library_epilogue_sites(sess, device):
    """{(output shape, kernel activation code, leaky alpha, has bias, has
    slope): [node names, the first site's bias_q, slope_q]} of the sites of
    one bf16 1080p B=8 step of ``sess`` that launch ``bias_act``, recorded
    from the wrapper's calls (the node from ``torch_ops._library_site``)."""
    from rife_tpu_torch.ops import conv as CV
    from rife_tpu_torch.ops import torch_ops as T

    sites, node = {}, [None]
    real_site, real_kernel = T._library_site, CV.bias_act

    def site(n, *args):
        node[0] = n.name
        return real_site(n, *args)

    def kernel(y, bias=None, slope=None, act=CV.ACT_NONE, alpha=0.2):
        key = (tuple(y.shape), act, alpha, bias is not None,
               slope is not None)
        sites.setdefault(key, [[], bias, slope])[0].append(node[0])
        return real_kernel(y, bias, slope, act, alpha)
    T._library_site, CV.bias_act = site, kernel
    try:
        f0, f1 = smooth_frames(np.random.default_rng(7), *BENCH)
        sess.process_batch_device(torch.from_numpy(f0).to(device),
                                  torch.from_numpy(f1).to(device),
                                  np.full(BENCH[0], 0.5, np.float32))
        torch.cuda.synchronize()
    finally:
        T._library_site, CV.bias_act = real_site, real_kernel
    return sites


def phase_bias_act(device, dirs, report, card):
    """The library conv sites' epilogue kernel (``bias_act``) at each
    distinct site of the bf16 1080p B=8 v4.6 and v2.3 steps, on the site's
    own bias and slope and seeded inputs of its shape: bit for bit with its
    twin ``bias_act_ref`` in bf16 and in f32; in bf16 the device times
    (``torch.profiler``, a call's kernels summed) of the kernel, the twin
    and the eager ops the library route ran there without it (the bias
    ``add_``, then ``torch_ops.apply_activation``: the library time of the
    report), beside the bound (the output read and written once over 3.35
    TB/s); each summed over a step, each site times its launches."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites
    from rife_tpu_torch.ops import conv as CV
    from rife_tpu_torch.ops import torch_ops as T

    common_act = {k: c for c, k in CV.ACT_MAP.items()}
    gen = torch.Generator(device=device).manual_seed(20261018)
    rep = report.setdefault("bias_act", {
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bound_by": "bytes", "library_ms": 0.0})
    for model, mdir in dirs.items():
        sess = RIFE(str(mdir), device=device)
        sites = library_epilogue_sites(sess, device)
        launches = sum(len(names) for names, _, _ in sites.values())
        want = kernel_sites(sess, *BENCH[1:])
        del sess
        require(launches == want.get("bias_act", 0),
                f"{model}: {launches} bias_act calls in a step, the plan "
                f"says {want.get('bias_act', 0)}")
        total = dict.fromkeys(("kernel", "twin", "library", "bound"), 0.0)
        for (shape, act, alpha, _, _), (names, bias, slope) in sites.items():
            y = torch.randn(shape, generator=gen, device=device) * 2
            for dtype in (torch.bfloat16, torch.float32):
                yd = y.to(dtype)
                got = CV.bias_act(yd.clone(), bias, slope, act, alpha)
                ref = CV.bias_act_ref(yd, bias, slope, act, alpha)
                torch.cuda.synchronize()
                ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
                require(torch.equal(got.view(ints), ref.view(ints)),
                        f"bias_act {model} {names[0]} {shape} "
                        f"{str(dtype)[6:]}: differs from its twin")
            yb = y.to(torch.bfloat16)
            yk, ye = yb.clone(), yb.clone()
            b4 = None if bias is None else bias.to(yb.dtype).reshape(
                1, -1, 1, 1)
            s4 = None if slope is None else slope.to(yb.dtype).reshape(
                1, -1, 1, 1)

            def eager():
                t = ye.add_(b4) if b4 is not None else ye
                return T.apply_activation(t, common_act[act], [alpha], s4)
            times = {
                "kernel": device_ms(lambda: CV.bias_act(yk, bias, slope, act,
                                                        alpha),
                                    "bias_act_kernel"),
                "twin": device_ms(lambda: CV.bias_act_ref(yb, bias, slope,
                                                          act, alpha), None),
                "library": device_ms(eager, None),
                "bound": bound_ms(2 * nbytes(yb))[0]}
            for k, v in times.items():
                total[k] += len(names) * v
            where = (f"{names[0]} .. {names[-1]} x{len(names)}"
                     if len(names) > 1 else names[0])
            share = 100 * times["bound"] / times["kernel"]
            print(f"kernel bias_act bf16 {model} {where} {shape} act {act}: "
                  f"bit for bit with its twin (bf16, f32); kernel "
                  f"{times['kernel']:.4f} ms, bound {times['bound']:.4f} ms "
                  f"({share:.1f}%), twin {times['twin']:.4f} ms, eager add_ "
                  f"+ activation {times['library']:.4f} ms (device time)",
                  flush=True)
        print(f"bias_act over a {model} bf16 1080p B=8 step ({launches} "
              f"launches at {len(sites)} distinct sites): kernel "
              f"{total['kernel']:.4f} ms, bound {total['bound']:.4f} ms "
              f"({100 * total['bound'] / total['kernel']:.1f}%), twin "
              f"{total['twin']:.4f} ms, eager ops {total['library']:.4f} ms; "
              f"card {card}", flush=True)
        for k, key in (("kernel", "ms"), ("twin", "plain_ms"),
                       ("library", "library_ms"), ("bound", "bound_ms")):
            rep[key] += total[k]
        torch.cuda.empty_cache()


def assert_u8_close(got, want, what):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    exact = float((diff == 0).mean())
    print(f"{what}: u8 max |d| {int(diff.max())}, exact {exact:.6f}", flush=True)
    require(got.shape == want.shape and got.dtype == np.uint8, f"{what}: shape")
    require(int(diff.max()) <= 1 and exact >= 0.999, f"{what}: tolerance")


def psnr(got, want) -> float:
    mse = float(np.mean((got.astype(np.float64) - want) ** 2))
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def reset_counts():
    from rife_tpu_torch.ops import conv as CV
    from rife_tpu_torch.ops import warp as W

    W.reset_launches()
    CV.reset_launches()


def read_counts():
    from rife_tpu_torch.ops import conv as CV
    from rife_tpu_torch.ops import warp as W

    return {k: v for k, v in {**W.LAUNCHES, **CV.LAUNCHES}.items() if v}


def bench(sess, device, label, card, b=BENCH[0], size=BENCH[1:]):
    """bf16 B=b (default 8) frames of ``size`` (default 1080p) through
    ``process_batch_device`` on device-resident u8 frames; returns (launches
    over the counted steps, first frames, the u8 inputs, frames/s)."""
    h, w = size
    f0, f1 = smooth_frames(np.random.default_rng(7), b, h, w)
    d0 = torch.from_numpy(f0).to(device)
    d1 = torch.from_numpy(f1).to(device)
    ts = np.full(b, 0.5, np.float32)
    out = sess.process_batch_device(d0, d1, ts)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(BENCH_STEPS):
        out = sess.process_batch_device(d0, d1, ts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    res = out.cpu().numpy()
    require(res.shape == (b, h, w, 3) and res.dtype == np.uint8,
            f"output {res.shape} {res.dtype}")
    require(float(res.std()) > 1.0, "constant output frame")
    fps = b * BENCH_STEPS / dt
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"fps: {fps:.3f} frames/s, rife_tpu_torch 2x bf16 {h}x{w} "
          f"B={b} ({BENCH_STEPS} steps, device-resident u8 in/out), {label}; "
          f"card {card}; peak memory {peak:.2f} GiB", flush=True)
    return launches, res, (f0, f1), fps


def phase_v46(device, model_dir, rng, card):
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites
    from rife_tpu_torch.models.v46_arch import LABEL

    # (a) f32 on the card (TF32 is off) against the CPU session
    b, h, w = V46_CHECK
    f0, f1 = smooth_frames(rng, b, h, w)
    ts = np.full(b, 0.5, np.float32)
    want = RIFE(str(model_dir), device="cpu").process_batch(f0, f1, ts)
    got = RIFE(str(model_dir), device=device,
               dtype=torch.float32).process_batch(f0, f1, ts)
    assert_u8_close(got, want, f"v4.6 slice f32 cuda vs cpu {h}x{w}")
    sess = RIFE(str(model_dir), device=device)
    require(sess.dtype == torch.bfloat16, "bf16 is the CUDA default")
    p = psnr(sess.process_batch(f0, f1, ts), want)
    print(f"v4.6 slice bf16 cuda vs f32 cpu {h}x{w}: PSNR {p:.2f} dB",
          flush=True)
    require(p >= 30.0, f"bf16 v4.6 slice PSNR {p:.2f} dB < 30 dB")

    # (b) bf16 1080p B=8 through the main path, launches counted
    launches, _, _, fps = bench(sess, device, f"{LABEL}, plain", card)
    per_step = kernel_sites(sess, BENCH[1], BENCH[2])
    print(f"v4.6 launches over {BENCH_STEPS} steps: {launches}; expected "
          f"per step: {per_step}", flush=True)
    require(per_step == {"warp_ds4_pair": 1, "warp_pair": 2, "warp_render": 1,
                         "deconv4x4": 4, "bias_act": 40}
            and launches == {k: v * BENCH_STEPS for k, v in per_step.items()},
            "v4.6 launch counts differ from plan.kernel_sites")
    del sess
    torch.cuda.empty_cache()
    return launches, fps


def phase_v23(device, model_dir, rng, card, sess):
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites
    from rife_tpu_torch.models.v23_arch import LABEL

    # (a) f32 on the card against the CPU session, at a size whose conv
    # sites reach conv3x3
    b, h, w = V23_CHECK
    f0, f1 = smooth_frames(rng, b, h, w)
    ts = np.full(b, 0.5, np.float32)
    want = RIFE(str(model_dir), device="cpu").process_batch(f0, f1, ts)
    card32 = RIFE(str(model_dir), device=device, dtype=torch.float32)
    reset_counts()
    got = card32.process_batch(f0, f1, ts)
    launches = read_counts()
    expected = kernel_sites(card32, h, w)
    print(f"v2.3 f32 {h}x{w} launches {launches}, expected {expected}",
          flush=True)
    require(launches == expected and launches.get("conv3x3", 0) > 0
            and launches.get("warp_feat", 0) > 0,
            "v2.3 f32 check did not launch the planned kernels")
    assert_u8_close(got, want, f"v2.3 slice f32 cuda vs cpu {h}x{w}")
    del card32
    torch.cuda.empty_cache()

    # (b) bf16 1080p B=8: frames/s, launches, PSNR of the first frames
    # against f32 on the CPU
    launches, res, (f0, f1), fps = bench(sess, device, f"{LABEL}, plain",
                                         card)
    per_step = kernel_sites(sess, BENCH[1], BENCH[2])
    print(f"v2.3 launches over {BENCH_STEPS} steps: {launches}; expected "
          f"per step from the graphs and gates: {per_step}", flush=True)
    require(launches == {k: v * BENCH_STEPS for k, v in per_step.items()},
            "v2.3 launch counts differ from plan.kernel_sites")
    n = V23_PSNR_ITEMS
    want = RIFE(str(model_dir), device="cpu").process_batch(
        f0[:n], f1[:n], np.full(n, 0.5, np.float32))
    p = psnr(res[:n], want)
    print(f"v2.3 slice bf16 cuda vs f32 cpu {BENCH[1]}x{BENCH[2]} "
          f"(first {n} frames of the B={BENCH[0]} step): PSNR {p:.2f} dB",
          flush=True)
    require(p >= 30.0, f"bf16 v2.3 slice PSNR {p:.2f} dB < 30 dB")
    return launches, fps


def check_on_card(name, model_dir, device, rng, shape, **modes):
    """The session with ``modes`` in f32 on the card against the same
    session on the CPU (u8 <= 1, >= 99.9% exact), launches of the card's
    step equal to ``plan.kernel_sites``; returns those launches."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites

    b, h, w = shape
    f0, f1 = smooth_frames(rng, b, h, w)
    ts = np.full(b, 0.5, np.float32)
    t0 = time.perf_counter()
    want = RIFE(str(model_dir), device="cpu", **modes).process_batch(f0, f1,
                                                                      ts)
    print(f"{name}: CPU reference {b}x{h}x{w} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    card32 = RIFE(str(model_dir), device=device, dtype=torch.float32,
                  **modes)
    reset_counts()
    got = card32.process_batch(f0, f1, ts)
    launches = read_counts()
    expected = kernel_sites(card32, h, w)
    print(f"{name} f32 {h}x{w} launches {launches}, expected {expected}",
          flush=True)
    require(launches == expected, f"{name}: launches differ from the plan")
    assert_u8_close(got, want, f"{name} f32 cuda vs cpu {h}x{w}")
    del card32
    torch.cuda.empty_cache()
    return launches


def phase_modes(device, name, model_dir, label, rng, card, check_shape, b,
                expect_per_step=None, **modes):
    """One path with ``modes`` (``fuse_ds2``, TTA): f32 card vs CPU at
    ``check_shape``, then bf16 1080p B=b with its launches counted over the
    bench steps and held to ``plan.kernel_sites`` (and, where given, to
    ``expect_per_step``); returns (launches, frames/s)."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites

    checked = check_on_card(name, model_dir, device, rng, check_shape,
                            **modes)
    require(checked.get("warp_ds2", 0) > 0, f"{name}: K3 not launched")
    if name.startswith("v2.3"):
        require(checked.get("conv3x3", 0) > 0,
                f"{name}: no conv3x3 site at {check_shape}")
    sess = RIFE(str(model_dir), device=device, **modes)
    launches, _, _, fps = bench(sess, device, f"{label}, {name}", card, b)
    per_step = kernel_sites(sess, BENCH[1], BENCH[2])
    print(f"{name} launches over {BENCH_STEPS} steps: {launches}; expected "
          f"per step: {per_step}", flush=True)
    require(launches == {k: v * BENCH_STEPS for k, v in per_step.items()},
            f"{name}: launch counts differ from plan.kernel_sites")
    if expect_per_step is not None:
        require(per_step == expect_per_step,
                f"{name}: per-step launches {per_step}, expected "
                f"{expect_per_step}")
    del sess
    torch.cuda.empty_cache()
    return launches, fps


def phase_uhd_warps(device, rng, report):
    """``warp_feat`` (K2 bf16, K1 f32) at the frame warps of the UHD
    flownet of a 4K B=2 step, whose frames are copies halved to 1088x1920
    and take the float warp (C=3): by a raw flow (timed in bf16 beside its
    bound and ``grid_sample``) and at the ds4 absolute positions of a block
    entry; each against its twin."""
    from rife_tpu_torch.ops import warp as W

    b, h, w = UHD_BENCH
    shape = (b, (h + 31) // 32 * 16, (w + 31) // 32 * 16)
    for dtype in (torch.bfloat16, torch.float32):
        img, flow, _, _, _ = kernel_inputs(rng, shape, dtype, device)
        grid = sample_grid(flow)
        check_pair(report, "warp_feat", W.warp_feat, W.warp_feat_ref,
                   (img, flow), dtype, f"UHD flownet frames B,C,H,W="
                   f"{tuple(img.shape)}", dtype == torch.bfloat16,
                   tally=False, bound=bound_ms(nbytes(img, flow) + nbytes(img)),
                   library=lambda: torch.nn.functional.grid_sample(
                       img, grid, mode="bilinear", padding_mode="border",
                       align_corners=True))
        pos = W.ds4_positions(flow)
        check_pair(report, "warp_feat",
                   lambda i, p: W.warp_feat(i, p, abs_pos=True),
                   lambda i, p: W.warp_feat_ref(i, p, abs_pos=True),
                   (img, pos), dtype, f"UHD flownet ds4 abs_pos B,C,Ho,Wo="
                   f"{(b, 3, *pos.shape[2:])}", False)
        del img, flow, grid, pos
    torch.cuda.empty_cache()


def phase_uhd(device, model_dir, rng, card):
    """v2.3 ``-u``: f32 card vs CPU at UHD_CHECK, then bf16 4K B=2 frames/s,
    launches against ``plan.kernel_sites`` (no u8-origin launch from the
    flownet: its warps are float warps; the fusionnet keeps its two K4
    warps), and the PSNR of the first item against f32 on the CPU."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites
    from rife_tpu_torch.models.v23_arch import LABEL

    name = "v2.3 -u"
    checked = check_on_card(name, model_dir, device, rng, UHD_CHECK,
                            uhd_mode=True)
    require(checked.get("conv3x3", 0) > 0,
            f"{name}: no conv3x3 site at {UHD_CHECK}")
    b, h, w = UHD_BENCH
    sess = RIFE(str(model_dir), device=device, uhd_mode=True)
    launches, res, (f0, f1), fps = bench(sess, device, f"{LABEL}, {name}",
                                         card, b, (h, w))
    per_step = kernel_sites(sess, h, w)
    print(f"{name} launches over {BENCH_STEPS} steps: {launches}; expected "
          f"per step: {per_step}", flush=True)
    require(launches == {k: v * BENCH_STEPS for k, v in per_step.items()},
            f"{name}: launch counts differ from plan.kernel_sites")
    u8_kernels = {"warp_pair", "warp_ds4_pair", "warp_ds2", "warp_render"}
    require(not u8_kernels & set(per_step) and per_step.get("warp_u8") == 2
            and per_step.get("conv3x3", 0) > 0,
            f"{name}: a u8-origin warp planned in the UHD flownet, or no "
            f"conv3x3 site")
    del sess
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = RIFE(str(model_dir), device="cpu", uhd_mode=True).process_batch(
        f0[:1], f1[:1], np.full(1, 0.5, np.float32))
    p = psnr(res[:1], want)
    print(f"{name} bf16 cuda vs f32 cpu {h}x{w} (first item of the B={b} "
          f"step; CPU reference in {time.perf_counter() - t0:.1f} s): PSNR "
          f"{p:.2f} dB", flush=True)
    require(p >= 30.0, f"bf16 {name} PSNR {p:.2f} dB < 30 dB")
    return launches, fps


def phase_v1(device, model_dir, card):
    """v1 ``rife`` plain: (a) f32 on the card against f32 on the CPU on the
    first frame pair of the bench (V1_CHECK, 1080p: the size from which the
    fusionnet's head takes B4), launches equal to ``plan.kernel_sites``,
    ``conv3x3_ps`` among them; (b) bf16 1080p B=8 frames/s, launches per
    step equal to the plan, PSNR of the first item against (a)'s CPU f32,
    at least 30 dB or within V1_BF16_SLACK_DB of the PSNR of the CPU's
    bf16 session on the same item;
    (c) the reconstruction's flow statistics at 1080p (bf16 flownet on the
    bench frames, synthetic weights at the copied scales of ``rife``)."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites
    from rife_tpu_torch.engine.session import pad_to
    from rife_tpu_torch.models.v1_arch import LABEL
    from rife_tpu_torch.ops import frame

    b, h, w = BENCH
    # bench()'s frames: the f32 check runs on its first pair
    f0, f1 = smooth_frames(np.random.default_rng(7), b, h, w)
    one = np.full(V1_CHECK[0], 0.5, np.float32)
    t0 = time.perf_counter()
    want = RIFE(str(model_dir), device="cpu").process_batch(f0[:1], f1[:1],
                                                            one)
    print(f"v1: CPU reference 1x{h}x{w} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    card32 = RIFE(str(model_dir), device=device, dtype=torch.float32)
    reset_counts()
    got = card32.process_batch(f0[:1], f1[:1], one)
    launches = read_counts()
    expected = kernel_sites(card32, h, w)
    print(f"v1 f32 {h}x{w} launches {launches}, expected {expected}",
          flush=True)
    require(launches == expected and launches.get("conv3x3_ps", 0) > 0,
            "v1 f32 check: launches differ from the plan, or no conv3x3_ps")
    assert_u8_close(got, want, f"v1 rife f32 cuda vs cpu {h}x{w}")
    del card32
    torch.cuda.empty_cache()

    sess = RIFE(str(model_dir), device=device)
    launches, res, _, fps = bench(sess, device, f"{LABEL}, rife plain", card)
    per_step = kernel_sites(sess, h, w)
    print(f"v1 launches over {BENCH_STEPS} steps: {launches}; expected per "
          f"step: {per_step}", flush=True)
    require(launches == {k: v * BENCH_STEPS for k, v in per_step.items()}
            and per_step.get("conv3x3_ps") == 1,
            "v1 launch counts differ from plan.kernel_sites")
    # bf16 itself moves this synthetic network far from f32 (its 26 SE gates
    # amplify rounding: PERF.md §6), so the card's bf16 is held to the
    # CPU's bf16 (rife_tpu's bf16 semantics, bit for bit at mini widths on
    # the CPU): no more than V1_BF16_SLACK_DB further from f32
    t0 = time.perf_counter()
    cpu16 = RIFE(str(model_dir), device="cpu",
                 dtype=torch.bfloat16).process_batch(f0[:1], f1[:1], one)
    p, p_cpu = psnr(res[:1], want), psnr(cpu16, want)
    print(f"v1 rife bf16 {h}x{w} (first item of the B={b} step) against f32 "
          f"on the CPU: cuda PSNR {p:.2f} dB, the CPU's bf16 {p_cpu:.2f} dB; "
          f"cuda bf16 against the CPU's bf16 {psnr(res[:1], cpu16):.2f} dB "
          f"(CPU bf16 in {time.perf_counter() - t0:.1f} s); card {card}",
          flush=True)
    require(p >= min(30.0, p_cpu - V1_BF16_SLACK_DB),
            f"bf16 v1 PSNR {p:.2f} dB: below 30 dB and more than "
            f"{V1_BF16_SLACK_DB} dB below the CPU's bf16 ({p_cpu:.2f} dB)")
    with torch.inference_mode():
        ins = [frame.preprocess(torch.from_numpy(f).to(device), pad_to(h),
                                pad_to(w), sess.dtype) for f in (f0, f1)]
        flow = sess.executors["flownet"].run(
            {"input0": ins[0], "input1": ins[1]}, ["flow"],
            {"w": sess.weights["flownet"]})[0].float().abs()
    require(bool(torch.isfinite(flow).all()), "v1 flow not finite")
    print(f"v1 rife flow at {h}x{w} (B={b}, bf16, {tuple(flow.shape)} at "
          f"half resolution, synthetic weights at the calibrated scales of "
          f"'rife'): mean |flow| {float(flow.mean()):.4f} px, max |flow| "
          f"{float(flow.max()):.4f} px", flush=True)
    del sess, flow, ins
    torch.cuda.empty_cache()
    return launches, fps


def moving_frames(rng, n, h, w, step=2):
    """n u8 frames (h,w,3) of one smooth scene panning ``step`` px a frame."""
    base = smooth_field(rng, 1, h + 16, w + 16 + step * n, 3)[0] * 60 + 128
    base += rng.normal(size=base.shape).astype(np.float32) * 8
    base = np.clip(base, 0, 255).astype(np.uint8)
    return [np.ascontiguousarray(base[8:8 + h, step * k:step * k + w])
            for k in range(n)]


def run_cli(argv, what):
    """``rife_tpu_torch.cli.main(argv)`` in this process, every launch
    counter set to 0 just before and read just after; returns (launches,
    wall seconds, the verbose lines on the sessions' build time and the
    runner's stages)."""
    import contextlib
    import io

    from rife_tpu_torch import cli

    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv + ["-v"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    summary = " ".join(ln for ln in out.getvalue().splitlines()
                       if ln.startswith(("sessions:", "pipeline:")))
    require(rc == 0, f"{what}: rife_tpu_torch.cli returned {rc}")
    return launches, dt, summary


def runner_without_codecs(sess, device, frames, dev_fps, card):
    """The runner's proc path alone: RUNNER_TASKS midpoint tasks over
    ``frames`` (in memory: decode and encode replaced by a dict), B=8, the
    pinned side-stream path and the sync path (``process_batch``) in turns
    (pinned, sync, sync, pinned); both must write the same bytes.  Prints
    each run's frames/s beside the device-only figure."""
    from rife_tpu_torch.io import runner as R

    n = len(frames)
    tasks = lambda: [R.Task(id=i, in0_path=str(i % (n - 1)),  # noqa: E731
                            in1_path=str(i % (n - 1) + 1), out_path=str(i),
                            timestep=0.5) for i in range(RUNNER_TASKS)]
    real = R.decode_image, R.encode_image
    outs = {}
    try:
        R.decode_image = lambda path: frames[int(path)]
        for mode in ("pinned", "sync", "sync", "pinned"):
            sink = {}
            R.encode_image = sink.__setitem__
            pinned = mode == "pinned"
            runner = R.PipelineRunner(
                [sess.process_batch], jobs_load=2, jobs_save=8,
                batch_size=CLI_BATCH,
                device_fns=[sess.process_batch_device] if pinned else None,
                devices=[device])
            t0 = time.perf_counter()
            errors = runner.run(tasks())
            dt = time.perf_counter() - t0
            require(not errors and len(sink) == RUNNER_TASKS,
                    f"runner without codecs ({mode}): {errors[:2]}")
            outs.setdefault(mode, sink)
            print(f"runner without codecs, {mode}: {RUNNER_TASKS} frames "
                  f"{CLI_SIZE[0]}x{CLI_SIZE[1]} at B={CLI_BATCH} in {dt:.3f} "
                  f"s, {RUNNER_TASKS / dt:.3f} frames/s (device-only "
                  f"{dev_fps:.3f}); {runner.metrics.summary()}; card {card}",
                  flush=True)
    finally:
        R.decode_image, R.encode_image = real
    require(all(np.array_equal(outs["pinned"][k], outs["sync"][k])
                for k in outs["sync"]),
            "the runner's pinned path differs from its sync path")


def phase_cli(device, v46_dir, v23_dir, rng, card):
    """The CLI (``rife_tpu_torch.cli.main``, bf16 on cuda:0) through the
    runner and the codecs: (a) directory mode, v4.6, CLI_FRAMES frames of
    CLI_SIZE written as PNG by the port's encoder, -j 2:8:<cores, <= 16>:
    every output decodes to the frame size, the copies equal their inputs
    and the midpoints ``RIFE.process_batch`` on the same batches of 8 (the
    tail padded) byte for byte, launches equal the plan times the batches;
    wall frames/s beside the stage summary and the device-only frames/s of
    the same step (``bench``); (b) pair mode, v2.3 at 1080p, equal to
    ``RIFE.process`` byte for byte, launches as the plan says; (c) ``-g
    0,0 -j 1:4,4:2`` over the first CLI_MULTI frames against one session
    at ``-j 1:4:2``, byte for byte.  Returns {path: (launches, fps)}."""
    import os
    import shutil

    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites
    from rife_tpu_torch.io.image import codec_name, decode_image, encode_image
    from rife_tpu_torch.models.v46_arch import LABEL

    codec = codec_name()
    cores = os.cpu_count()
    print(f"cli: codec in use {codec}; os.cpu_count() {cores}", flush=True)
    require(codec != "none", "no image codec on this host")
    work = ROOT / "rife_tpu_torch" / "_build" / "cli"
    shutil.rmtree(work, ignore_errors=True)
    ind, outd = work / "in", work / "out"
    ind.mkdir(parents=True)
    outd.mkdir()
    h, w = CLI_SIZE
    frames = moving_frames(rng, CLI_FRAMES, h, w)
    t0 = time.perf_counter()
    for k, f in enumerate(frames):
        encode_image(ind / f"{k:04d}.png", f)
    print(f"cli: wrote {CLI_FRAMES} {h}x{w} PNGs in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    runs = {}

    # (a) directory mode
    jobs = f"2:{CLI_BATCH}:{min(cores, 16)}"
    launches, dt, summary = run_cli(
        ["-i", str(ind), "-o", str(outd), "-m", str(v46_dir), "-j", jobs],
        "directory mode")
    names = sorted(os.listdir(outd))
    n_out = 2 * CLI_FRAMES
    require(names == [f"{i:08d}.png" for i in range(1, n_out + 1)],
            f"directory mode wrote {len(names)} files, expected {n_out}")
    outs = [decode_image(outd / n) for n in names]
    require(all(o.shape == (h, w, 3) and o.dtype == np.uint8 for o in outs),
            "directory mode: an output of another shape")
    copies = [(2 * k, k) for k in range(CLI_FRAMES)] + [(n_out - 1,
                                                         CLI_FRAMES - 1)]
    require(all(np.array_equal(outs[i], frames[k]) for i, k in copies),
            "directory mode: a t=0/1 output differs from its input frame")
    sess = RIFE(str(v46_dir), device=device)
    mids = CLI_FRAMES - 1
    n_batches = -(-mids // CLI_BATCH)
    t_ref = time.perf_counter()
    for j in range(n_batches):
        idx = list(range(j * CLI_BATCH, min((j + 1) * CLI_BATCH, mids)))
        pad = idx + [idx[-1]] * (CLI_BATCH - len(idx))
        want = sess.process_batch(np.stack([frames[k] for k in pad]),
                                  np.stack([frames[k + 1] for k in pad]),
                                  np.full(CLI_BATCH, 0.5, np.float32))
        for r, k in enumerate(idx):
            require(np.array_equal(outs[2 * k + 1], want[r]),
                    f"directory mode: midpoint {k} differs from "
                    f"RIFE.process_batch")
    print(f"cli (a): the {mids} midpoints equal RIFE.process_batch on the "
          f"same {n_batches} batches of {CLI_BATCH} byte for byte (reference "
          f"in {time.perf_counter() - t_ref:.2f} s)", flush=True)
    per_step = kernel_sites(sess, h, w)
    print(f"cli (a) launches {launches}; expected {n_batches} x {per_step}",
          flush=True)
    require(launches == {k: v * n_batches for k, v in per_step.items()},
            "directory mode: launches differ from plan.kernel_sites")
    _, _, _, dev_fps = bench(sess, device, f"{LABEL}, device-only, the CLI's "
                             f"step", card, CLI_BATCH, CLI_SIZE)
    wall_fps = n_out / dt
    print(f"cli (a) directory mode {LABEL}, {CLI_FRAMES} frames {h}x{w} -> "
          f"{n_out} outputs ({mids} interpolated), -j {jobs}: {dt:.3f} s "
          f"wall, {wall_fps:.3f} output frames/s, {mids / dt:.3f} "
          f"interpolated frames/s; device-only {dev_fps:.3f} frames/s at "
          f"B={CLI_BATCH}; codec {codec}; {cores} cores; card {card}",
          flush=True)
    print(f"cli (a) stages: {summary}", flush=True)
    runs["cli dir v4.6"] = (launches, mids / dt)
    runner_without_codecs(sess, device, frames, dev_fps, card)
    del sess
    torch.cuda.empty_cache()

    # (b) pair mode, v2.3 at 1080p
    pair = work / "pair"
    pair.mkdir()
    f0, f1 = smooth_frames(rng, 1, BENCH[1], BENCH[2])
    encode_image(pair / "a.png", f0[0])
    encode_image(pair / "b.png", f1[0])
    launches, dt, summary = run_cli(
        ["-0", str(pair / "a.png"), "-1", str(pair / "b.png"), "-o",
         str(pair / "out.png"), "-m", str(v23_dir)], "pair mode")
    sess = RIFE(str(v23_dir), device=device)
    want = sess.process(f0[0], f1[0])
    require(np.array_equal(decode_image(pair / "out.png"), want),
            "pair mode: the output differs from RIFE.process")
    per_step = kernel_sites(sess, BENCH[1], BENCH[2])
    print(f"cli (b) pair mode v2.3 {BENCH[1]}x{BENCH[2]}: equal to "
          f"RIFE.process byte for byte; {dt:.3f} s wall; launches "
          f"{launches}, plan {per_step}; stages: {summary}", flush=True)
    require(launches == per_step and all(
        per_step.get(k, 0) > 0 for k in ("warp_feat", "warp_u8", "warp_pair",
                                         "warp_ds4_pair", "conv3x3")),
        "pair mode: launches differ from plan.kernel_sites")
    runs["cli pair v2.3"] = (launches, 1 / dt)
    del sess
    torch.cuda.empty_cache()

    # (c) two sessions on one card over one queue against one session
    few = work / "few"
    few.mkdir()
    for k in range(CLI_MULTI):
        shutil.copy(ind / f"{k:04d}.png", few / f"{k:04d}.png")
    got = {}
    b = CLI_MULTI_BATCH
    for tag, g, j in (("one", "0", f"1:{b}:2"), ("two", "0,0", f"1:{b},{b}:2")):
        o = work / f"multi_{tag}"
        o.mkdir()
        launches, dt, summary = run_cli(
            ["-i", str(few), "-o", str(o), "-m", str(v46_dir), "-g", g,
             "-j", j], f"-g {g}")
        got[tag] = {n: decode_image(o / n) for n in sorted(os.listdir(o))}
        print(f"cli (c) -g {g} -j {j}: {len(got[tag])} outputs in {dt:.3f} "
              f"s; launches {launches}; stages: {summary}", flush=True)
    require(len(got["one"]) == 2 * CLI_MULTI
            and got["one"].keys() == got["two"].keys()
            and all(np.array_equal(got["one"][n], got["two"][n])
                    for n in got["one"]),
            "two sessions on one queue differ from one session")
    runs["cli -g 0,0"] = (launches, (CLI_MULTI - 1) / dt)
    print("cli (c): two sessions equal one byte for byte", flush=True)
    # the rows of B=1/3/4/7 steps against a B=8 step: u8 max |d| <= 1
    # unless the batch witness names a cuDNN conv node whose rows follow B
    # (C15, left open for it); every deconv, hand-kernel and PyTorch node
    # is bit for bit across B (batch_witness)
    sess = RIFE(str(v46_dir), device=device)
    a = np.stack(frames[:CLI_BATCH])
    c = np.stack(frames[1:CLI_BATCH + 1])
    full = sess.process_batch(a, c, np.full(CLI_BATCH, 0.5, np.float32))
    worst = 0
    for n in (1, b - 1, b, CLI_BATCH - 1):
        part = sess.process_batch(a[:n], c[:n], np.full(n, 0.5, np.float32))
        d = np.abs(full[:n].astype(np.int16) - part)
        worst = max(worst, int(d.max()))
        print(f"cli: v4.6 bf16 {h}x{w}, the first {n} rows of a B={n} step "
              f"against a B={CLI_BATCH} step: max |d| {int(d.max())}, exact "
              f"{float((d == 0).mean()):.6f}", flush=True)
        require((d == 0).mean() >= 0.999, f"B={n} rows: exact share")
    witness = batch_witness(f"v4.6 {h}x{w}", sess,
                            [(a[:2], c[:2]), (a[2:4], c[2:4])], device)
    cudnn = witness.get("cuDNN conv", (0, 0, 0.0))[1]
    require(worst <= 1 or cudnn > 0, f"rows of B=1/3/4/7 steps differ from "
            f"B=8 by {worst} and no cuDNN conv node is named")
    if worst > 1:
        print(f"C15 open: rows of B=1/3/4/7 steps against B=8 max |d| "
              f"{worst} > 1, with {cudnn} cuDNN conv node(s) named by the "
              f"batch witness above and no deconv node", flush=True)
    del sess
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return runs


def sharded_warp_kernels(device, rng, report):
    """(d) S, the sharded warp (``warp_spatial``: the kernel computes each
    output row's positions from the shard's raw flow rows and row0, over
    the whole source) at one shard's shape: a quarter of a 1080p frame's
    rows (rows 272-544 of 1088) over the whole source, u8 mode (C=3, the
    height-sharded v4.6 run's B=2) and float mode (C=32 at the 544x960
    level, B=2, a quarter of its rows), bf16 and f32, with and without the
    1/4 taps (ds4): bit for bit with its twin (the positions tensor, the
    single-warp twin at it, ``half_sum2``) and with the unsharded kernel's
    rows.  Timed in bf16 beside its bound (the source rows the positions
    reach read once, the flow rows in their dtype, the output written:
    ``reached_rows``) and the earlier bound (f32 positions in place of the
    flow), the earlier form (the positions built in PyTorch, then the
    single-warp kernel at them) and, for the float mode, ``grid_sample`` on
    the same rows."""
    from rife_tpu_torch.ops import warp as W

    F = torch.nn.functional
    rep = report.setdefault("warp_spatial", {
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bound_by": None, "library_ms": None})
    for mode, u8, (b, c, h, w) in SHARDED_WARPS:
        for dtype in (torch.bfloat16, torch.float32):
            if u8:
                img, flow, _, _, _ = kernel_inputs(rng, (b, h, w), dtype,
                                                   device)
            else:
                img = torch.randn(b, c, h, w, device=device).to(dtype)
                flow = smooth_flow(rng, b, h, w, dtype, device, shift=6.0)
            s, e = h // 4, h // 2
            rows = flow[:, :, s:e].contiguous()
            single = W.warp_u8 if u8 else W.warp_feat
            for ds4 in (False, True):
                got = W.warp_spatial(img, rows, s, u8=u8, ds4=ds4)
                want = W.warp_spatial_ref(img, rows, s, u8=u8, ds4=ds4)
                if ds4:
                    whole = W.half_sum2(single(img, W.ds4_positions(flow),
                                               abs_pos=True))[
                        :, :, s // 4:e // 4]
                else:
                    whole = single(img, flow)[:, :, s:e]
                torch.cuda.synchronize()
                require(torch.equal(got, want) and torch.equal(got, whole),
                        f"warp_spatial {mode} ds4={ds4} {dtype}: differs "
                        f"from its twin or from the unsharded kernel's rows")
            if dtype != torch.bfloat16:
                continue
            pos = torch.stack(W._grid_positions(rows, s), dim=1)
            src_rows = reached_rows(pos, h)
            out_bytes = b * c * (e - s) * w * img.element_size()
            src_bytes = src_rows * c * w * img.element_size()
            bound = bound_ms(src_bytes + nbytes(rows) + out_bytes)
            old_bound = bound_ms(src_bytes + nbytes(pos) + out_bytes)
            ms = time_ms(lambda: W.warp_spatial(img, rows, s, u8=u8))
            plain = time_ms(lambda: W.warp_spatial_ref(img, rows, s, u8=u8),
                            5)
            earlier = time_ms(lambda: single(img, torch.stack(
                W._grid_positions(rows, s), dim=1), abs_pos=True))
            lib = None
            if not u8:
                grid = sample_grid(flow)[:, s:e].contiguous()
                lib = time_ms(lambda: F.grid_sample(
                    img, grid, mode="bilinear", padding_mode="border",
                    align_corners=True))
            kern = device_ms(lambda: W.warp_spatial(img, rows, s, u8=u8),
                             "warp_spatial_kernel")
            ms4 = time_ms(lambda: W.warp_spatial(img, rows, s, u8=u8,
                                                 ds4=True))
            print(f"kernel warp_spatial {mode} bf16 rows {s}-{e} of B,C,H,W="
                  f"{(b, c, h, w)} (the positions reach {src_rows} of the "
                  f"{b * h} source rows): bit for bit with its twin and the "
                  f"unsharded kernel; whole call {ms:.4f} ms, plain twin "
                  f"{plain:.4f} ms, the earlier form (positions in PyTorch, "
                  f"then the single-warp kernel) {earlier:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]}; the earlier bound with f32 "
                  f"positions {old_bound[0]:.4f}); the kernel's device time "
                  f"{kern:.4f} ms (torch.profiler), at "
                  f"{100 * bound[0] / kern:.1f}% of its bound"
                  + (f", grid_sample {lib:.4f} ms" if lib is not None else "")
                  + f"; ds4 {ms4:.4f} ms (CUDA events)", flush=True)
            entry = {"shape": [b, c, e - s, w], "source_rows_read": src_rows,
                     "ms": ms, "plain_ms": plain, "earlier_form_ms": earlier,
                     "kernel_device_ms": kern,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "earlier_bound_ms": old_bound[0], "library_ms": lib,
                     "ds4_ms": ms4}
            rep[mode] = entry
            if u8:  # the v4.6 1x4 run's warps: the kernel's report (no
                # library call computes the u8-origin sampling)
                rep.update(ms=ms, plain_ms=plain, bound_ms=bound[0],
                           bound_by=bound[1], kernel_device_ms=kern)
            del pos
            del img, flow, rows
    torch.cuda.empty_cache()


def reached_rows(pos: torch.Tensor, h: int) -> int:
    """Source rows that absolute positions (B,2,Ho,W) reach, summed over
    the batch: per item, floor(min y) to floor(max y) + 1 (the bilinear
    taps' rows), clamped to the frame's h rows."""
    sy = pos[:, 1].float()
    lo = sy.amin(dim=(1, 2)).floor().clamp(0, h - 1)
    hi = (sy.amax(dim=(1, 2)).floor() + 1).clamp(0, h - 1)
    return int((hi - lo + 1).sum())


def cudnn_rows_probe(device):
    """Whether cuDNN gives a quarter of a frame's rows, convolved on a
    window of them (the shard's rows and its halo), what it gives them in
    the whole frame: per shape of the sharded paths, the share of values
    that differ (bf16, and f32 with TF32 off), with
    ``torch.backends.cudnn.deterministic`` off (the port's setting) and on;
    the v4.6 block tail's transposed conv (64 -> 24 at 272x480) too.
    Prints only: it says what cuDNN does to a window of rows, which the
    port's deconv sites no longer meet in bf16."""
    F = torch.nn.functional
    g = torch.Generator().manual_seed(0)
    prev = torch.backends.cudnn.deterministic
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            for dtype in (torch.bfloat16, torch.float32):
                for b, c, h, w, st in ((2, 64, 272, 480, 1),
                                       (2, 192, 136, 240, 1),
                                       (2, 128, 272, 480, 2),
                                       (2, 16, 1088, 1920, 1),
                                       (2, 96, 68, 120, 1),
                                       (2, 64, 272, 480, -2)):
                    x = torch.randn(b, c, h, w, generator=g).to(device, dtype)
                    q = h // 4
                    if st > 0:
                        wt = (torch.randn(c, c, 3, 3, generator=g)
                              / (3 * c ** 0.5)).to(device, dtype)
                        full = F.conv2d(x, wt, None, stride=st, padding=1)
                        win = F.conv2d(x[:, :, q - 2:2 * q + 1], wt, None,
                                       stride=st, padding=1)
                        d = (full[:, :, q // st:2 * q // st].float()
                             - win[:, :, 2 // st:2 // st + q // st]
                             .float()).abs()
                        kind = f"conv s{st}"
                    else:  # 4x4 stride-2 transposed conv: a row of halo
                        wt = (torch.randn(c, 24, 4, 4, generator=g)
                              / (2 * c ** 0.5)).to(device, dtype)
                        full = F.conv_transpose2d(x, wt, None, stride=2,
                                                  padding=1)
                        win = F.conv_transpose2d(x[:, :, q - 1:2 * q + 1],
                                                 wt, None, stride=2,
                                                 padding=1)
                        d = (full[:, :, 2 * q:4 * q].float()
                             - win[:, :, 2:2 * q + 2].float()).abs()
                        kind = "conv_transpose 4x4 s2"
                    print(f"cuDNN {str(dtype)[6:]} {kind} B,C,H,W="
                          f"{(b, c, h, w)}, deterministic={det}: rows "
                          f"{q}-{2 * q} on a window against the whole frame: "
                          f"{float((d > 0).float().mean()):.6f} of values "
                          f"differ, max |d| {float(d.max()):.3g}", flush=True)
                    del x, wt, full, win, d
    finally:
        torch.backends.cudnn.deterministic = prev
    torch.cuda.empty_cache()


class _Recorder:
    """An executor that keeps the first run of its net (inputs, outputs,
    ctx) and runs it."""

    def __init__(self, ex, calls, net):
        self._ex, self._calls, self._net = ex, calls, net

    def __getattr__(self, name):
        return getattr(self._ex, name)

    def run(self, inputs, outputs, ctx=None):
        self._calls.setdefault(self._net, (dict(inputs), list(outputs), ctx))
        return self._ex.run(inputs, outputs, ctx)


CONV_KINDS = ("Convolution", "ConvolutionCat", "rife.ConvPS",
              "Deconvolution", "rife.DeconvPS")
DECONV_KINDS = ("Deconvolution", "rife.DeconvPS")


def node_route(node, hand) -> str:
    """A node's route for the witnesses: the deconv kernel, another hand
    kernel, a cuDNN conv, the pooling (f32 partial sums per shard by
    design), or other (PyTorch elementwise, resize, concat, the SE
    vectors).  A cuDNN conv stays one with its epilogue kernel
    (``bias_act``), which rounds nothing the library did not."""
    if node.type in DECONV_KINDS:
        return "deconv kernel" if hand.get("deconv4x4") else "cuDNN deconv"
    hand = {k: n for k, n in hand.items() if k != "bias_act"}
    return ("hand kernel" if hand else
            "cuDNN conv" if node.type in CONV_KINDS else
            "pooling" if node.type == "Pooling" else "other")


def report_witness(what, tally, first):
    print(f"{what}: " + "; ".join(
        f"{r}: {n} nodes, {k} differ (max |d| {m:.3g})"
        for r, (n, k, m) in sorted(tally.items()))
        + f"; first difference per net: {first or 'none'}", flush=True)
    for route in ("deconv kernel", "hand kernel", "other", "cuDNN deconv"):
        require(tally.get(route, [0, 0])[1] == 0 and (
            route != "cuDNN deconv" or not tally.get(route)),
                f"{what}: a {route} node differs, or a deconv ran on cuDNN")


def node_witness(path, plain, sharded, f0, f1, ts, device):
    """Where a height-sharded bf16 step starts to differ from the
    unsharded one: each net's first run in a step of ``plain`` is kept,
    then node by node the node is run unsharded and over ``sharded``'s
    first mesh row on the same inputs (the unsharded run's blobs), so each
    node is compared on its own.  Nodes are sorted by route: a hand kernel
    launched (``conv3x3``, ``conv3x3_ps``, a warp), a cuDNN conv, the
    pooling (f32 partial sums per shard by design), or other (PyTorch
    elementwise, resize, concat, the SE vectors).  Fails unless every
    hand-kernel node and every other node is bit for bit.  Returns
    {route: (nodes, nodes that differ, max |d|)}."""
    calls = {}
    recs = {net: _Recorder(ex, calls, net)
            for net, ex in plain.executors.items()}
    tally = {}
    first = {}
    with torch.inference_mode():
        plain.forward(plain.frames_on(f0, device),
                      plain.frames_on(f1, device),
                      plain.timesteps_of(f0, f1, ts), recs, plain.weights)
        for net, (inputs, outputs, ctx) in calls.items():
            ex, sp = plain.executors[net], sharded.executors[0][net]
            # both sides emit NCHW (the sharded render has no planar form)
            ctx = {k: v for k, v in (ctx or {}).items()
                   if k != "planar_outputs"}
            tall = {k: v for k, v in inputs.items()
                    if isinstance(v, torch.Tensor) and v.dim() == 4}
            blobs = dict(inputs)
            for idx in ex.graph.required_nodes(outputs, list(inputs)):
                node = ex.graph.nodes[idx]
                if node.type == "Input" or all(t in blobs
                                               for t in node.tops):
                    continue
                feed = {**tall, **{b: blobs[b] for b in node.bottoms}}
                reset_counts()
                want = ex.run(feed, node.tops, ctx)
                hand = read_counts()
                got = sp.run(feed, node.tops, ctx)
                blobs.update(zip(node.tops, want))
                route = node_route(node, hand)
                d = max(float((a.float() - b.float()).abs().max())
                        if a.shape == b.shape else float("inf")
                        for a, b in zip(want, got))
                t = tally.setdefault(route, [0, 0, 0.0])
                t[0] += 1
                if d > 0:
                    t[1] += 1
                    t[2] = max(t[2], d)
                    first.setdefault(net, f"{node.type} {node.name} "
                                          f"({route}, max |d| {d:.3g})")
            del blobs
    torch.cuda.empty_cache()
    report_witness(f"sharded (c) {path} node by node (bf16, each node on the "
                   f"unsharded run's inputs)", tally, first)
    return {r: tuple(t) for r, t in tally.items()}


def batch_witness(path, sess, pairs, device):
    """Which nodes' rows depend on the step's B: each net's first run in a
    B=2 step of ``pairs[0]`` (two pairs) and of ``pairs[1]`` (two others)
    is kept, then node by node the node is run on the first run's inputs
    (B=2) and on both runs' inputs concatenated (B=4), and the B=4 run's
    first two rows are held to the B=2 run's.  Routes as ``node_witness``;
    fails unless every deconv, hand-kernel and other node is bit for bit.
    Returns {route: (nodes, nodes that differ, max |d|)}."""
    runs = []
    for f0, f1 in pairs:
        calls = {}
        recs = {net: _Recorder(ex, calls, net)
                for net, ex in sess.executors.items()}
        ts = np.full(len(f0), 0.5, np.float32)
        with torch.inference_mode():
            sess.forward(sess.frames_on(f0, device),
                         sess.frames_on(f1, device),
                         sess.timesteps_of(f0, f1, ts), recs, sess.weights)
        runs.append(calls)
    tally, first = {}, {}
    def cat(a, b):
        return torch.cat([a, b]) if isinstance(a, torch.Tensor) else a
    with torch.inference_mode():
        for net, (inputs, outputs, ctx) in runs[0].items():
            ex = sess.executors[net]
            other = runs[1][net][0]
            ctx = ctx or {}
            tall = {k: v for k, v in inputs.items()
                    if isinstance(v, torch.Tensor) and v.dim() == 4}
            tall4 = {k: cat(v, other[k]) for k, v in tall.items()}
            blobs, blobs_b = dict(inputs), dict(other)
            for idx in ex.graph.required_nodes(outputs, list(inputs)):
                node = ex.graph.nodes[idx]
                if node.type == "Input" or all(t in blobs
                                               for t in node.tops):
                    continue
                feed = {**tall, **{b: blobs[b] for b in node.bottoms}}
                feed_b = {**{k: v for k, v in other.items() if k in tall},
                          **{b: blobs_b[b] for b in node.bottoms}}
                reset_counts()
                want = ex.run(feed, node.tops, ctx)
                hand = read_counts()
                got_b = ex.run(feed_b, node.tops, ctx)
                feed4 = {**tall4, **{b: cat(blobs[b], blobs_b[b])
                                     for b in node.bottoms}}
                got = ex.run(feed4, node.tops, ctx)
                blobs.update(zip(node.tops, want))
                blobs_b.update(zip(node.tops, got_b))
                route = node_route(node, hand)
                d = max(float((a.float() - g[:a.shape[0]].float()).abs().max())
                        if isinstance(a, torch.Tensor) else 0.0
                        for a, g in zip(want, got))
                t = tally.setdefault(route, [0, 0, 0.0])
                t[0] += 1
                if d > 0:
                    t[1] += 1
                    t[2] = max(t[2], d)
                    first.setdefault(net, f"{node.type} {node.name} "
                                          f"({route}, max |d| {d:.3g})")
            del blobs, blobs_b
    torch.cuda.empty_cache()
    report_witness(f"batch witness {path} node by node (bf16, each node of a "
                   f"B=2 step again inside a B=4 step)", tally, first)
    return {r: tuple(t) for r, t in tally.items()}


def step_ms(fn, steps=3) -> float:
    """Host ms of one synchronised step, after one warm-up step."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def phase_sharded(device, v46_dir, v23_dir, v1_dir, rng, report, card):
    """``parallel/sharding.py`` on the card (bf16): (a) batch sharding over
    ``make_mesh()``, every visible card, v4.6 1080p B=8 equal to
    ``RIFE.process_batch_device`` byte for byte; (b) over [cuda:0, cuda:0]
    at B=8 equal to a session at B=4 per shard; (c) height sharding over
    four shards of cuda:0 against the unsharded session at the shard
    batch, >= 99.9% exact: v4.6 1080p B=2, v2.3 -u 2160x3840 B=1, v1 1080p
    B=1, v4.6 on a 2x2 mesh at B=4, each in bf16 (u8 max |d| <= 1 unless
    ``node_witness``, run on every case, names a cuDNN conv node that
    differs, then PSNR above SHARDED_BF16_PSNR_DB) and in f32 (u8 max |d|
    <= 1; ``cudnn_rows_probe`` shows what cuDNN does to a window of rows);
    (d) the sharded warp against its twin (``sharded_warp_kernels``); (e)
    ``-g all`` in directory mode equal to
    ``-g 0`` at the same -j; (f) each sharded
    step's time beside the unsharded step's on the card, with the halo and
    all-gather bytes of a step.  Every run counts its launches (set to 0
    just before, read just after) and holds them to
    ``ShardedRIFE.kernel_sites``.  Returns {path: (launches, frames/s)}."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.graph import spatial as SP
    from rife_tpu_torch.parallel.sharding import (ShardedRIFE, make_mesh,
                                                  make_mesh_2d)

    sharded_warp_kernels(device, rng, report)
    cudnn_rows_probe(device)
    runs = {}
    sessions = {}

    def session(mdir, **modes):
        key = (str(mdir), tuple(sorted(modes.items())))
        if key not in sessions:
            sessions[key] = RIFE(str(mdir), device=device, **modes)
        return sessions[key]

    def counted(path, sharded, f0, f1, ts):
        h, w = f0.shape[1], f0.shape[2]
        reset_counts()
        SP.reset_traffic()
        out = sharded.process_batch(f0, f1, ts)
        launches = read_counts()
        traffic = dict(SP.TRAFFIC)
        want = sharded.kernel_sites(h, w)
        print(f"sharded {path}: launches {launches}, plan {want}; per step "
              f"halo {traffic['halo']} B, all-gather {traffic['gather']} B",
              flush=True)
        require(launches == want, f"sharded {path}: launches differ from "
                f"the plan (ShardedRIFE.kernel_sites)")
        return out, launches

    def timed(path, sharded, plain, f0, f1, ts, per):
        d0, d1 = (torch.from_numpy(f).to(device) for f in (f0, f1))
        b = len(f0)
        t_sh = step_ms(lambda: sharded.process_batch_device(d0, d1, ts))
        t_pl = step_ms(lambda: [plain.process_batch_device(
            d0[i:i + per], d1[i:i + per], ts[i:i + per])
            for i in range(0, b, per)])
        print(f"sharded {path} step: {t_sh:.3f} ms sharded, {t_pl:.3f} ms "
              f"unsharded at B={per} x {b // per} on the same card (host "
              f"clock, synchronised); card {card}", flush=True)
        return b / t_sh * 1e3

    # (a) every visible card, batch axis only
    sess = session(v46_dir)
    b, h, w = BENCH
    f0, f1 = smooth_frames(np.random.default_rng(7), b, h, w)
    ts = np.full(b, 0.5, np.float32)
    mesh = make_mesh()
    sharded = ShardedRIFE(sess, mesh)
    out, launches = counted("batch make_mesh v4.6", sharded, f0, f1, ts)
    n = len(mesh.devices)
    want = np.concatenate([sess.process_batch_device(
        f0[i:i + b // n], f1[i:i + b // n], ts[i:i + b // n]).cpu().numpy()
        for i in range(0, b, b // n)])
    require(np.array_equal(out, want), "batch sharding over make_mesh() "
            "differs from the session")
    print(f"sharded (a) batch over {n} card(s), v4.6 {h}x{w} B={b}: equal to "
          f"RIFE.process_batch_device byte for byte", flush=True)
    runs["sharded batch make_mesh v4.6"] = (launches, timed(
        "batch make_mesh v4.6", sharded, sess, f0, f1, ts, b // n))

    # (b) one card named twice
    sharded = ShardedRIFE(sess, make_mesh([device, device]))
    out, launches = counted("batch 2x cuda:0 v4.6", sharded, f0, f1, ts)
    want = np.concatenate([sess.process_batch(f0[i:i + 4], f1[i:i + 4],
                                              ts[i:i + 4]) for i in (0, 4)])
    require(np.array_equal(out, want), "batch sharding over [cuda:0, "
            "cuda:0] differs from a session at B=4")
    print("sharded (b) batch over [cuda:0, cuda:0] B=8: equal to a session "
          "at B=4 per shard byte for byte", flush=True)
    runs["sharded batch 2x cuda:0 v4.6"] = (launches, timed(
        "batch 2x cuda:0 v4.6", sharded, sess, f0, f1, ts, 4))

    # (c) height sharding on four shards of cuda:0
    dirs = {"v4.6": v46_dir, "v2.3": v23_dir, "v1": v1_dir}
    bars = {}
    for path, model, modes, (nd, ns), (b, h, w) in SHARDED_CASES:
        plain = session(dirs[model], **modes)
        f0, f1 = smooth_frames(rng, b, h, w)
        ts = np.full(b, 0.5, np.float32)
        sharded = ShardedRIFE(plain, make_mesh_2d(nd, ns, [device] * 4),
                              height_axis="spatial")
        out, launches = counted(path, sharded, f0, f1, ts)
        per = b // nd

        def unsharded(sess, n=per):
            return np.concatenate([sess.process_batch(
                f0[i:i + n], f1[i:i + n], ts[i:i + n])
                for i in range(0, b, n)])

        want = unsharded(plain)
        # the same session's rows at another B, for scale
        other = np.concatenate([f0[:per]] * 2), np.concatenate([f1[:per]] * 2)
        rows_b = plain.process_batch(*other, np.full(2 * per, 0.5,
                                                     np.float32))[:per]
        d = np.abs(rows_b.astype(np.int16) - want[:per])
        print(f"sharded (c) {path}: the unsharded session's rows at B="
              f"{2 * per} against B={per}: u8 max |d| {int(d.max())}, exact "
              f"{float((d == 0).mean()):.6f}", flush=True)
        what = (f"sharded (c) {path} {h}x{w} B={b} vs the unsharded session "
                f"at B={per} (bf16 on the card)")
        d = np.abs(out.astype(np.int16) - want)
        exact, p = float((d == 0).mean()), psnr(out, want)
        print(f"{what}: u8 max |d| {int(d.max())}, exact {exact:.6f}, PSNR "
              f"{p:.2f} dB", flush=True)
        witness = node_witness(path, plain, sharded, f0[:per], f1[:per],
                               ts[:per], device)
        cudnn = witness.get("cuDNN conv", (0, 0, 0.0))[1]
        require(out.shape == want.shape and exact >= 0.999
                and p > SHARDED_BF16_PSNR_DB
                and (int(d.max()) <= 1 or cudnn > 0), f"{what}: tolerance")
        bars[path] = (int(d.max()), exact, cudnn)
        if int(d.max()) > 1:
            print(f"C15 open: {what} u8 max |d| {int(d.max())} > 1, with "
                  f"{cudnn} cuDNN conv node(s) named by the witness above and "
                  f"no deconv node", flush=True)
        runs[f"sharded {path}"] = (launches, timed(path, sharded, plain, f0,
                                                   f1, ts, per))
        del sharded
        card32 = RIFE(str(dirs[model]), device=device, dtype=torch.float32,
                      **modes)
        got32 = ShardedRIFE(card32, make_mesh_2d(nd, ns, [device] * 4),
                            height_axis="spatial").process_batch(f0, f1, ts)
        assert_u8_close(got32, unsharded(card32),
                        f"sharded (c) {path} {h}x{w} B={b} vs the unsharded "
                        f"session at B={per} (f32 on the card, TF32 off)")
        del card32, got32
        torch.cuda.empty_cache()
    sessions.clear()
    torch.cuda.empty_cache()
    print(f"sharded (c) bf16 bar, u8 max |d| <= 1 (max |d|, exact, cuDNN conv "
          f"nodes that differ): {bars}", flush=True)
    runs.update(cli_g_all(v46_dir, rng, card))
    return runs


def cli_g_all(v46_dir, rng, card):
    """(e) ``-g all`` (one ShardedRIFE over every visible card, -j proc per
    card) in directory mode against ``-g 0`` at the same -j, byte for
    byte."""
    import os
    import shutil

    from rife_tpu_torch.io.image import decode_image, encode_image

    work = ROOT / "rife_tpu_torch" / "_build" / "cli_g_all"
    shutil.rmtree(work, ignore_errors=True)
    ind = work / "in"
    ind.mkdir(parents=True)
    for k, f in enumerate(moving_frames(rng, CLI_MULTI, *CLI_SIZE)):
        encode_image(ind / f"{k:04d}.png", f)
    got, runs = {}, {}
    jobs = f"1:{CLI_MULTI_BATCH}:2"
    for g in ("all", "0"):
        o = work / f"out_{g}"
        o.mkdir()
        launches, dt, summary = run_cli(
            ["-i", str(ind), "-o", str(o), "-m", str(v46_dir), "-g", g,
             "-j", jobs], f"-g {g}")
        got[g] = {n: decode_image(o / n) for n in sorted(os.listdir(o))}
        print(f"sharded (e) cli -g {g} -j {jobs}: {len(got[g])} outputs in "
              f"{dt:.3f} s; launches {launches}; stages: {summary}; card "
              f"{card}", flush=True)
        runs[f"cli -g {g}"] = (launches, (CLI_MULTI - 1) / dt)
    require(len(got["all"]) == 2 * CLI_MULTI
            and got["all"].keys() == got["0"].keys()
            and all(np.array_equal(got["all"][k], got["0"][k])
                    for k in got["all"]),
            "-g all differs from -g 0")
    print("sharded (e): -g all equals -g 0 byte for byte", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return {"cli -g all": runs["cli -g all"]}


def kernel_symbol(name: str) -> str:
    """A trace kernel event's function name: its demangled name without
    the argument list, the template arguments, the namespaces and the
    return type."""
    for opener, closer in (("(", ")"), ("<", ">")):
        name = name.rstrip()
        if not name.endswith(closer):
            continue
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {closer: 1, opener: -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.rsplit("::", 1)[-1].rsplit(" ", 1)[-1]


def phase_profiling(device, v46_dir, card):
    """``utils/profiling.trace`` around 3 steps of the plain v4.6 bf16 1080p
    B=8 session: the trace holds CUDA kernel events, and each hand kernel
    of the step, by its CUDA symbol, launches ``plan.kernel_sites`` x 3
    times; returns (the launch counters of the traced steps, None)."""
    import shutil

    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites
    from rife_tpu_torch.utils.profiling import trace

    b, h, w = BENCH
    sess = RIFE(str(v46_dir), device=device)
    f0, f1 = smooth_frames(np.random.default_rng(7), b, h, w)
    d0 = torch.from_numpy(f0).to(device)
    d1 = torch.from_numpy(f1).to(device)
    ts = np.full(b, 0.5, np.float32)
    sess.process_batch_device(d0, d1, ts)  # warm-up
    torch.cuda.synchronize()
    logdir = ROOT / "rife_tpu_torch" / "_build" / "trace"
    shutil.rmtree(logdir, ignore_errors=True)
    reset_counts()
    with trace(str(logdir)):
        for _ in range(TRACE_STEPS):
            sess.process_batch_device(d0, d1, ts)
    launches = read_counts()
    files = sorted(logdir.glob("*.pt.trace.json"))
    require(len(files) == 1, f"trace files under {logdir}: {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    require(bool(kernels), "the trace holds no CUDA kernel event")
    per_step = kernel_sites(sess, h, w)
    require(launches == {k: v * TRACE_STEPS for k, v in per_step.items()},
            f"traced launches {launches} differ from the plan {per_step}")
    require(set(per_step) <= set(KERNEL_SYMBOLS),
            f"no CUDA symbol for {set(per_step) - set(KERNEL_SYMBOLS)}")
    want = {}
    for counter, n in per_step.items():
        sym = KERNEL_SYMBOLS[counter]
        want[sym] = want.get(sym, 0) + n * TRACE_STEPS
    print(f"trace {files[0].name}: {len(events)} events, {len(kernels)} "
          f"CUDA kernels over {TRACE_STEPS} steps of v4.6 bf16 "
          f"{h}x{w} B={b}; card {card}", flush=True)
    for sym, n in want.items():
        hits = [e for e in kernels if kernel_symbol(e["name"]) == sym]
        ms = sum(float(e["dur"]) for e in hits) / 1e3
        print(f"trace kernel {sym}: {len(hits)} launches (plan {n}), "
              f"{ms:.4f} ms device time over {TRACE_STEPS} steps; card "
              f"{card}", flush=True)
        require(len(hits) == n, f"trace: {sym} launched {len(hits)} times, "
                f"the plan says {n}")
    del sess
    torch.cuda.empty_cache()
    shutil.rmtree(logdir, ignore_errors=True)
    return launches, None


def cal_frames(rng, h, w):
    """Smooth synthetic frames as the calibration takes them: (1,H,W,3)
    float32 in [0, 1]."""
    return tuple(f.astype(np.float32) / 255.0 for f in smooth_frames(rng, 1,
                                                                     h, w))


def phase_calibrate(device, dirs, card):
    """``models/calibrate.py`` on the card at ``TEST_HW`` for each
    reconstruction in ``dirs`` (written under its zoo name): the flow std at
    the baked scale, the bisection's scale and std, the fusionnet sweep's
    (the calibration's findings, printed, not held to a bar); then, on the
    same frames at the baked scales, the raw flownet's flow tap and the f32
    fusionnet step on the card against the CPU element by element, and the
    stds at ``CAL_SMALL``.  Returns (the launch counters of the element-wise
    card runs, None)."""
    from rife_tpu_torch.engine.session import pad_to
    from rife_tpu_torch.graph.weights import SYNTHETIC_FLOWNET_SCALE
    from rife_tpu_torch.models import calibrate as cal

    rng = np.random.default_rng(CAL_SEED)
    h, w = cal.TEST_HW
    frames = cal_frames(rng, h, w)
    step_frames = cal_frames(rng, pad_to(BENCH[1]), BENCH[2])
    for mdir in dirs:
        name = mdir.name
        flow_eval = cal.make_flownet_eval(str(mdir), frames, device)
        baked = SYNTHETIC_FLOWNET_SCALE[name]
        at_baked = flow_eval(baked)
        scale, std = cal.search_flownet_scale(flow_eval)
        line = (f"calibrate {name} at {h}x{w} (smooth synthetic frames from "
                f"numpy seed {CAL_SEED}): flownet baked {baked} -> flow std "
                f"{at_baked:.4f} px; found {scale} -> {std:.4f} px (target "
                f"{cal.TARGET_FLOW_STD}), at an edge of {cal.SEARCH_RANGE}: "
                f"{cal.at_search_edge(scale)}")
        at_step = cal.make_flownet_eval(str(mdir), step_frames,
                                        device)(baked)
        line += (f"; at {pad_to(BENCH[1])}x{BENCH[2]} (a 1080p step's "
                 f"padded frames) baked -> {at_step:.4f} px")
        results = [at_baked, scale, std, at_step]
        fus_eval, fus_baked = cal.make_fusionnet_eval(str(mdir), frames,
                                                      device)
        if fus_eval is not None:
            out_baked = fus_eval(1.0)
            fine, out_std = cal.search_fusionnet_scale(fus_eval)
            line += (f"; fusionnet baked {fus_baked} -> u8 std "
                     f"{out_baked:.4f}; found {round(fus_baked * fine, 4)} "
                     f"-> {out_std:.4f} (target {cal.TARGET_OUT_STD})")
            results += [out_baked, fine, out_std]
        print(f"{line}; card {card}", flush=True)
        require(all(np.isfinite(v) and v > 0 for v in results),
                f"calibrate {name}: {results}")

    def taps(mdir, dev):
        flow = cal.make_flownet_tap(str(mdir), frames, dev)(
            SYNTHETIC_FLOWNET_SCALE[mdir.name]).cpu()
        step = cal.make_fusionnet_step(str(mdir), frames, dev)[0]
        return flow, None if step is None else step(1.0).cpu()

    reset_counts()
    on_card = {mdir: taps(mdir, device) for mdir in dirs}
    torch.cuda.synchronize()
    launches = read_counts()
    for mdir in dirs:
        (flow, out), (want_flow, want_out) = on_card[mdir], taps(mdir, "cpu")
        require(flow.shape == want_flow.shape
                and bool(torch.isfinite(flow).all()),
                f"calibrate {mdir.name}: flow tap {tuple(flow.shape)} "
                f"against {tuple(want_flow.shape)}")
        d_flow = float((flow - want_flow).abs().max())
        line = (f"calibrate {mdir.name} {h}x{w} cuda vs cpu element by "
                f"element at {SYNTHETIC_FLOWNET_SCALE[mdir.name]}: flow tap "
                f"{tuple(flow.shape)} max |d| {d_flow:.3e} px (max |flow| "
                f"{float(want_flow.abs().max()):.4f})")
        bad = d_flow > CAL_TAP_ABS
        if out is not None:
            require(out.shape == want_out.shape,
                    f"calibrate {mdir.name}: u8 frame {tuple(out.shape)} "
                    f"against {tuple(want_out.shape)}")
            d_u8 = (out.int() - want_out.int()).abs()
            exact = float((d_u8 == 0).double().mean())
            line += (f", u8 frame {tuple(out.shape)} max |d| "
                     f"{int(d_u8.max())}, exact {exact:.6f}")
            bad |= int(d_u8.max()) > CAL_U8_ABS or exact < CAL_U8_EXACT
        print(f"{line}; card {card}", flush=True)
        require(not bad, f"{line}: beyond {CAL_TAP_ABS} px, or u8 beyond "
                f"{CAL_U8_ABS} or under {CAL_U8_EXACT} exact")

    small = cal_frames(rng, *CAL_SMALL)
    for mdir in dirs:
        s = SYNTHETIC_FLOWNET_SCALE[mdir.name]
        got, want = (cal.make_flownet_eval(str(mdir), small, dev)(s)
                     for dev in (device, "cpu"))
        line = (f"calibrate {mdir.name} {CAL_SMALL[0]}x{CAL_SMALL[1]} cuda "
                f"vs cpu: flow std {got:.6g} / {want:.6g} at {s}")
        require(abs(got - want) <= CAL_FLOW_REL * want,
                f"{line}: beyond {CAL_FLOW_REL} relative")
        fus = [cal.make_fusionnet_eval(str(mdir), small, dev)[0]
               for dev in (device, "cpu")]
        if fus[0] is not None:
            got, want = (f(1.0) for f in fus)
            line += f", u8 output std {got:.4f} / {want:.4f}"
            require(abs(got - want) <= CAL_OUT_ABS,
                    f"{line}: beyond {CAL_OUT_ABS}")
        print(line, flush=True)
    return launches, None


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import (conv_site_counts, conv_sites,
                                            kernel_sites)
    from rife_tpu_torch.models import v23_arch, v46_arch
    from rife_tpu_torch.models.v1_arch import write_v1_params
    from rife_tpu_torch.models.v23_arch import write_v23_params
    from rife_tpu_torch.models.v46_arch import write_flownet_param
    from rife_tpu_torch.native import build
    from rife_tpu_torch.utils.profiling import WallTimer

    device = torch.device("cuda", 0)
    # f32 checks hold the card to f32: cuDNN convs default to TF32 on Hopper
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    timer = WallTimer()
    with timer.section("build"):
        log = build.compile_library()
        build.load()
    print(f"built {build.LIB_PATH.relative_to(ROOT)} from "
          f"{build.SRC_DIR.relative_to(ROOT)} in "
          f"{timer.totals['build']:.1f} s", flush=True)
    kernel = ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1]
        elif "registers" in ln or "spill" in ln:
            print(f"  ptxas {kernel}: {ln.split(':', 1)[-1].strip()}",
                  flush=True)

    models = ROOT / "rife_tpu_torch" / "_build" / "models"
    with timer.section("setup"):
        v46_dir = write_flownet_param(models)
        v23_dir = write_v23_params(models)
        v23 = RIFE(str(v23_dir), device=device)
        require(v23.dtype == torch.bfloat16, "bf16 is the CUDA default")
        sites = conv_sites(v23, BENCH[1], BENCH[2])
    print(f"v2.3 conv3x3 sites at {BENCH[1]}x{BENCH[2]} (batch factor, "
          f"parts, cout, stride, act, H, W, deconv): {sites}", flush=True)

    rng = np.random.default_rng(20261016)
    torch.manual_seed(20261016)
    report = {}
    with timer.section("phase_pair_kernels"):
        phase_pair_kernels(device, rng, report)
    with timer.section("phase_sigmoid"):
        phase_sigmoid(device, rng)
    with timer.section("phase_warp_ds2"):
        phase_warp_ds2(device, rng, report)
    with timer.section("phase_single_warp"):
        phase_single_warp(device, rng, report)
    with timer.section("phase_uhd_warps"):
        phase_uhd_warps(device, rng, report)
    with timer.section("phase_conv"):
        phase_conv(device, rng, report, sites)
    with timer.section("setup"):
        v1_dir = write_v1_params(models)
        ps_sites = conv_sites(RIFE(str(v1_dir), device="cpu"), BENCH[1],
                              BENCH[2], "conv3x3_ps")
    print(f"v1 conv3x3_ps sites at {BENCH[1]}x{BENCH[2]}: {ps_sites}",
          flush=True)
    require(ps_sites, "no conv3x3_ps site in the v1 step")
    with timer.section("phase_conv_ps"):
        phase_conv_ps(device, rng, report, ps_sites)
    f32_paths = {}
    with timer.section("setup"):
        for path, mdir in (("v2.3", v23_dir), ("v1", v1_dir)):
            sess = RIFE(str(mdir), device=device, dtype=torch.float32)
            f32_paths[path] = [
                (site, 2 if kind == "conv3x3_ps" else 1, n)
                for kind in ("conv3x3", "conv3x3_ps")
                for site, n in conv_site_counts(sess, BENCH[1], BENCH[2],
                                                kind)]
            per_step = kernel_sites(sess, BENCH[1], BENCH[2])
            for kind, ps in (("conv3x3", 1), ("conv3x3_ps", 2)):
                got = sum(n for _, p, n in f32_paths[path] if p == ps)
                require(got == per_step.get(kind, 0),
                        f"f32 {path}: {got} {kind} launches at its sites, "
                        f"the plan says {per_step.get(kind, 0)}")
            del sess
    print(f"f32 conv3x3 sites at {BENCH[1]}x{BENCH[2]} ((batch factor, "
          f"parts, cout, stride, act, H, W, deconv), PixelShuffle, launches "
          f"a step): {f32_paths}", flush=True)
    with timer.section("phase_conv_f32"):
        phase_conv_f32(device, report, f32_paths, card)
        f32_step_device_ms(device, v23_dir, report, card)
    deconv_paths = {}
    with timer.section("setup"):
        for path, mdir, modes, (b, h, w) in (
                ("v4.6", v46_dir, {}, BENCH), ("v2.3", v23_dir, {}, BENCH),
                ("v1", v1_dir, {}, BENCH),
                ("v2.3 -u", v23_dir, {"uhd_mode": True}, UHD_BENCH)):
            sess = RIFE(str(mdir), device=device, **modes)
            deconv_paths[path] = (b, conv_sites(sess, h, w, "deconv4x4"))
            del sess
    print(f"deconv4x4 sites of the bf16 steps (batch factor, (cin,), O, ps, "
          f"act, H, W, XLA order): {deconv_paths}", flush=True)
    require(all(sites for _, sites in deconv_paths.values()),
            "a bf16 step with no deconv4x4 site")
    with timer.section("phase_deconv"):
        phase_deconv(device, rng, report, deconv_paths)
    with timer.section("phase_bias_act"):
        phase_bias_act(device, {"v4.6": v46_dir, "v2.3": v23_dir}, report,
                       card)
    with timer.section("phase_v46"):
        runs = {"v4.6": phase_v46(device, v46_dir, rng, card)}
    with timer.section("phase_v23"):
        runs["v2.3"] = phase_v23(device, v23_dir, rng, card, v23)
    del v23
    torch.cuda.empty_cache()
    fused = {"fuse_ds2": True}
    tta = {"tta_mode": True, "tta_temporal_mode": True, **fused}
    for model, mdir, label, check in (
            ("v4.6", v46_dir, v46_arch.LABEL, V46_CHECK),
            ("v2.3", v23_dir, v23_arch.LABEL, V23_CHECK)):
        name = f"{model} fuse_ds2"
        with timer.section("phase_modes"):
            runs[name] = phase_modes(device, name, mdir, label, rng, card,
                                     check, BENCH[0], FUSED_PER_STEP[model],
                                     **fused)
        print(f"{model} bf16 1080p B={BENCH[0]}: fuse_ds2 "
              f"{runs[name][1]:.3f} frames/s, unfused {runs[model][1]:.3f} "
              f"frames/s; card {card}", flush=True)
        name = f"{model} -x -z fuse_ds2"
        with timer.section("phase_modes"):
            runs[name] = phase_modes(device, name, mdir, label, rng, card,
                                     TTA_CHECK, TTA_BATCH, **tta)
    with timer.section("phase_uhd"):
        runs["v2.3 -u"] = phase_uhd(device, v23_dir, rng, card)
    print(f"v2.3 bf16 4K -u B={UHD_BENCH[0]}: {runs['v2.3 -u'][1]:.3f} "
          f"frames/s; card {card}", flush=True)
    with timer.section("phase_v1"):
        runs["v1"] = phase_v1(device, v1_dir, card)
    print(f"v1 rife bf16 1080p B={BENCH[0]}: {runs['v1'][1]:.3f} frames/s; "
          f"card {card}", flush=True)
    with timer.section("phase_v1_modes"):
        runs["v1 -x -z"] = (check_on_card("v1 -x -z", v1_dir, device, rng,
                                          TTA_CHECK, tta_mode=True,
                                          tta_temporal_mode=True), None)
        runs["v1 -u"] = (check_on_card("v1 -u", v1_dir, device, rng,
                                       UHD_CHECK, uhd_mode=True), None)
    with timer.section("phase_cli"):
        runs.update(phase_cli(device, v46_dir, v23_dir, rng, card))
    with timer.section("phase_sharded"):
        runs.update(phase_sharded(device, v46_dir, v23_dir, v1_dir, rng,
                                  report, card))
    with timer.section("phase_profiling"):
        runs["v4.6 traced"] = phase_profiling(device, v46_dir, card)
    with timer.section("phase_calibrate"):
        runs["calibrate"] = phase_calibrate(device,
                                            (v46_dir, v23_dir, v1_dir), card)
    by_path = {path: launches for path, (launches, _) in runs.items()}

    kernels = []
    for name, (src, replaces, covers) in KERNELS.items():
        counts = {path: c.get(name, 0) for path, c in by_path.items()}
        require(sum(counts.values()) > 0, f"{name} never launched")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"rife_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "also_replaces": covers,
            "launches": sum(counts.values()),
            "launches_by_path": counts,
            **report[name],
        })
    print(f"wall seconds by phase (WallTimer; card {card}): "
          + "; ".join(timer.report().splitlines()), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
