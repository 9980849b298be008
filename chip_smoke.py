#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

Drives ``rife_tpu_torch`` on one card, through the entry points a user calls
(``RIFE(...).process_batch`` / ``process_batch_device``), on the
v4.6-architecture graph (in-repo reconstruction, synthetic weights) at its
full width:

1. prints the card (nvidia-smi name, power limit) and the torch/CUDA versions;
2. builds the CUDA warp kernels from ``rife_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch twin on the card at the main
   path's shapes (B=2 at 1088x1920, plus an unaligned shape) in bf16 and f32,
   and times both with CUDA events;
4. runs the slice: (a) f32 on the card (TF32 off) against the same session on
   the CPU at 256x448, u8 max |d| <= 1 and >= 99.9% exact; (b) bf16 1080p at
   B=8 on smooth synthetic frames, with every launch counter set to 0 just
   before and read just after, which must show 1 ds4-pair, 2 pair and
   1 render launch per step;
5. prints the kernels' JSON line, the nvidia-smi line and, last, the
   ``{"ok": true, "device": ...}`` line.

Any failed check raises and exits non-zero before the last line.  Without a
card, or without the rest of the repository beside it, it exits non-zero.

Run from the repository root: ``python3 chip_smoke.py``
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MAIN_SHAPE = (2, 1088, 1920)
ODD_SHAPE = (2, 52, 196)
SLICE_CHECK = (1, 256, 448)
BENCH = (8, 1080, 1920)
BENCH_STEPS = 5
PAIR_SRC = "rife_tpu/ops/warp_pallas.py"
KERNELS = {
    # name: (wrapper, twin, replaced TPU kernel, launches per step)
    "warp_ds4_pair": ("warp_ds4_pair", "warp_ds4_pair_ref",
                      f"{PAIR_SRC}:1662", 1),
    "warp_pair": ("warp_pair", "warp_pair_ref", f"{PAIR_SRC}:1274", 2),
    "warp_render": ("warp_render", "warp_render_ref", f"{PAIR_SRC}:1304", 1),
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


def kernel_inputs(rng, shape, dtype, device):
    """NCHW images (u8/255 as preprocess makes them), flows that leave the
    frame, and a mask, in ``dtype`` on ``device``."""
    from rife_tpu_torch.ops import frame

    b, h, w = shape
    f0, f1 = smooth_frames(rng, b, h, w)
    imgs = [frame.preprocess(torch.from_numpy(f).to(device), h, w, dtype)
            for f in (f0, f1)]
    flows = []
    for k in range(2):
        f = smooth_field(rng, b, h, w, 2) * 12
        f += rng.normal(size=f.shape).astype(np.float32) * 0.7
        f[:, : h // 10] += 25.0 * (1 - 2 * k)
        flows.append(torch.from_numpy(f).permute(0, 3, 1, 2).to(
            device=device, dtype=dtype).contiguous())
    mask = torch.sigmoid(torch.from_numpy(smooth_field(rng, b, h, w, 1)[..., 0])
                         * 3).to(device=device, dtype=dtype)
    return imgs[0], flows[0], imgs[1], flows[1], mask


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def compare(got, want, dtype) -> float:
    """Tolerance of tests/test_torch_warp.py; returns max |d|."""
    g, r = got.float(), want.float()
    require(g.shape == r.shape, f"shape {tuple(g.shape)} vs {tuple(r.shape)}")
    require(bool(torch.isfinite(g).all()), "non-finite kernel output")
    diff = (g - r).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        require(err <= 2e-6, f"f32 max |d| {err} > 2e-6")
    else:
        require(bool((diff <= bf16_ulp(r)).all()), f"bf16 |d| {err} > 1 ulp")
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


def phase_kernels(device, rng):
    """Each kernel against its twin on the card; times at MAIN_SHAPE, bf16."""
    from rife_tpu_torch.ops import warp as W

    report = {n: {"max_abs_err": 0.0} for n in KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (MAIN_SHAPE, ODD_SHAPE):
            ia, fa, ib, fb, m = kernel_inputs(rng, shape, dtype, device)
            args = {"warp_pair": (ia, fa, ib, fb),
                    "warp_ds4_pair": (ia, fa, ib, fb),
                    "warp_render": (ia, fa, ib, fb, m)}
            for name, (wrap, twin, _, _) in KERNELS.items():
                kfn, tfn = getattr(W, wrap), getattr(W, twin)
                got, want = kfn(*args[name]), tfn(*args[name])
                torch.cuda.synchronize()
                if isinstance(got, torch.Tensor):
                    got, want = (got,), (want,)
                err = max(compare(g, r, dtype) for g, r in zip(got, want))
                rep = report[name]
                rep["max_abs_err"] = max(rep["max_abs_err"], err)
                line = (f"kernel {name} {str(dtype)[6:]} B,H,W={shape}: "
                        f"max|d| vs twin {err:.3g}")
                if shape == MAIN_SHAPE and dtype == torch.bfloat16:
                    rep["ms"] = time_ms(lambda: kfn(*args[name]))
                    rep["plain_ms"] = time_ms(lambda: tfn(*args[name]), 5)
                    line += (f", kernel {rep['ms']:.4f} ms, plain twin "
                             f"{rep['plain_ms']:.4f} ms (CUDA events)")
                print(line, flush=True)
            del ia, fa, ib, fb, m, args
    torch.cuda.empty_cache()
    return report


def assert_u8_close(got, want, what):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    exact = float((diff == 0).mean())
    print(f"{what}: u8 max |d| {int(diff.max())}, exact {exact:.6f}", flush=True)
    require(got.shape == want.shape and got.dtype == np.uint8, f"{what}: shape")
    require(int(diff.max()) <= 1 and exact >= 0.999, f"{what}: tolerance")


def phase_slice(device, model_dir, rng, card):
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.models.v46_arch import LABEL
    from rife_tpu_torch.ops import warp as W

    # (a) f32 on the card (TF32 is off) against the CPU session
    b, h, w = SLICE_CHECK
    f0, f1 = smooth_frames(rng, b, h, w)
    ts = np.full(b, 0.5, np.float32)
    want = RIFE(str(model_dir), device="cpu").process_batch(f0, f1, ts)
    got = RIFE(str(model_dir), device=device,
               dtype=torch.float32).process_batch(f0, f1, ts)
    assert_u8_close(got, want, f"slice f32 cuda vs cpu {h}x{w}")
    sess = RIFE(str(model_dir), device=device)
    require(sess.dtype == torch.bfloat16, "bf16 is the CUDA default")
    low = sess.process_batch(f0, f1, ts)
    mse = float(np.mean((low.astype(np.float64) - want) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    print(f"slice bf16 cuda vs f32 cpu {h}x{w}: PSNR {psnr:.2f} dB", flush=True)
    require(psnr >= 30.0, f"bf16 slice PSNR {psnr:.2f} dB < 30 dB")

    # (b) bf16 1080p B=8 through the main path, launches counted
    b, h, w = BENCH
    f0, f1 = smooth_frames(rng, b, h, w)
    d0 = torch.from_numpy(f0).to(device)
    d1 = torch.from_numpy(f1).to(device)
    ts = np.full(b, 0.5, np.float32)
    out = sess.process_batch_device(d0, d1, ts)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    W.reset_launches()
    t0 = time.perf_counter()
    for _ in range(BENCH_STEPS):
        out = sess.process_batch_device(d0, d1, ts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(W.LAUNCHES)
    print(f"launches over {BENCH_STEPS} steps: {launches}", flush=True)
    for name, (_, _, _, per_step) in KERNELS.items():
        require(launches[name] == per_step * BENCH_STEPS,
                f"{name} launched {launches[name]} times, expected "
                f"{per_step * BENCH_STEPS}")
    res = out.cpu().numpy()
    require(res.shape == (b, h, w, 3) and res.dtype == np.uint8,
            f"output {res.shape} {res.dtype}")
    require(float(res.std()) > 1.0, "constant output frame")
    fps = b * BENCH_STEPS / dt
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"fps: {fps:.3f} frames/s, rife_tpu_torch plain 2x bf16 "
          f"{h}x{w} B={b} ({BENCH_STEPS} steps, device-resident u8 in/out), "
          f"{LABEL}; card {card}; peak memory {peak:.2f} GiB", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from rife_tpu_torch.models.v46_arch import write_flownet_param
    from rife_tpu_torch.native import build

    device = torch.device("cuda", 0)
    # f32 checks hold the card to f32: cuDNN convs default to TF32 on Hopper
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    log = build.compile_library()
    build.load()
    print(f"built {build.LIB_PATH.relative_to(ROOT)} from "
          f"{build.SRC_DIR.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  ptxas: {ln.strip()}", flush=True)

    rng = np.random.default_rng(20261016)
    report = phase_kernels(device, rng)
    model_dir = write_flownet_param(ROOT / "rife_tpu_torch" / "_build" / "models")
    launches = phase_slice(device, model_dir, rng, card)

    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "rife_tpu_torch/csrc/warp.cu",
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": report[name]["max_abs_err"],
        "ms": report[name]["ms"],
        "plain_ms": report[name]["plain_ms"],
    } for name, (_, _, replaces, _) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
