"""The warp kernels of two checkouts, timed in turns on one card.

Imports the ``rife_tpu_torch`` package of each checkout under a name of its
own (each builds its kernels from its own ``csrc`` into its own ``_build``)
and calls each one's ``ops/warp.py`` wrappers on the same inputs at the
shapes of one 1080p B=8 step, in the order old, new, new, old (CUDA events;
bf16 unless noted):

* K5 ``warp_pair``, K6 ``warp_render``, K7 ``warp_ds4_pair`` and K3
  ``warp_ds2`` at B=8 and B=2 1088x1920; K4 ``warp_u8`` at B=8;
* K2 ``warp_feat`` at the v2.3 contextnet's four feature warps (B=16,
  C=32..256) and K1 (f32) at the same shapes, each level and their sum.

The two checkouts' outputs must be equal bit for bit.  Every time is printed
beside its bound (each input byte read once and each output byte written
once, over 3.35 TB/s) and written, with the card's name and power limit, to
``--out``; both checkouts' gathering, render, ds4 and ds2 (K3) kernels'
registers and spills are printed from the compiler's report.

Run from the repository root on one GPU, e.g. against the parent commit
unpacked (``git archive``) into a directory that .gitignore lists:
    python tools/warp_ab.py --old <checkout> [--new <checkout>] [--out PATH]
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
STEP = (8, 1088, 1920)
PAIR_B2 = (2, 1088, 1920)
# the v2.3 contextnet's feature warps of a 1080p B=8 step: (C, H, W), B=16
FEAT_SHAPES = [(32, 272, 480), (64, 136, 240), (128, 68, 120), (256, 34, 60)]


def load_package(root: Path, name: str):
    """``root/rife_tpu_torch`` imported as the package ``name``."""
    pkg = root / "rife_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(n_bytes) -> float:
    return n_bytes / HBM_BYTES_S * 1e3


def smooth(gen, b, c, h, w) -> torch.Tensor:
    """(B,C,H,W) f32 smooth random field: a 6x10 grid upsampled."""
    coarse = torch.randn(b, c, 6, 10, generator=gen, device=gen.device)
    return torch.nn.functional.interpolate(coarse, size=(h, w),
                                           mode="bilinear",
                                           align_corners=False)


def flow(gen, b, h, w, dtype, shift) -> torch.Tensor:
    """Smooth flow plus noise whose top rows leave the frame."""
    f = smooth(gen, b, 2, h, w) * 12
    f += torch.randn(f.shape, generator=gen, device=gen.device) * 0.7
    f[:, :, : h // 10] += shift
    return f.to(dtype).contiguous()


def pair_inputs(gen, shape, dtype):
    """Two u8-valued frames (/255), flows that leave the frame, a mask."""
    b, h, w = shape
    imgs = [torch.randint(0, 256, (b, 3, h, w), generator=gen,
                          device=gen.device).float().div_(255).to(dtype)
            for _ in range(2)]
    flows = [flow(gen, b, h, w, dtype, s) for s in (25.0, -25.0)]
    mask = torch.sigmoid(smooth(gen, b, 1, h, w)[:, 0] * 3).to(dtype)
    return imgs[0], flows[0], imgs[1], flows[1], mask


def same(a, b) -> bool:
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def abba(label, old, new, args, bound, rows):
    """old, new, new, old; records the four times, returns both means."""
    if not same(old(*args), new(*args)):
        raise SystemExit(f"{label}: the two checkouts' outputs differ")
    t = [time_ms(lambda f=f: f(*args)) for f in (old, new, new, old)]
    o, n = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    rows.append({"case": label, "old_ms": t[0], "new_ms": t[1],
                 "new_ms_2": t[2], "old_ms_2": t[3], "bound_ms": bound})
    print(f"A/B {label}: old {t[0]:.4f} new {t[1]:.4f} new {t[2]:.4f} old "
          f"{t[3]:.4f} ms -> old {o:.4f}, new {n:.4f} ({o / n:.2f}x), bound "
          f"{bound:.4f} ms, new at {100 * bound / n:.1f}% of it", flush=True)
    return o, n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True,
                    help="root of the older checkout")
    ap.add_argument("--new", type=Path, default=ROOT,
                    help="root of the newer checkout (default: this one)")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "rife_tpu_torch" / "_build" / "warp_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    load_package(args.old.resolve(), "old_rife")
    load_package(args.new.resolve(), "new_rife")
    old = importlib.import_module("old_rife.ops.warp")
    new = importlib.import_module("new_rife.ops.warp")
    for which in ("old", "new"):
        kernel = ""
        report = importlib.import_module(
            f"{which}_rife.native.build").compile_library()
        for ln in report.splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1]
            elif any(k in kernel for k in ("gather", "render", "ds4_pair",
                                           "ds2")) and (
                    "registers" in ln or (
                        "spill" in ln and "0 bytes spill stores" not in ln)):
                print(f"ptxas {which} {kernel}: "
                      f"{ln.split(':', 1)[-1].strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(20261016)
    rows = []
    bf = torch.bfloat16

    for shape in (STEP, PAIR_B2):
        ia, fa, ib, fb, m = pair_inputs(gen, shape, bf)
        tag = f"B={shape[0]} {shape[1]}x{shape[2]}"
        cases = [
            ("warp_pair", (ia, fa, ib, fb),
             nbytes(ia, fa, ib, fb) + 2 * nbytes(ia)),
            ("warp_render", (ia, fa, ib, fb, m),
             nbytes(ia, fa, ib, fb, m) + nbytes(ia)),
            ("warp_ds4_pair", (ia, fa, ib, fb),
             (nbytes(ia, fa, ib, fb) + nbytes(ia) // 2) / 4),
            ("warp_ds2", (ia, fa), nbytes(ia, fa) + nbytes(ia) / 4)]
        if shape == STEP:
            cases.append(("warp_u8", (ia, fa), nbytes(ia, fa) + nbytes(ia)))
        for name, operands, n_bytes in cases:
            abba(f"{name} {tag}", getattr(old, name), getattr(new, name),
                 operands, bound_ms(n_bytes), rows)
        del ia, fa, ib, fb, m, cases
        torch.cuda.empty_cache()

    b2 = 2 * STEP[0]
    for dtype in (bf, torch.float32):
        sums = [0.0, 0.0, 0.0]
        for c, h, w in FEAT_SHAPES:
            img = (torch.randn(b2, c, h, w, generator=gen, device="cuda") * 2
                   ).to(dtype)
            fl = flow(gen, b2, h, w, dtype, 6.0)
            bound = bound_ms(nbytes(img, fl) + nbytes(img))
            o, n = abba(f"warp_feat {str(dtype)[6:]} B,C,H,W={(b2, c, h, w)}",
                        old.warp_feat, new.warp_feat, (img, fl), bound, rows)
            for k, v in enumerate((o, n, bound)):
                sums[k] += v
            del img, fl
        print(f"warp_feat {str(dtype)[6:]} four levels summed: old "
              f"{sums[0]:.4f} ms, new {sums[1]:.4f} ms, bound {sums[2]:.4f} "
              f"ms", flush=True)
        torch.cuda.empty_cache()

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "ab": rows}, indent=1))
    print(f"wrote {args.out}; card {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
