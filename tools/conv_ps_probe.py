"""What bounds B4's conv kernel: variants of ``csrc/conv_ps.cu`` with one part
switched off (or put back as an earlier form), each timed at the v1 head.

Each variant is the kernel's source with a few text replacements, built by
its own ``nvcc`` into a directory under ``rife_tpu_torch/_build`` (all
started together) and called through its C function on the same inputs: 16
-> 16, 544x960, B=8, bf16, no activation, the geometry of ``ops/conv.py
ps_geometry``.  Each is timed with CUDA events (30 launches after 3, twice)
in a process of its own with a time limit, so a variant that faults or
hangs costs only itself.  Variants (their outputs are not checked; they
time the work that is left):

* ``base``: the kernel as it is;
* ``no_transpose``, ``no_mma``, ``no_out`` (no output stores), ``no_in`` (no
  input loads: the producer only arrives);
* ``only_io`` (no transpose, no MMAs), ``only_in``, ``only_out``;
* ``skeleton`` (the stage ring alone), ``skeleton_epilogue`` (the ring and
  the epilogue's arithmetic, nothing loaded or stored);
* ``branchy_epilogue``: the epilogue's bias and activation as branches per
  element, the form the kernel had before it selected.

Run from the repository root on one GPU:
    python tools/conv_ps_probe.py [--out PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "rife_tpu_torch" / "csrc" / "conv_ps.cu"
SHAPE = (8, 16, 16, 544, 960)  # B, Cin, Cout, H, W

TRANSPOSE = ("transpose_row<S, NT>(stages + s * Tl::kStage, tb, row, rg, cg, "
             "lane);", ";")
MMA = ("for (int rr = 0; rr < Tl::kWin; ++rr) {",
       "for (int rr = 0; rr < 0; ++rr) {")
OUT = [("if ((n >> 2) < c4)", "if (a.cout < 0)"),
       ("if (oy < 2 * a.ho && ox < 2 * a.wo) tma_store",
        "if (a.cout < 0) tma_store")]
IN = [("            tma_load(smem_u32(st + rr * kRawRow), &in_map, full, "
       "x0 - 8, y0 - 1 + rr,\n                     chunk * kChunk, b);", ";"),
      ("mbar_expect_tx(full, Tl::kStage);", "mbar_arrive(full);")]
FENCES = [('asm volatile("fence.proxy.async.shared::cta;" ::: "memory");',
           ";"),
          ('asm volatile("cp.async.bulk.commit_group;" ::: "memory");', ";"),
          ('asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");',
           ";")]
NO_EPILOGUE = [("if (chunk != per_tile - 1) continue;", "continue;")]
BRANCHY = [("""              u = has_bias ? __fadd_rn(u, eb[j][e]) : u;
              const float lin = u >= 0.0f ? u : __fmul_rn(u, ek[j][e]);
              v[e] = relu ? fmaxf(u, 0.0f) : lin;""",
            """              if (has_bias) u = __fadd_rn(u, eb[j][e]);
              if (a.act == kRelu) {
                u = fmaxf(u, 0.0f);
              } else if (a.act != kNone) {
                u = u >= 0.0f ? u : __fmul_rn(u, ek[j][e]);
              }
              v[e] = u;""")]
VARIANTS = {
    "base": [],
    "no_transpose": [TRANSPOSE],
    "no_mma": [MMA],
    "no_out": OUT,
    "no_in": IN,
    "only_io": [TRANSPOSE, MMA],
    "only_in": [TRANSPOSE, MMA] + OUT,
    "only_out": [TRANSPOSE, MMA] + IN,
    "skeleton": [TRANSPOSE, MMA] + IN + NO_EPILOGUE,
    "skeleton_epilogue": [TRANSPOSE, MMA] + IN + OUT + FENCES,
    "branchy_epilogue": BRANCHY,
}


def build(build_dir: Path) -> dict:
    """Write and compile every variant (one nvcc each, in parallel);
    returns {name: library path}."""
    src = SRC.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the kernel no longer has {old!r}")
            text = text.replace(old, new)
        cu = build_dir / f"conv_ps_{name}.cu"
        cu.write_text(text)
        lib = build_dir / f"conv_ps_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", "-gencode",
             "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", str(lib), str(cu)],
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{err[-2000:]}")
        libs[name] = lib
    return libs


def time_one(lib_path: str) -> list:
    """Two CUDA-event timings (ms a launch) of one variant's library."""
    import torch

    sys.path.insert(0, str(ROOT))
    from rife_tpu_torch.ops import conv as CV

    lib = ctypes.CDLL(lib_path)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rife_conv3x3_ps.argtypes = ([vp, i, vp, i] + [vp] * 3 + [i] * 6
                                    + [ctypes.c_float] + [i] * 4 + [vp])
    b, cin, cout, h, w = SHAPE
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, cin, h, w, generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn(cout, cin, 3, 3, generator=g) * 0.2).to(
        dev, torch.bfloat16)
    bias = torch.randn(cout, generator=g).to(dev)
    packed = CV.pack_weight_tc(wt)
    geo = CV.ps_geometry(b, cin, cout, h, w, 1)
    out = torch.empty(b, cout // 4, 2 * h, 2 * w, device=dev,
                      dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.rife_conv3x3_ps(
            x.data_ptr(), cin, packed.data_ptr(), packed.shape[2],
            bias.data_ptr(), None, out.data_ptr(), b, h, w, cout, 1, 0,
            ctypes.c_float(0.2), geo.tile_rows, geo.stages, int(geo.tma_in),
            int(geo.tma_out), stream)
        if rc:
            raise SystemExit(f"launch failed: {rc}")

    times = []
    for _ in range(2):
        for _ in range(3):
            run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(30):
            run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 30)
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    ap.add_argument("--time-one")
    args = ap.parse_args()
    if args.time_one:
        print(json.dumps(time_one(args.time_one)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    rec = {"card": card, "shape (B, Cin, Cout, H, W)": SHAPE, "ms": {}}
    build_root = ROOT / "rife_tpu_torch" / "_build"
    build_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as tmp:
        libs = build(Path(tmp))
        for name, lib in libs.items():
            try:
                proc = subprocess.run(
                    [sys.executable, __file__, "--time-one", str(lib)],
                    capture_output=True, text=True, timeout=90)
                got = (json.loads(proc.stdout.strip().splitlines()[-1])
                       if proc.returncode == 0 else proc.stderr[-300:])
            except subprocess.TimeoutExpired:
                got = "timed out"
            rec["ms"][name] = got
            print(f"conv_ps {name}: {got}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
