"""The conv and deconv sites, the v1 head, the sharded warp and whole steps
of two checkouts, timed in turns on one card.

Imports the ``rife_tpu_torch`` package of each checkout under a name of its
own (each builds its kernels from its own ``csrc`` into its own ``_build``,
as tools/warp_ab.py does) and times, in the order old, new, new, old (bf16):

* every 4x4 stride-2 deconv site of the v4.6, v2.3 and v1 1080p B=8 steps
  (``plan.conv_sites(..., "deconv4x4")`` of the new checkout): each
  checkout's route at the site (``deconv4x4`` at a planar site,
  ``deconv4x4_xla`` elsewhere) on the same inputs, bit for bit;
* ``conv3x3`` (K11/K12) at every site of the bf16 v2.3 1080p B=8 step
  (``plan.conv_sites`` of the new checkout), both checkouts' kernel on the
  same inputs, bit for bit, and the sum over the sites;
* the v1 fusionnet's head (B4's conv form, ``conv3x3(..., ps=2)``, 16 ->
  16 at 544x960, B=8), bit for bit;
* the f32 kernel at every f32 site of the v2.3 and v1 1080p B=8 steps
  (``plan.conv_site_counts`` of f32 sessions of the new checkout: the conv
  sites, the deconv sites through ``deconv4x4`` and v1's head through
  ``conv3x3(..., ps=2)``), both checkouts' wrapper on the same inputs, bit
  for bit, and the sums over each step, each site times its launches;
* ``warp_spatial`` at a quarter of the rows (u8 C=3 of 1088x1920 B=2,
  float C=32 of 544x960 B=2), bit for bit;
* whole steps on the same seeded frames, each checkout's output equal to
  the other's bit for bit, and the host clock around synchronised steps
  after a warm-up, as ``chip_smoke.py`` phase 11 times them: bf16 v4.6,
  v2.3 and v1 at 1080p B=8, v4.6 ``-x -z`` at 1080p B=2, v2.3 ``-u`` at
  4K B=2, f32 v2.3 at 1080p B=2 (TF32 off, and
  ``torch.backends.cudnn.deterministic`` on: without it cuDNN's f32
  algorithms give one checkout's own runs other bits from run to run),
  and the height-sharded cases of phase 11 (v4.6 1x4 B=2, v2.3 ``-u`` 4K
  1x4 B=1, v1 1x4 B=1, v4.6 2x2 B=4, each over four shards of cuda:0).

Every number goes to ``--out`` with the card's name and power limit.  Run
from the repository root on one GPU, against the parent commit unpacked
(``git archive``) into a directory that .gitignore lists:
    python tools/step_ab.py --old <checkout> [--new <checkout>] [--out PATH]
        [--skip-steps | --steps-only]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from warp_ab import card_line, load_package, time_ms  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
TTA = {"tta_mode": True, "tta_temporal_mode": True}
UHD = {"uhd_mode": True}
STEPS = [("v4.6", {}, (1, 1), (8, 1080, 1920), BF16),
         ("v2.3", {}, (1, 1), (8, 1080, 1920), BF16),
         ("v1", {}, (1, 1), (8, 1080, 1920), BF16),
         ("v4.6", TTA, (1, 1), (2, 1080, 1920), BF16),
         ("v2.3", UHD, (1, 1), (2, 2160, 3840), BF16),
         ("v2.3", {}, (1, 1), (2, 1080, 1920), F32),
         ("v4.6", {}, (1, 4), (2, 1080, 1920), BF16),
         ("v2.3", UHD, (1, 4), (1, 2160, 3840), BF16),
         ("v1", {}, (1, 4), (1, 1080, 1920), BF16),
         ("v4.6", {}, (2, 2), (4, 1080, 1920), BF16)]


def in_turns(fns, iters=10):
    """{name: [ms, ms]} of each fn timed old, new, new, old."""
    out = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        out[name].append(time_ms(fns[name], iters))
    return out


def deconv_sites(pkgs, dirs, device, rec):
    g = torch.Generator().manual_seed(0)
    for model in ("v4.6", "v2.3", "v1"):
        sess = pkgs["new"].RIFE(str(dirs[model]), device=device)
        sites = pkgs["new"].engine.plan.conv_sites(sess, 1080, 1920,
                                                   "deconv4x4")
        del sess
        for i, (factor, (cin,), co, ps, act, h, w, xla) in enumerate(sites):
            b = 8 * factor
            x = torch.randn(b, cin, h, w, generator=g).to(device,
                                                         torch.bfloat16)
            raw = (torch.randn(cin, co, 4, 4, generator=g)
                   / (2 * cin ** 0.5)).to(device, torch.bfloat16)
            bias = (torch.randn(co, generator=g) * 0.1).to(device).to(
                torch.bfloat16)
            slope = (torch.rand(co, generator=g) * 0.3).to(device).to(
                torch.bfloat16)
            fns = {}
            for side, pkg in pkgs.items():
                cv = pkg.ops.conv
                packed = cv.pack_weight_t4(raw)
                if xla:
                    fns[side] = (lambda cv=cv, packed=packed:
                                 cv.deconv4x4_xla(x, packed, bias.float(),
                                                  slope.float(), act=act,
                                                  ps=ps))
                else:
                    w3 = cv.deconv_phase_weights(raw).contiguous()
                    b4, s4 = bias.float().repeat(4), slope.float().repeat(4)
                    fns[side] = (lambda cv=cv, packed=packed, w3=w3, b4=b4,
                                 s4=s4: cv.deconv4x4(x, w3, b4, s4, act=act,
                                                     weight_t4=packed, ps=ps))
            require_equal(fns, f"{model} deconv site {i}")
            entry = {"site": [b, cin, co, ps, act, h, w, bool(xla)],
                     "route": in_turns(fns)}
            rec[f"deconv {model} {i}"] = entry
            print(f"deconv {model} site {i} {entry['site']}: "
                  f"{entry['route']}, bit for bit", flush=True)
            del x, raw, fns
    torch.cuda.empty_cache()


def conv_sites(pkgs, dirs, device, rec):
    g = torch.Generator().manual_seed(2)
    sess = pkgs["new"].RIFE(str(dirs["v2.3"]), device=device)
    sites = pkgs["new"].engine.plan.conv_sites(sess, 1080, 1920)
    del sess
    total = {"old": [0.0, 0.0], "new": [0.0, 0.0]}
    for i, (factor, parts, cout, stride, act, h, w, deconv) in \
            enumerate(sites):
        if deconv:
            raise SystemExit(f"v2.3 conv site {i} is a deconv site in bf16")
        b = 8 * factor
        xs = [torch.randn(b, c, h, w, generator=g).to(device, torch.bfloat16)
              for c in parts]
        cin = sum(parts)
        weight = (torch.randn(cout, cin, 3, 3, generator=g)
                  / (3 * cin ** 0.5)).to(device, torch.bfloat16)
        bias = (torch.randn(cout, generator=g) * 0.1).to(device)
        slope = (torch.rand(cout, generator=g) * 0.3).to(device)
        fns = {}
        for side, pkg in pkgs.items():
            cv = pkg.ops.conv
            fns[side] = (lambda cv=cv, tc=cv.pack_weight_tc(weight):
                         cv.conv3x3(xs, weight, bias, slope, stride=stride,
                                    act=act, weight_tc=tc))
        require_equal(fns, f"conv3x3 v2.3 site {i}")
        got = in_turns(fns)
        rec[f"conv3x3 v2.3 {i}"] = {
            "site": [b, list(parts), cout, stride, act, h, w], "ms": got}
        for side in total:
            total[side] = [t + m for t, m in zip(total[side], got[side])]
        print(f"conv3x3 v2.3 site {i} (B={b} parts={parts} cout={cout} "
              f"s{stride} act{act} {h}x{w}): {got}, bit for bit",
              flush=True)
        del xs, weight
    rec["conv3x3 v2.3 sum"] = total
    print(f"conv3x3 over the {len(sites)} v2.3 sites: {total}", flush=True)
    torch.cuda.empty_cache()


def f32_site_fns(cv, gen, device, site, ps, t):
    """A checkout's f32 wrapper at one site, on inputs made once (``t``
    holds them across checkouts)."""
    factor, parts, cout, stride, act, h, w, deconv = site
    b, cin = 8 * factor, sum(parts)
    if not t:
        def randn(*shape, scale=1.0):
            return torch.randn(*shape, device=device, generator=gen) * scale
        t["xs"] = [randn(b, c, h, w) for c in parts]
        if deconv:
            o = cout // 4
            t["raw"] = randn(cin, o, 4, 4, scale=1 / (2 * cin ** 0.5))
            t["bias"] = randn(o, scale=0.1).repeat(4)
            t["slope"] = (randn(o).abs() * 0.3).repeat(4)
        else:
            t["weight"] = randn(cout, cin, 3, 3, scale=1 / (3 * cin ** 0.5))
            t["bias"] = randn(cout, scale=0.1)
            t["slope"] = randn(cout).abs() * 0.3
    if deconv:
        w3 = cv.deconv_phase_weights(t["raw"]).contiguous()
        t4 = cv.pack_weight_t4(t["raw"])
        return lambda: cv.deconv4x4(t["xs"][0], w3, t["bias"], t["slope"],
                                    act=act, weight_t4=t4, ps=ps)
    tc = cv.pack_weight_tc(t["weight"])
    return lambda: cv.conv3x3(t["xs"], t["weight"], t["bias"], t["slope"],
                              stride=stride, act=act, weight_tc=tc, ps=ps)


def f32_sites(pkgs, dirs, device, rec):
    gen = torch.Generator(device=device).manual_seed(4)
    new = pkgs["new"]
    for model in ("v2.3", "v1"):
        sess = new.RIFE(str(dirs[model]), device=device, dtype=torch.float32)
        sites = [(site, 2 if kind == "conv3x3_ps" else 1, n)
                 for kind in ("conv3x3", "conv3x3_ps")
                 for site, n in new.engine.plan.conv_site_counts(
                     sess, 1080, 1920, kind)]
        del sess
        total = {"old": [0.0, 0.0], "new": [0.0, 0.0]}
        for i, (site, ps, n) in enumerate(sites):
            t = {}
            fns = {side: f32_site_fns(pkg.ops.conv, gen, device, site, ps, t)
                   for side, pkg in pkgs.items()}
            require_equal(fns, f"f32 {model} site {i} {site}")
            got = in_turns(fns)
            rec[f"f32 {model} {i}"] = {
                "site": [site[0], list(site[1]), *site[2:]], "ps": ps,
                "launches_a_step": n, "ms": got}
            for side in total:
                total[side] = [a + n * m for a, m in zip(total[side],
                                                         got[side])]
            print(f"f32 {model} site {i} {site} ps {ps}, {n} a step: {got}, "
                  f"bit for bit", flush=True)
            del fns, t
            torch.cuda.empty_cache()
        launches = sum(n for _, _, n in sites)
        rec[f"f32 {model} step sum"] = {"launches": launches, "ms": total}
        print(f"f32 conv3x3 over a {model} 1080p B=8 step ({launches} "
              f"launches at {len(sites)} sites; old, new in turns): {total}",
              flush=True)


def head_and_spatial(pkgs, device, rec):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 16, 544, 960, generator=g).to(device, torch.bfloat16)
    wt = (torch.randn(16, 16, 3, 3, generator=g) / 12).to(device,
                                                          torch.bfloat16)
    bias = torch.randn(16, generator=g).to(device) * 0.1
    fns = {}
    for side, pkg in pkgs.items():
        cv = pkg.ops.conv
        tc = cv.pack_weight_tc(wt)
        fns[side] = (lambda cv=cv, tc=tc: cv.conv3x3([x], wt, bias,
                                                     weight_tc=tc, ps=2))
    require_equal(fns, "v1 head")
    rec["v1 head conv3x3_ps"] = in_turns(fns)
    print(f"v1 head (16 -> 16 + PixelShuffle 2 at 544x960, B=8): "
          f"{rec['v1 head conv3x3_ps']}", flush=True)
    for mode, u8, (b, c, h, w) in (("u8", True, (2, 3, 1088, 1920)),
                                   ("float", False, (2, 32, 544, 960))):
        img = torch.rand(b, c, h, w, generator=g).to(device, torch.bfloat16)
        flow = (torch.randn(b, 2, h, w, generator=g) * 8).to(device,
                                                            torch.bfloat16)
        s, e = h // 4, h // 2
        rows = flow[:, :, s:e].contiguous()
        fns = {side: (lambda W=pkg.ops.warp: W.warp_spatial(img, rows, s,
                                                            u8=u8))
               for side, pkg in pkgs.items()}
        require_equal(fns, f"warp_spatial {mode}")
        rec[f"warp_spatial {mode}"] = in_turns(fns, 20)
        print(f"warp_spatial {mode} rows {s}-{e} of {(b, c, h, w)}: "
              f"{rec[f'warp_spatial {mode}']}", flush=True)


def require_equal(fns, what):
    a, b = fns["old"](), fns["new"]()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise SystemExit(f"{what}: the two checkouts differ")


def step_ms(fn, steps=3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def steps(pkgs, dirs, device, rec):
    for model, modes, (nd, ns), (b, h, w), dtype in STEPS:
        torch.backends.cudnn.deterministic = dtype == F32
        rng = np.random.default_rng(3)
        f0 = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                           np.uint8)).to(device)
        f1 = torch.roll(f0, shifts=(3, -5), dims=(1, 2))
        ts = np.full(b, 0.5, np.float32)
        runners = {}
        for side, pkg in pkgs.items():
            sess = pkg.RIFE(str(dirs[model]), device=device, dtype=dtype,
                            **modes)
            if nd * ns > 1:
                S = pkg.parallel.sharding
                sess = S.ShardedRIFE(sess, S.make_mesh_2d(
                    nd, ns, [device] * (nd * ns)), height_axis="spatial")
            runners[side] = sess
        label = (f"{model}{' -x -z' * (modes is TTA)}{' -u' * (modes is UHD)}"
                 f" {h}x{w} B={b} {str(dtype)[6:]}"
                 + (f" mesh {nd}x{ns}" if nd * ns > 1 else ""))
        require_equal({side: (lambda r=r: r.process_batch_device(f0, f1, ts))
                       for side, r in runners.items()}, f"step {label}")
        got = {"old": [], "new": []}
        for side in ("old", "new", "new", "old"):
            r = runners[side]
            got[side].append(step_ms(
                lambda r=r: r.process_batch_device(f0, f1, ts)))
        rec[f"step {label}"] = got
        print(f"step {label}: bit for bit; host ms a step (synchronised) "
              f"{got}", flush=True)
        del runners
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--new", type=Path, default=ROOT)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--skip-steps", action="store_true")
    ap.add_argument("--steps-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    pkgs = {}
    for side, root in (("old", args.old), ("new", args.new)):
        pkg = load_package(root.resolve(), f"rife_pkg_{side}")
        for sub in ("ops.conv", "ops.warp", "engine.plan",
                    "parallel.sharding"):
            __import__(f"rife_pkg_{side}.{sub}")
        pkgs[side] = pkg
    new = pkgs["new"]
    from importlib import import_module
    models = ROOT / "rife_tpu_torch" / "_build" / "models"
    dirs = {
        "v4.6": import_module("rife_pkg_new.models.v46_arch")
        .write_flownet_param(models),
        "v2.3": import_module("rife_pkg_new.models.v23_arch")
        .write_v23_params(models),
        "v1": import_module("rife_pkg_new.models.v1_arch")
        .write_v1_params(models)}
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; {torch.cuda.get_device_name(0)}", flush=True)
    rec = {"card": card}
    if not args.steps_only:
        deconv_sites(pkgs, dirs, device, rec)
        conv_sites(pkgs, dirs, device, rec)
        head_and_spatial(pkgs, device, rec)
        f32_sites(pkgs, dirs, device, rec)
    if not args.skip_steps:
        steps(pkgs, dirs, device, rec)
    del new
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
