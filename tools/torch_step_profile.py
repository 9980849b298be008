"""Where the time of one rife_tpu_torch step goes on the card.

Runs the 2x bf16 step of the v4.6-architecture graph, the v2.3-architecture
graphs or the v1-architecture ``rife`` graphs (in-repo reconstructions,
synthetic weights) at 1080p, B=8 by default, plain or with ``--fuse-ds2``
and ``--tta`` (``-x -z``), or with ``--uhd`` (``-u``, v2.3 and v1, on
2160x3840 frames), under ``torch.profiler`` and prints: the step's wall
time, the summed device time of its kernels, the device's idle share over
the profiled window (1 - the union of its device intervals, so streams
that overlap count once), and the kernels ranked by device time.  ``--by-op``
profiles the same steps once more with every graph node under a
``record_function`` of its layer kind (a ``BinaryOp`` or ``PReLU`` on a
(B,C) vector is marked "SE", the v1 gates' scale and slope) and prints the
device time per layer kind: the labels cost host time, so that run's wall
time is not the step's, and only kernels that PyTorch launches are
attributed (the ``csrc/`` kernels, launched through ctypes, are not: read
them in the kernel table).  The same run puts the ``ops/torch_ops.py``
helpers that launch eager ops (``HELPERS``) under labels of their own and
ties each kernel to the host op that launched it (the profiler's linked
correlation id: the innermost aten op) and to the innermost helper and
layer kind around that op on its thread; it prints the kernels a step and
the device time a step of each (kernel, aten op, helper, layer kind), the
kernel under the name the benchmark's ledger gives it (64 characters, each
outside [A-Za-z0-9_:.-] as ``_``), so that a ledger ``breakdown`` row can
be looked up.  ``--mesh DxS`` runs the step through
``parallel/sharding.py``'s ``ShardedRIFE`` over a D x S mesh of cuda:0
named D*S times (batch sharding over D, height sharding over S when S > 1),
the cost of the sharded paths' halos, gathers and extra launches on one
card; under it ``--by-op`` labels the nodes that a shard runs through the
layer table (the sharded warps and resizes are left out).  Needs one
NVIDIA GPU.

Run: python tools/torch_step_profile.py [B] [STEPS] [--model v4.6|v2.3|v1]
     [--fuse-ds2] [--tta] [--uhd] [--mesh DxS] [--by-op] [--table PATH]
"""

from __future__ import annotations

import argparse
import bisect
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HELPERS = ("apply_activation", "_upsample_axis", "_downsample_axis",
           "resize_nearest", "sigmoid")


def busy_us(kineto_events) -> float:
    """Microseconds in which anything ran on the device: the union of the
    device events' intervals (``prof.profiler.kineto_results.events()``;
    ``record_function``'s device-side copies left out)."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in kineto_events if e.device_type() == cuda
                   and not e.is_user_annotation())
    total, edge = 0, None
    for s, e in spans:
        if edge is None or s > edge:
            total += e - s
            edge = e
        elif e > edge:
            total += e - edge
            edge = e
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("steps", type=int, nargs="?", default=3)
    ap.add_argument("--model", choices=("v4.6", "v2.3", "v1"),
                    default="v4.6")
    ap.add_argument("--fuse-ds2", action="store_true",
                    help="RIFE(..., fuse_ds2=True)")
    ap.add_argument("--tta", action="store_true", help="-x -z TTA")
    ap.add_argument("--uhd", action="store_true",
                    help="-u on 2160x3840 frames (v2.3, v1)")
    ap.add_argument("--mesh", default="1x1",
                    help="DxS: batch over D, height over S, all on cuda:0")
    ap.add_argument("--by-op", action="store_true",
                    help="also the device time per layer kind")
    ap.add_argument("--table", type=Path, help="write the full table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from rife_tpu_torch import RIFE

    models = ROOT / "rife_tpu_torch" / "_build" / "models"
    if args.model == "v2.3":
        from rife_tpu_torch.models.v23_arch import LABEL, write_v23_params

        model_dir = write_v23_params(models)
    elif args.model == "v1":
        from rife_tpu_torch.models.v1_arch import LABEL, write_v1_params

        model_dir = write_v1_params(models)
    else:
        from rife_tpu_torch.models.v46_arch import LABEL, write_flownet_param

        model_dir = write_flownet_param(models)
    if args.uhd and args.model == "v4.6":
        ap.error("--uhd runs the v2 and v1 families only (v4 ignores -u)")
    sess = RIFE(str(model_dir), device="cuda", fuse_ds2=args.fuse_ds2,
                tta_mode=args.tta, tta_temporal_mode=args.tta,
                uhd_mode=args.uhd)
    step = sess
    n_data, n_sp = (int(v) for v in args.mesh.lower().split("x"))
    if n_data * n_sp > 1:
        from rife_tpu_torch.parallel.sharding import (ShardedRIFE,
                                                      make_mesh_2d)

        mesh = make_mesh_2d(n_data, n_sp, [sess.device] * (n_data * n_sp))
        step = ShardedRIFE(sess, mesh, batch_axis="data",
                           height_axis="spatial" if n_sp > 1 else None)
    b, (h, w) = args.batch, (2160, 3840) if args.uhd else (1080, 1920)
    rng = np.random.default_rng(0)
    f0 = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), np.uint8)).cuda()
    f1 = torch.roll(f0, shifts=(3, -5), dims=(1, 2))
    ts = np.full(b, 0.5, np.float32)
    for _ in range(2):
        step.process_batch_device(f0, f1, ts)
    torch.cuda.synchronize()

    def run_steps():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step.process_batch_device(f0, f1, ts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kineto = prof.profiler.kineto_results.events()
        return prof.key_averages(), wall, busy_us(kineto), kineto

    events, wall, union_us, _ = run_steps()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(e.self_device_time_total for e in dev)
    step_ms = wall / args.steps * 1e3
    modes = (" fuse_ds2" * args.fuse_ds2 + " -x -z" * args.tta
             + " -u" * args.uhd)
    if n_data * n_sp > 1:
        modes += f" mesh {n_data}x{n_sp} of cuda:0"
    print(f"{LABEL},{modes or ' plain'}, bf16 {h}x{w} B={b}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"step wall {step_ms:.3f} ms (profiled), device kernel time "
          f"{kernel_us / 1e3 / args.steps:.3f} ms/step, idle share "
          f"{1 - union_us / 1e6 / wall:.3f}")
    dev.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in dev[:25]:
        print(f"{e.self_device_time_total / 1e3 / args.steps:9.3f} ms/step "
              f"{100 * e.self_device_time_total / kernel_us:5.1f}%  "
              f"x{e.count // args.steps:<4d} {e.key[:90]}")
    if args.by_op:
        by_op(sess, run_steps, args.steps, kernel_us)
    if args.table:
        args.table.parent.mkdir(parents=True, exist_ok=True)
        args.table.write_text(events.table(sort_by="self_cuda_time_total",
                                           row_limit=200))
    return 0


def by_op(sess, run_steps, steps, kernel_us):
    """Profile the steps with every node under ``record_function("op::<layer
    kind>")`` and each of ``HELPERS`` under ``"fn::<name>"``; print the
    device time under each layer kind, a step's, then ``attribute``'s
    table."""
    from torch.profiler import record_function

    from rife_tpu_torch.ops import torch_ops as T

    def labelled(kind, fn):
        def op(node, inputs, w, ctx):
            label = kind
            if kind in ("BinaryOp", "PReLU") and any(
                    getattr(x, "ndim", 0) == 2 for x in inputs):
                label += " (SE)"
            with record_function(f"op::{label}"):
                return fn(node, inputs, w, ctx)
        return op

    def helper(name, fn):
        def call(*args, **kw):
            with record_function(f"fn::{name}"):
                return fn(*args, **kw)
        return call

    tables = {}
    for name, ex in sess.executors.items():
        tables[name] = ex.op_table
        ex.op_table = {k: labelled(k, fn) for k, fn in ex.op_table.items()}
    saved = {h: getattr(T, h) for h in HELPERS}
    for h, fn in saved.items():
        setattr(T, h, helper(h, fn))
    try:
        events, _, _, kineto = run_steps()
    finally:
        for name, ex in sess.executors.items():
            ex.op_table = tables[name]
        for h, fn in saved.items():
            setattr(T, h, fn)
    # the host-side ranges: their device time is that of the kernels
    # launched inside them (each range also appears as a device-side
    # annotation, which is left out)
    ops = sorted((e for e in events if e.key.startswith("op::") and
                  e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: e.device_time_total, reverse=True)
    total = sum(e.device_time_total for e in ops)
    print(f"by layer kind: {total / 1e3 / steps:.3f} ms/step of device time "
          f"under the graph's nodes (pre/post and the pipelines' own ops "
          f"outside them)")
    for e in ops:
        print(f"{e.device_time_total / 1e3 / steps:9.3f} ms/step "
              f"{100 * e.device_time_total / kernel_us:5.1f}%  "
              f"x{e.count // steps:<5d} {e.key[4:]}")

    table, per_step = attribute(kineto, steps)
    print(f"by (kernel, aten op, helper, layer kind): {per_step:.1f} "
          f"kernels a step")
    rows = sorted(table.items(), key=lambda kv: -kv[1][0])
    for (kernel, op, fn, node), (us, n) in rows[:40]:
        print(f"{us / 1e3:9.3f} ms/step x{n / steps:<6.1f} {op:<24s} "
              f"{fn:<18s} {node:<16s} {ledger_key(kernel)}")


def ledger_key(name: str) -> str:
    """A kernel's name as the benchmark's ledger writes it."""
    return re.sub(r"[^A-Za-z0-9_:.-]", "_", name)[:64]


def attribute(events, steps):
    """({(kernel, aten op, helper, layer kind): [device us a step,
    launches]}, kernels a step) from kineto events labelled by ``by_op``."""
    cuda = torch.autograd.DeviceType.CUDA
    host, kernels = {}, []
    labels = defaultdict(list)  # thread -> [(start, end, name)]
    for e in events:
        if e.device_type() == cuda:
            if not (e.is_user_annotation() or "Memcpy" in e.name()
                    or "Memset" in e.name()):
                kernels.append(e)
            continue
        host[e.correlation_id()] = e
        if e.name().startswith(("fn::", "op::")):
            labels[e.start_thread_id()].append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    for lst in labels.values():
        lst.sort()
    starts = {t: [s for s, _, _ in lst] for t, lst in labels.items()}

    def around(ev):
        t, at = ev.start_thread_id(), ev.start_ns()
        lst = labels.get(t, [])
        i = bisect.bisect_right(starts.get(t, []), at)
        fn = node = "-"
        for s, e, name in reversed(lst[max(0, i - 64):i]):
            if s <= at <= e:
                if name.startswith("fn::") and fn == "-":
                    fn = name[4:]
                if name.startswith("op::") and node == "-":
                    node = name[4:]
        return fn, node

    table = defaultdict(lambda: [0.0, 0])
    for k in kernels:
        src = host.get(k.linked_correlation_id())
        op, fn, node = "-", "-", "-"
        if src is not None:
            op = src.name()
            fn, node = around(src)
        row = table[(k.name(), op, fn, node)]
        row[0] += k.duration_ns() / 1e3 / steps
        row[1] += 1
    return table, len(kernels) / steps


if __name__ == "__main__":
    sys.exit(main())
