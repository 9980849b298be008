"""What ``torch.backends.cudnn.deterministic`` does to the bf16 bytes that
depend on a step's shape, in a checkout whose deconv sites run on cuDNN.

Imports ``chip_smoke.py`` and ``rife_tpu_torch`` of the checkout ``--root``
(e.g. the parent commit unpacked with ``git archive``) and runs, once with
the flag off and once with it on (bf16, one card):

* ``cudnn_rows_probe``: a window of rows against the whole frame, per conv
  shape of the sharded paths;
* ``node_witness`` on the height-sharded v4.6 1080p B=2, v1 1080p B=1 and
  v2.3 ``-u`` 4K B=1 steps (four shards of cuda:0): the nodes that differ
  from the unsharded run on the same inputs, by route;
* the rows of a v4.6 1080p B=2 step against the same rows of a B=4 step;
* the host time of a synchronised v4.6 and v2.3 1080p B=8 step, flag off,
  on, on, off.

Prints each reading; with ``--out`` writes them as JSON beside the card's
name and power limit.
Run: python tools/cudnn_probe.py --root <checkout> [--out PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as CS
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.models.v1_arch import write_v1_params
    from rife_tpu_torch.models.v23_arch import write_v23_params
    from rife_tpu_torch.models.v46_arch import write_flownet_param
    from rife_tpu_torch.parallel.sharding import ShardedRIFE, make_mesh_2d

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    models = root / "rife_tpu_torch" / "_build" / "models"
    dirs = {"v4.6": write_flownet_param(models),
            "v2.3": write_v23_params(models), "v1": write_v1_params(models)}
    card = CS.card_line()
    rec = {"card": card, "root": str(root)}
    print(f"card: {card}; checkout {root}", flush=True)
    cases = [("height 1x4 v4.6", "v4.6", {}, (2, 1080, 1920)),
             ("height 1x4 v1", "v1", {}, (1, 1080, 1920)),
             ("height 1x4 v2.3 -u", "v2.3", {"uhd_mode": True},
              (1, 2160, 3840))]
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            CS.cudnn_rows_probe(device)
        print(out.getvalue(), end="", flush=True)
        rec[f"rows probe deterministic={det}"] = out.getvalue().splitlines()
        for path, model, modes, (b, h, w) in cases:
            sess = RIFE(str(dirs[model]), device=device, **modes)
            sharded = ShardedRIFE(sess, make_mesh_2d(1, 4, [device] * 4),
                                  height_axis="spatial")
            f0, f1 = CS.smooth_frames(np.random.default_rng(5), b, h, w)
            ts = np.full(b, 0.5, np.float32)
            d = np.abs(sharded.process_batch(f0, f1, ts).astype(np.int16)
                       - sess.process_batch(f0, f1, ts))
            tally = CS.node_witness(path, sess, sharded, f0, f1, ts, device)
            rec[f"{path} deterministic={det}"] = {
                "u8_max_abs_diff": int(d.max()),
                "exact": float((d == 0).mean()), "witness": tally}
            print(f"{path} deterministic={det}: sharded vs unsharded u8 max "
                  f"|d| {int(d.max())}, exact {float((d == 0).mean()):.6f}",
                  flush=True)
            del sess, sharded
            torch.cuda.empty_cache()
        sess = RIFE(str(dirs["v4.6"]), device=device)
        f0, f1 = CS.smooth_frames(np.random.default_rng(6), 4, 1080, 1920)
        four = sess.process_batch(f0, f1, np.full(4, 0.5, np.float32))
        two = sess.process_batch(f0[:2], f1[:2], np.full(2, 0.5, np.float32))
        d = np.abs(four[:2].astype(np.int16) - two)
        rec[f"v4.6 B=4 vs B=2 rows deterministic={det}"] = {
            "u8_max_abs_diff": int(d.max()), "exact": float((d == 0).mean())}
        print(f"v4.6 1080p bf16, rows of a B=4 step against a B=2 step, "
              f"deterministic={det}: u8 max |d| {int(d.max())}, exact "
              f"{float((d == 0).mean()):.6f}", flush=True)
        del sess
        torch.cuda.empty_cache()
    for model in ("v4.6", "v2.3"):
        sess = RIFE(str(dirs[model]), device=device)
        rng = np.random.default_rng(3)
        f0 = torch.from_numpy(rng.integers(0, 256, (8, 1080, 1920, 3),
                                           np.uint8)).to(device)
        f1 = torch.roll(f0, shifts=(3, -5), dims=(1, 2))
        ts = np.full(8, 0.5, np.float32)
        got = {False: [], True: []}
        for det in (False, True, True, False):
            torch.backends.cudnn.deterministic = det
            sess.process_batch_device(f0, f1, ts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                sess.process_batch_device(f0, f1, ts)
            torch.cuda.synchronize()
            got[det].append((time.perf_counter() - t0) * 1e3 / 3)
        rec[f"{model} 1080p B=8 step ms"] = {
            "deterministic off": got[False], "deterministic on": got[True]}
        print(f"{model} 1080p B=8 bf16 step (host ms, synchronised): "
              f"deterministic off {got[False]}, on {got[True]}; card {card}",
              flush=True)
        del sess
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
