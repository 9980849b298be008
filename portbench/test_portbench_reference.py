"""The reference against the program on the CPU at a small size: the
program's float32 session (CPU kernels' twins) and the reference agree to
one u8 level; the check's numbers of a sound run are small."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import check, scene, weights
from portbench.reference.rife import Reference
from portbench.testing import MINI_WIDTHS, ROOT


@pytest.mark.parametrize("name", ["rife-v4.6-arch", "rife-v2.3-arch"])
def test_reference_matches_program_f32(tmp_path, name):
    from rife_tpu_torch import RIFE

    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg["widths"] = MINI_WIDTHS[name]
    clip = scene.clip(99, 4, 64, 96, 2, "cpu")
    md, _ = weights.write_model(cfg, tmp_path, 1234, "cpu", clip[:2])
    ref = Reference(md, cfg["family"], cfg["nets"], "cpu")
    want, flow = ref.pair(clip[:3], clip[1:4], 0.5)
    sess = RIFE(os.path.relpath(md), device="cpu", dtype=torch.float32)
    got = sess.process_batch(clip[:3].numpy(), clip[1:4].numpy(),
                             np.full(3, 0.5, np.float32))
    d = np.abs(got.astype(int) - want.numpy().astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999
    assert float(flow.std()) > 0.5  # the flow moves the frames
    assert max(check.mean_abs(torch.from_numpy(g), w)
               for g, w in zip(got, want)) < 0.01


def test_warp_by_hand():
    from portbench.reference.graph import warp

    img = torch.arange(12, dtype=torch.float32).view(1, 1, 3, 4)
    flow = torch.zeros(1, 2, 3, 4)
    flow[:, 0] = 0.5   # half a pixel right
    flow[0, 1, 2, 3] = 5.0  # far below: clamped to the last row
    out = warp(img, flow)
    assert out[0, 0, 0, 0] == 0.5 and out[0, 0, 1, 1] == 5.5
    assert out[0, 0, 0, 3] == 3.0  # the right border clamps
    assert out[0, 0, 2, 3] == 11.0
