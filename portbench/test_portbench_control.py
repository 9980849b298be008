"""The control: the reference stored in float8 e4m3 (the precision below the
configurations' bfloat16: the frames, every node's output and every weight
rounded, per-tensor scale) has to fail each cell's check.  On the CPU at the
cells' widths and a small frame; on the card (``cuda``) at the cells' own
size over three seeds."""

import json

import pytest
import torch

from portbench import check, control, harness, scene, weights
from portbench.testing import bench_and_pair

CELLS = [c["name"] for c in bench_and_pair()["workloads"]]


def _control_numbers(cell, seed, h, w, device, pairs, root):
    wl = harness.workload(cell)
    cfg = harness.config(wl["config"])
    clip = scene.clip(seed, pairs + 1, h, w, wl["pan_px"], device)
    md, _ = weights.write_model(cfg, root, seed, device, clip[:2])
    limits = {k: v for k, v in wl["limits"].items() if k in check.NUMBERS}
    nums = control.control_numbers(range(pairs), md, cfg, clip,
                                   wl["timestep"], tuple(limits))
    return nums, limits


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_cpu(cell, tmp_path):
    nums, limits = _control_numbers(cell, 7, 128, 224, "cpu", 2, tmp_path)
    assert any(nums[k] > v for k, v in limits.items()), nums


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_card(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    wl = harness.workload(cell)
    for seed in (11, 12, 13):
        nums, limits = _control_numbers(cell, seed, wl["height"],
                                        wl["width"], "cuda", 4,
                                        tmp_path / str(seed))
        assert any(nums[k] > v for k, v in limits.items()), \
            json.dumps(nums)
