"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``portbench/reference``) runs on every distinct pair of the
sample of answers the window produced, one pair at a time, from the same
clip and the same ``.bin`` files, and each sampled answer is held to it.
The numbers (a cell compares those its workload file gives a limit):

* ``worst_frame_mean_abs_u8``: the largest, over the sampled frames, of the
  mean absolute difference in u8 levels between the program's frame and
  the float32 reference's;
* ``mean_abs_u8``: that difference pooled over all the sampled frames;
* ``worst_frame_off5_share``: the largest, over the sampled frames, of
  the share (%) of the frame's values that lie ``OFF_LEVELS`` u8 levels or
  more from the float32 reference's.  Rounding that a synthetic net
  amplifies moves a few values by much (where a textured frame is warped a
  little elsewhere); a precision too low for the frame moves most values
  by some levels;
* ``duplicate_answers``: pairs of sampled answers to different pairs that
  are byte for byte the same (an answer reused for another request);
* ``missing``: answers due in the window that never came, came twice or
  came malformed.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

from .reference.rife import Reference

OFF_LEVELS = 5
NUMBERS = ("worst_frame_mean_abs_u8", "mean_abs_u8", "worst_frame_off5_share",
           "duplicate_answers")


def mean_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean |a - b| of two (H,W,3) u8 frames, in u8 levels."""
    return float((a.float() - b.float()).abs().mean())


def off_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share (%) of the values of two u8 frames ``OFF_LEVELS`` or more
    apart."""
    return 100.0 * float(((a.float() - b.float()).abs()
                          >= OFF_LEVELS).float().mean())


def _digest(frame: torch.Tensor) -> bytes:
    return hashlib.sha1(frame.contiguous().cpu().numpy().tobytes()).digest()


def compare(sample: List[Tuple[int, object]], reference: Reference,
            clip: torch.Tensor, t: float,
            want: Tuple[str, ...] = NUMBERS) -> Tuple[Dict[str, float], float]:
    """(the worst of each number in ``want`` over ``sample``, the mean flow
    tap std over the distinct pairs).  ``sample``: (pair index, (H,W,3) u8
    frame) with pair p = (clip[p], clip[p + 1])."""
    refs: Dict[int, torch.Tensor] = {}
    flows = []
    for p in sorted({p for p, _ in sample}):
        out, flow = reference.pair(clip[p:p + 1], clip[p + 1:p + 2], t)
        refs[p] = out[0]
        flows.append(flow.float().std().item())
    worst = {k: 0.0 for k in want}
    pooled = []
    seen: Dict[bytes, int] = {}
    for p, frame in sample:
        got = torch.as_tensor(frame).to(reference.device)
        ref = refs[p]
        if tuple(got.shape) != tuple(ref.shape) or got.dtype != torch.uint8:
            raise ValueError(f"pair {p}: answer {tuple(got.shape)} "
                             f"{got.dtype}, want {tuple(ref.shape)} u8")
        pooled.append(mean_abs(got, ref))
        if "worst_frame_mean_abs_u8" in want:
            worst["worst_frame_mean_abs_u8"] = max(
                worst["worst_frame_mean_abs_u8"], pooled[-1])
        if "worst_frame_off5_share" in want:
            worst["worst_frame_off5_share"] = max(
                worst["worst_frame_off5_share"], off_share(got, ref))
        if "duplicate_answers" in want:
            d = _digest(got)
            if seen.setdefault(d, p) != p:
                worst["duplicate_answers"] += 1
    if "mean_abs_u8" in want and pooled:
        worst["mean_abs_u8"] = sum(pooled) / len(pooled)
    flow_std = sum(flows) / len(flows) if flows else float("nan")
    return worst, flow_std
