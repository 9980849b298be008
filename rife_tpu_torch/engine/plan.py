"""Which kernels one step of a session launches: the session's own step, run
on meta tensors and counted.

The plan runs ``RIFE.forward`` on (1, h, w, 3) u8 frames on the meta device,
with the session's prepared weights moved there and its own executors
(``n_spatial`` > 1: ``graph/spatial.py`` ``SpatialExecutor``s over that
many meta devices, as ``ShardedRIFE`` builds them).  Every op above the
kernel wrappers runs as it does on the session's device; each wrapper
checks its operands, allocates its output and counts the call under its
launch counter's name, and nothing is computed or launched
(``ops/launch.py``: while the plan runs, meta tensors stand for the
session's device, so every gate and route decides as it would there).  A
site's batch factor is its call's batch, the step's being 1; the launches
per kernel do not depend on the batch size.  ``chip_smoke.py`` holds the
card's launch counters to it, and times ``conv3x3`` / ``conv3x3_ps`` /
``deconv4x4`` at each site ``conv_sites`` lists.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..graph import spatial
from ..ops import launch as L
from ..ops.torch_ops import weights_on

META = torch.device("meta")


def _calls(session, h: int, w: int, n_spatial: int = 1) -> List[tuple]:
    """[(kernel, site), ...] of one step, in the order the step calls the
    wrappers (the warps' and ``bias_act``'s site is None)."""
    weights = weights_on(session.weights, META)
    executors = session.executors
    if n_spatial > 1:
        executors = {net: spatial.SpatialExecutor(ex, [META] * n_spatial,
                                                  {META: weights[net]})
                     for net, ex in executors.items()}
    frames = torch.empty((1, h, w, 3), dtype=torch.uint8, device=META)
    traffic = dict(spatial.TRAFFIC)
    try:
        with L.planning(session.device) as calls:
            session.forward(frames, frames, np.full(1, 0.5, np.float32),
                            executors, weights)
    finally:
        spatial.TRAFFIC.update(traffic)
    return calls


def kernel_sites(session, h: int, w: int,
                 n_spatial: int = 1) -> Dict[str, int]:
    """Kernel launches of one ``process_batch`` step of a ``RIFE`` session
    on (h, w) frames, or (``n_spatial`` > 1) of one data shard's step
    height-sharded over ``n_spatial`` shards."""
    return dict(Counter(name for name, _ in
                        _calls(session, h, w, n_spatial)))


def conv_sites(session, h: int, w: int,
               kernel: str = "conv3x3") -> List[tuple]:
    """The distinct calls of ``kernel`` (``conv3x3``; ``conv3x3_ps``: the
    PixelShuffle sites; ``deconv4x4``: the deconv kernel's) in one step on
    (h, w) frames, as ``ops/conv.py`` lists a site: (batch factor, part
    channels, cout, stride, activation code, H, W, deconv), or for
    ``deconv4x4`` (batch factor, (cin,), O, PixelShuffle factor, activation
    code, H, W, XLA order)."""
    return [site for site, _ in conv_site_counts(session, h, w, kernel)]


def conv_site_counts(session, h: int, w: int,
                     kernel: str = "conv3x3") -> List[Tuple[tuple, int]]:
    """``conv_sites`` with each distinct call's launches in the step:
    [(site, launches), ...] in the order the step first calls them."""
    return list(Counter(site for name, site in _calls(session, h, w)
                        if name == kernel).items())
