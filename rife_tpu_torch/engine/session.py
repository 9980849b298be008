"""RIFE session on PyTorch (port of ``rife_tpu/engine/session.py``, plain v4
path).

One session owns the loaded flownet graph after the rewrite chain, its
weights on the session's device, and ``rife_tpu``'s ``Executor`` over
``torch_ops.OP_TABLE``.  ``process_batch`` takes (B,H,W,3) u8 frame pairs and
(B,) timesteps and returns (B,H,W,3) u8 frames.

Left out, as TPU-only machinery: planar/region executors, the warp-variant
probe, the compile cache and the ``RIFE_TPU_*`` switches.  TTA, UHD and the
v1/v2/v3 families raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rife_tpu.graph.executor import Executor
from rife_tpu.graph.rewrite import (
    fuse_concat_into_convs,
    fuse_pixelshuffle_into_convs,
    fuse_prelu_activations,
    fuse_quarter_downscaled_warps,
    fuse_render_blend,
    fuse_sibling_warps,
)
from rife_tpu.models.zoo import load_model

from .. import default_dtype, resolve_device
from ..ops import torch_ops
from . import pipelines

PAD_ALIGN = 32  # the reference pads frames to 32px multiples

# blobs the v4 pipeline may extract; no rewrite may consume them
_EXTRACTABLE = frozenset(("flow", "flow0", "flow1", "flow2", "flow3", "out0"))
# blobs that are the u8-origin input frames
_IMG_SEEDS = ("in0", "in1", "input0", "input1")


def pad_to(v: int, align: int = PAD_ALIGN) -> int:
    return (v + align - 1) // align * align


def rewrite_flownet(graph, weights):
    """The rewrite chain of the TPU defaults (``rife_tpu`` session.py:159-247)
    for a v4 flownet; every rewrite is exact.  ``push_concat_through_interp``
    stays off for v4, as there."""
    graph = fuse_quarter_downscaled_warps(graph, _EXTRACTABLE, fuse_half=False)
    graph, weights = fuse_prelu_activations(graph, weights, _EXTRACTABLE)
    graph = fuse_concat_into_convs(graph, _EXTRACTABLE, flatten_nested=False)
    graph = fuse_pixelshuffle_into_convs(graph, _EXTRACTABLE)
    graph = fuse_render_blend(graph, _EXTRACTABLE)
    graph = fuse_sibling_warps(graph)
    return graph, weights


class RIFE:
    """Frame-interpolation session for the v4 family, plain 2x.

    ``device`` is required and explicit ("cuda", "cuda:1", "cpu"); asking for
    CUDA without a card raises.  ``dtype`` defaults to bf16 on CUDA and f32
    on the CPU."""

    def __init__(self, model: str = "rife-v4.6", *, device,
                 dtype: Optional[torch.dtype] = None, model_root=None,
                 tta_mode: bool = False, tta_temporal_mode: bool = False,
                 uhd_mode: bool = False):
        if tta_mode or tta_temporal_mode:
            raise NotImplementedError(
                "TTA (-x/-z) is not ported yet (ROADMAP queue A, A8)")
        if uhd_mode:
            raise NotImplementedError(
                "UHD mode (-u) is not ported yet (ROADMAP queue A, A10)")
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.model = load_model(model, model_root)
        if self.model.family != "v4":
            raise NotImplementedError(
                f"{self.model.name} ({self.model.family} family) is not "
                f"ported yet (ROADMAP queue A, A9)")
        net = self.model.flownet
        graph, weights = rewrite_flownet(net.graph, net.weights)
        self.executor = Executor(graph, torch_ops.OP_TABLE, weights, ctx={
            "u8_image_blobs": frozenset(graph.value_copies_of(_IMG_SEEDS)),
        })
        self.executor.render_planar = any(
            n.type == "rife.RenderBlend" for n in graph.nodes)
        self.weights = torch_ops.prepare_weights(
            graph, weights, self.dtype, self.device)

    def _frames(self, x) -> torch.Tensor:
        t = torch.as_tensor(x)
        if t.dtype != torch.uint8 or t.dim() != 4 or t.shape[-1] != 3:
            raise ValueError(f"frames must be (B,H,W,3) uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
        return t.to(self.device, non_blocking=True)

    def process_batch_device(self, in0, in1, timesteps) -> torch.Tensor:
        """(B,H,W,3) u8 pairs (numpy or tensors) + (B,) timesteps -> the u8
        result as a tensor on the session's device, without synchronising."""
        if tuple(in0.shape) != tuple(in1.shape):
            raise ValueError(f"frame shape mismatch: {tuple(in0.shape)} vs "
                             f"{tuple(in1.shape)}")
        a, b = self._frames(in0), self._frames(in1)
        n, h, w, _ = a.shape
        ts = torch.as_tensor(np.asarray(timesteps, np.float32).reshape(n)).to(
            self.device)
        with torch.inference_mode():
            return pipelines.forward_v4(self.executor, self.weights, a, b, ts,
                                        pad_to(h), pad_to(w), self.dtype)

    def process_batch(self, in0, in1, timesteps) -> np.ndarray:
        """Interpolate a batch: (B,H,W,3) u8 pairs + (B,) timesteps -> u8."""
        return self.process_batch_device(in0, in1, timesteps).cpu().numpy()

    def process(self, in0: np.ndarray, in1: np.ndarray,
                timestep: float = 0.5) -> np.ndarray:
        """Single pair, (H,W,3) u8 -> (H,W,3) u8; t == 0 or 1 returns a copy
        of the matching input, as the reference does."""
        if timestep == 0.0:
            return in0.copy()
        if timestep == 1.0:
            return in1.copy()
        out = self.process_batch(in0[None], in1[None],
                                 np.asarray([timestep], np.float32))
        return out[0]
