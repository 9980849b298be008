"""RIFE session on PyTorch (port of ``rife_tpu/engine/session.py``, plain v4
and v2 paths).

One session owns the model's nets after the rewrite chain, their weights on
the session's device, and one ``rife_tpu`` ``Executor`` per net over
``torch_ops.OP_TABLE``.  ``process_batch`` takes (B,H,W,3) u8 frame pairs and
(B,) timesteps and returns (B,H,W,3) u8 frames.

The v4 nets run as the TPU runs them, NHWC-style: every conv on cuDNN.  The
v2/v3 nets run with ctx ``planar_convs``, because the TPU runs them on its
planar executors: the conv sites that those send to the Pallas planar convs
take the ``conv3x3`` kernel (``ops/conv.py``).

Left out, as TPU-only machinery: planar/region executors, the warp-variant
probe, the compile cache and the ``RIFE_TPU_*`` switches.  TTA, UHD and the
v1 family raise ``NotImplementedError`` naming the ROADMAP item that ports
them.
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
    push_concat_through_interp,
)
from rife_tpu.models.zoo import load_model

from .. import default_dtype, resolve_device
from ..ops import torch_ops
from . import pipelines

PAD_ALIGN = 32  # the reference pads frames to 32px multiples

# blobs each pipeline may extract from a net; no rewrite may consume them
_EXTRACTABLE = {
    "flownet": frozenset(("flow", "flow0", "flow1", "flow2", "flow3", "out0")),
    "contextnet": frozenset(("f1", "f2", "f3", "f4")),
    "fusionnet": frozenset(("output",)),
}
# blobs that are the u8-origin input frames, per net
_IMG_SEEDS = {
    "flownet": ("in0", "in1", "input0", "input1"),
    "fusionnet": ("img0", "img1"),
}


def pad_to(v: int, align: int = PAD_ALIGN) -> int:
    return (v + align - 1) // align * align


def rewrite_flownet(graph, weights):
    """The rewrite chain of the TPU defaults (``rife_tpu`` session.py:159-247)
    for a v4 flownet; every rewrite is exact.  ``push_concat_through_interp``
    stays off for v4, as there."""
    protected = _EXTRACTABLE["flownet"]
    graph = fuse_quarter_downscaled_warps(graph, protected, fuse_half=False)
    graph, weights = fuse_prelu_activations(graph, weights, protected)
    graph = fuse_concat_into_convs(graph, protected, flatten_nested=False)
    graph = fuse_pixelshuffle_into_convs(graph, protected)
    graph = fuse_render_blend(graph, protected)
    graph = fuse_sibling_warps(graph)
    return graph, weights


def rewrite_planar_net(name, graph, weights):
    """The same chain for a net the TPU runs on its planar executor (every
    v1/v2/v3 net): nested block-entry concats flatten into the conv's parts,
    and downscale ``Interp`` nodes are pushed through concats."""
    protected = _EXTRACTABLE[name]
    graph = fuse_quarter_downscaled_warps(graph, protected, fuse_half=False)
    graph, weights = fuse_prelu_activations(graph, weights, protected)
    graph = fuse_concat_into_convs(graph, protected, flatten_nested=True)
    graph = push_concat_through_interp(graph, protected)
    graph = fuse_pixelshuffle_into_convs(graph, protected)
    graph = fuse_render_blend(graph, protected)
    graph = fuse_sibling_warps(graph)
    return graph, weights


class RIFE:
    """Frame-interpolation session for the v4 and v2/v3 families, plain 2x.

    ``device`` is required and explicit ("cuda", "cuda:1", "cpu"); asking for
    CUDA without a card raises.  ``dtype`` defaults to bf16 on CUDA and f32
    on the CPU."""

    def __init__(self, model: str = "rife-v2.3", *, device,
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
        family = self.model.family
        if family == "v1":
            raise NotImplementedError(
                f"{self.model.name} (v1 family) is not ported yet (ROADMAP "
                f"queue A, A9)")
        self.executors = {}
        self.weights = {}
        for name, net in self.model.nets.items():
            if family == "v4":
                graph, weights = rewrite_flownet(net.graph, net.weights)
            else:
                graph, weights = rewrite_planar_net(name, net.graph,
                                                    net.weights)
            ex = Executor(graph, torch_ops.OP_TABLE, weights, ctx={
                "u8_image_blobs": frozenset(
                    graph.value_copies_of(_IMG_SEEDS.get(name, ()))),
                "planar_convs": family != "v4",
            })
            ex.render_planar = any(
                n.type == "rife.RenderBlend" for n in graph.nodes)
            self.executors[name] = ex
            self.weights[name] = torch_ops.prepare_weights(
                graph, weights, self.dtype, self.device)

    @property
    def executor(self) -> Executor:
        """The flownet's executor (the v4 family's only net)."""
        return self.executors["flownet"]

    def _frames(self, x) -> torch.Tensor:
        t = torch.as_tensor(x)
        if t.dtype != torch.uint8 or t.dim() != 4 or t.shape[-1] != 3:
            raise ValueError(f"frames must be (B,H,W,3) uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
        return t.to(self.device, non_blocking=True)

    def process_batch_device(self, in0, in1, timesteps) -> torch.Tensor:
        """(B,H,W,3) u8 pairs (numpy or tensors) + (B,) timesteps -> the u8
        result as a tensor on the session's device, without synchronising.

        The v2 family interpolates the midpoint only: any timestep other
        than 0.5 raises ``ValueError`` (``rife_tpu`` session.py:471-477)."""
        if tuple(in0.shape) != tuple(in1.shape):
            raise ValueError(f"frame shape mismatch: {tuple(in0.shape)} vs "
                             f"{tuple(in1.shape)}")
        n = in0.shape[0]
        ts = np.asarray(timesteps, np.float32).reshape(n)
        if self.model.family != "v4" and not np.all(ts == 0.5):
            raise ValueError(
                f"{self.model.name} ({self.model.family}) only supports "
                f"timestep 0.5; got {np.unique(ts)}")
        a, b = self._frames(in0), self._frames(in1)
        h, w = a.shape[1], a.shape[2]
        with torch.inference_mode():
            if self.model.family == "v4":
                return pipelines.forward_v4(
                    self.executor, self.weights["flownet"], a, b,
                    torch.from_numpy(ts).to(self.device), pad_to(h), pad_to(w),
                    self.dtype)
            return pipelines.forward_v2(self.executors, self.weights, a, b,
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
