"""RIFE session on PyTorch (port of ``rife_tpu/engine/session.py``, the v4,
v2 and v1 families, plain 2x, the ``-x``/``-z`` TTA modes and UHD ``-u``).

One session owns the model's nets after the rewrite chain, their weights on
the session's device, and one ``Executor`` per net over
``torch_ops.OP_TABLE`` (``graph/``: the port's own copies of the JAX
package's graph layer).  ``process_batch`` takes (B,H,W,3) u8 frame pairs and
(B,) timesteps and returns (B,H,W,3) u8 frames.

The v4 nets run as the TPU runs them, NHWC-style: every conv on cuDNN.  The
v1/v2/v3 nets run with ctx ``planar_convs``, because the TPU runs them on
its planar executors: the conv sites that those send to the Pallas planar
convs take the ``conv3x3`` kernel (``ops/conv.py``), its PixelShuffle
sites ``conv3x3_ps``.

``fuse_ds2`` is the JAX session's ``RIFE_TPU_FUSE_DS2=1``: the exact rewrite
of each warp-then-1/2-downscale into ``rife.WarpDs2`` (K3 on a frame copy).
Off by default, as there; the port reads no ``RIFE_TPU_*`` variable.

``uhd_mode`` (``-u``) runs the v1/v2 flownet on frames halved by
``resize2d`` (``engine/pipelines.py``); it is ignored for the v4 family, as
in the JAX session.  Left out, as TPU-only machinery: planar/region
executors, the warp-variant probe, the compile cache.

Each step records spans (``utils/profiling.py``), id the session's step
number: ``session.step`` (``process_batch_device``) holding
``session.upload`` (both inputs onto the device) and ``session.forward``
(holding each net's ``executor.run``); ``process_batch`` adds
``session.wait`` (until the step's work is done) and ``session.download``.
On a card a CUDA timing-event pair brackets ``session.forward`` on the
current stream (``EventTimer``), kept with the ``session.step`` span.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..graph.executor import Executor
from ..graph.rewrite import (
    fuse_concat_into_convs,
    fuse_pixelshuffle_into_convs,
    fuse_prelu_activations,
    fuse_quarter_downscaled_warps,
    fuse_render_blend,
    fuse_sibling_warps,
    push_concat_through_interp,
)
from ..models.zoo import load_model
from ..ops import torch_ops
from ..utils.profiling import EventTimer, span
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


def rewrite_flownet(graph, weights, fuse_ds2: bool = False):
    """The rewrite chain of the TPU defaults (``rife_tpu`` session.py:159-247)
    for a v4 flownet; every rewrite is exact.  ``push_concat_through_interp``
    stays off for v4, as there.  ``fuse_ds2``: fuse warp + 1/2 downscale
    pairs too (``RIFE_TPU_FUSE_DS2``)."""
    protected = _EXTRACTABLE["flownet"]
    graph = fuse_quarter_downscaled_warps(graph, protected, fuse_half=fuse_ds2)
    graph, weights = fuse_prelu_activations(graph, weights, protected)
    graph = fuse_concat_into_convs(graph, protected, flatten_nested=False)
    graph = fuse_pixelshuffle_into_convs(graph, protected)
    graph = fuse_render_blend(graph, protected)
    graph = fuse_sibling_warps(graph)
    return graph, weights


def rewrite_planar_net(name, graph, weights, fuse_ds2: bool = False):
    """The same chain for a net the TPU runs on its planar executor (every
    v1/v2/v3 net): nested block-entry concats flatten into the conv's parts,
    and downscale ``Interp`` nodes are pushed through concats."""
    protected = _EXTRACTABLE[name]
    graph = fuse_quarter_downscaled_warps(graph, protected, fuse_half=fuse_ds2)
    graph, weights = fuse_prelu_activations(graph, weights, protected)
    graph = fuse_concat_into_convs(graph, protected, flatten_nested=True)
    graph = push_concat_through_interp(graph, protected)
    graph = fuse_pixelshuffle_into_convs(graph, protected)
    graph = fuse_render_blend(graph, protected)
    graph = fuse_sibling_warps(graph)
    return graph, weights


class RIFE:
    """Frame-interpolation session for the v4, v2/v3 and v1 families.

    ``device`` defaults to "cuda" ("cuda:1", "cpu" on request); asking for
    CUDA without a card raises.  ``dtype`` defaults to bf16 on CUDA and f32
    on the CPU.  ``tta_mode`` (-x), ``tta_temporal_mode`` (-z) and
    ``uhd_mode`` (-u) mirror the reference ctor; ``fuse_ds2`` is the
    ``RIFE_TPU_FUSE_DS2`` rewrite (module docstring)."""

    def __init__(self, model: str = "rife-v2.3", *, device="cuda",
                 dtype: Optional[torch.dtype] = None, model_root=None,
                 tta_mode: bool = False, tta_temporal_mode: bool = False,
                 uhd_mode: bool = False, fuse_ds2: bool = False):
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.model = load_model(model, model_root)
        family = self.model.family
        self.tta_mode = tta_mode
        self.tta_temporal_mode = tta_temporal_mode
        # the v4 family ignores -u (rife_tpu session.py:102)
        self.uhd_mode = uhd_mode and family != "v4"
        self.executors = {}
        self.weights = {}
        for name, net in self.model.nets.items():
            if family == "v4":
                graph, weights = rewrite_flownet(net.graph, net.weights,
                                                 fuse_ds2=fuse_ds2)
            else:
                graph, weights = rewrite_planar_net(name, net.graph,
                                                    net.weights,
                                                    fuse_ds2=fuse_ds2)
            ex = Executor(graph, torch_ops.OP_TABLE, weights, ctx={
                "u8_image_blobs": frozenset(
                    graph.value_copies_of(_IMG_SEEDS.get(name, ()))),
                "planar_convs": family != "v4",
            }, name=name)
            ex.render_planar = any(
                n.type == "rife.RenderBlend" for n in graph.nodes)
            self.executors[name] = ex
            self.weights[name] = torch_ops.prepare_weights(
                graph, weights, self.dtype, self.device)
        self._steps = itertools.count()
        self._timer = (EventTimer() if self.device.type == "cuda"
                       else None)

    @property
    def executor(self) -> Executor:
        """The flownet's executor (the v4 family's only net)."""
        return self.executors["flownet"]

    @staticmethod
    def frames_on(x, device) -> torch.Tensor:
        """(B,H,W,3) u8 frames (numpy or a tensor) on ``device``."""
        t = torch.as_tensor(x)
        if t.dtype != torch.uint8 or t.dim() != 4 or t.shape[-1] != 3:
            raise ValueError(f"frames must be (B,H,W,3) uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
        return t.to(device, non_blocking=True)

    def timesteps_of(self, in0, in1, timesteps) -> np.ndarray:
        """The (B,) f32 timesteps of a batch, after the checks of
        ``process_batch_device``."""
        if tuple(in0.shape) != tuple(in1.shape):
            raise ValueError(f"frame shape mismatch: {tuple(in0.shape)} vs "
                             f"{tuple(in1.shape)}")
        n = in0.shape[0]
        ts = np.asarray(timesteps, np.float32).reshape(n)
        if self.model.family != "v4" and not np.all(ts == 0.5):
            raise ValueError(
                f"{self.model.name} ({self.model.family}) only supports "
                f"timestep 0.5; got {np.unique(ts)}")
        return ts

    def process_batch_device(self, in0, in1, timesteps) -> torch.Tensor:
        """(B,H,W,3) u8 pairs (numpy or tensors) + (B,) timesteps -> the u8
        result as a tensor on the session's device, without synchronising.

        The v1 and v2 families interpolate the midpoint only: any timestep
        other than 0.5 raises ``ValueError`` (``rife_tpu``
        session.py:471-477)."""
        return self._step(in0, in1, timesteps)[0]

    def _step(self, in0, in1, timesteps):
        """``process_batch_device``'s result, its step number and an event
        recorded after it on the card (None on the CPU or where the step
        went untimed)."""
        n = next(self._steps)
        with span("session.step", n) as step:
            ts = self.timesteps_of(in0, in1, timesteps)
            with span("session.upload", n):
                a = self.frames_on(in0, self.device)
                b = self.frames_on(in1, self.device)
            if self._timer is not None:
                stream = torch.cuda.current_stream(self.device)
                pair = self._timer.start(stream)
            else:
                pair = None
            with span("session.forward", n):
                out = self.forward(a, b, ts, self.executors, self.weights)
            done = (self._timer.stop(pair, stream, step.seq)
                    if pair is not None else None)
        return out, n, done

    def forward(self, a: torch.Tensor, b: torch.Tensor, ts: np.ndarray,
                executors, weights) -> torch.Tensor:
        """One step of the session's pipeline on u8 frames ``a``, ``b``
        (already on their device) with ``executors`` (an ``Executor`` or a
        ``graph/spatial.py`` ``SpatialExecutor`` per net) and ``weights``
        (the prepared weights per net on the frames' device):
        ``parallel/sharding.py`` runs each shard through it."""
        h, w = a.shape[1], a.shape[2]
        device = a.device
        modes = {"tta": self.tta_mode, "temporal": self.tta_temporal_mode}
        with torch.inference_mode():
            if self.model.family == "v4":
                t = torch.from_numpy(ts)
                if device.type == "cuda":
                    # from pageable memory the copy would wait for the
                    # stream's earlier work; pinned, the step is queued
                    # behind the batch still running
                    t = t.pin_memory()
                return pipelines.forward_v4(
                    executors["flownet"], weights["flownet"], a, b,
                    t.to(device, non_blocking=True), pad_to(h), pad_to(w),
                    self.dtype, **modes)
            return pipelines.forward_v1v2(executors, weights,
                                          self.model.family, a, b, pad_to(h),
                                          pad_to(w), self.dtype,
                                          uhd=self.uhd_mode, **modes)

    def process_batch(self, in0, in1, timesteps) -> np.ndarray:
        """Interpolate a batch: (B,H,W,3) u8 pairs + (B,) timesteps -> u8."""
        out, n, done = self._step(in0, in1, timesteps)
        with span("session.wait", n):
            if done is None and out.is_cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(out.device))
            if done is not None:
                done.synchronize()
        with span("session.download", n):
            return out.cpu().numpy()

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
