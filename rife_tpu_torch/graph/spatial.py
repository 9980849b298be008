"""Height-sharded graph execution: ``SpatialExecutor``, the port's
counterpart of what GSPMD and ``jax_ops.warp_spatial`` do for
``rife_tpu``'s ``ShardedRIFE(height_axis=...)``.

``SpatialExecutor.run`` has ``Executor.run``'s signature (inputs, pinned
blobs included, in; named blobs out).  It cuts every (B,C,H,W) input into
row ranges, one per spatial shard, each on its shard's device, runs every
node on each shard, and gathers the requested outputs on the home device
(the device of the inputs).  Only a net's run is sharded: the pipelines
(``engine/pipelines.py``) keep the frame pre/post-processing, the TTA view
algebra, the ``-u`` halving and the flows passed between nets whole on the
home device, where they join the nets; the activations, which dominate
memory, live in the nets.

Row boundaries: the run's full-resolution rows (the tallest input) are cut
at multiples of ``ALIGN`` (32: the coarsest level of every ported net is
1/32 of its input), and every other blob's boundaries scale with its
height, so each level sees integral boundaries and no shard is empty at a
level once it has rows at full resolution.  A frame with fewer 32-row
blocks than shards leaves the surplus shards idle: they hold no rows and
run nothing (``rife_tpu`` pads such levels with edge rows instead; the rows
produced are the same).

Per layer kind (``ops/torch_ops.py`` ``OP_TABLE``):

* no halo: elementwise kinds, Concat/Slice/Split/Crop along channels or
  width, PixelShuffle (the shard's rows times r): the op on each shard;
  (B,C) vectors (the v1 SE gates) are replicated on the home device and
  moved to a shard where a ``BinaryOp`` broadcasts them; ``InnerProduct``
  runs once on them.  A Concat, Crop or Slice along the height raises.
* halo: convolutions (``Convolution``, ``ConvolutionCat``, ``rife.ConvPS``),
  transposed convolutions (``Deconvolution``, ``rife.DeconvPS``) and
  ``Interp``: each shard takes the rows its outputs read from its
  neighbours (a 3x3 s1 conv one row each side, s2 two rows above so that
  the window starts on an even row, the 4x4 s2 deconv one input row each
  side, a bilinear upsample one source row each side), runs the op on that
  window and keeps its own output rows.  The rows dropped are exactly those
  that zero padding or edge clamping touched at an inner boundary: padding
  and clamping act at the frame's edges only.  The downsamples need no halo
  (boundaries are multiples of the factor); nearest resize gathers its
  source rows by the global index formula.  The site gates see the whole
  blob's rows (ctx ``site_rows``), so a conv site takes ``conv3x3`` on
  every shard exactly when it does unsharded.
* global: ``Pooling`` (the v1 SE mean) takes f32 partial sums per shard,
  adds them on the home device, divides once and rounds once.
* warps: each shard gathers the whole source image on its device (one
  concatenation per blob and device) and samples its own output rows at
  global positions (``ops/warp.py`` ``warp_spatial``).  As in ``rife_tpu``
  the fused forms unfuse: ``WarpPair`` into two warps, ``WarpDs4`` /
  ``WarpDs4Pair`` into warps at the taps' absolute positions plus the two
  0.5/0.5 passes, ``RenderBlend`` into two warps and the blend on the
  shard, ``WarpDs2`` into a warp and the 1/2 downsample.

On one card named several times a shard's halo is a slice (or a small
concatenation) of its neighbours' tensors, never written in place; across
cards it is a ``.to(device)`` copy, ordered by the two devices' current
streams.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import torch

from ..ops import common as C
from ..ops import torch_ops as T
from ..ops import warp as W
from .executor import Executor

ALIGN = 32

# bytes a shard receives from other shards' rows, summed over the runs
# since the last reset: the rows its halos read ("halo") and the source
# rows of its warps that it does not hold ("gather").  Worked out from the
# shapes; on one card named several times nothing crosses a link.
TRAFFIC = {"halo": 0, "gather": 0}


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0


def _row_bytes(t: torch.Tensor) -> int:
    return t.shape[0] * t.shape[1] * t.shape[3] * t.element_size()

_CONVS = ("Convolution", "ConvolutionCat", "rife.ConvPS")
_DECONVS = ("Deconvolution", "rife.DeconvPS")
_WARPS = ("rife.Warp", "rife.WarpDs4", "rife.WarpDs2", "rife.WarpPair",
          "rife.WarpDs4Pair", "rife.RenderBlend")


class Rows:
    """A blob cut by rows: ``parts[k]`` holds rows ``starts[k]`` to
    ``starts[k + 1]`` of the whole (B,C,H,W) blob, on shard k's device."""

    __slots__ = ("parts", "starts")

    def __init__(self, parts: List[torch.Tensor]):
        self.parts = parts
        self.starts = [0]
        for p in parts:
            self.starts.append(self.starts[-1] + p.shape[2])

    @property
    def height(self) -> int:
        return self.starts[-1]

    @property
    def width(self) -> int:
        return self.parts[0].shape[3]

    def rows(self, lo: int, hi: int, device) -> torch.Tensor:
        """Rows [lo, hi) of the whole blob on ``device``."""
        pieces = []
        for p, s, e in zip(self.parts, self.starts, self.starts[1:]):
            a, b = max(lo, s), min(hi, e)
            if a < b:
                pieces.append(p[:, :, a - s:b - s].to(device,
                                                      non_blocking=True))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)


def shard_bounds(height: int, n: int) -> List[int]:
    """Row boundaries of the non-empty shards of a run whose tallest input
    has ``height`` rows: the ``height / ALIGN`` blocks dealt to ``n``
    shards as evenly as possible, empty shards dropped."""
    if height % ALIGN:
        raise ValueError(f"height sharding needs rows that are a multiple of "
                         f"{ALIGN}, got {height}")
    blocks = height // ALIGN
    return sorted({k * blocks // n * ALIGN for k in range(n + 1)})


def _conv_rows(node, s, e, h):
    """(window start, window end, output row of the window's first output,
    shard's output rows) of a convolution's shard [s, e) of h input rows."""
    _, k, d, st, p, _ = C.conv_hyperparams(node)
    if s % st:
        raise NotImplementedError(
            f"{node.type} {node.name}: stride {st} at a shard boundary on "
            f"row {s}")
    lo = -(-p // st) * st
    hi = max(0, (k - 1) * d + 1 - st - p)
    out_h = (h + 2 * p - (k - 1) * d - 1) // st + 1
    ws, we = max(0, s - lo), min(h, e + hi)
    return ws, we, ws // st, s // st, out_h if e == h else e // st


def _deconv_rows(node, s, e, h):
    _, k, d, st, p, _ = C.conv_hyperparams(node)
    ws = max(0, -(-(s * st + p - (k - 1) * d) // st))
    we = min(h, (e * st - 1 + p) // st + 1)
    out_h = (h - 1) * st + (k - 1) * d + 1 - 2 * p
    return ws, we, ws * st, s * st, out_h if e == h else e * st


class SpatialExecutor:
    """One net's ``Executor`` run height-sharded over ``devices`` (one per
    spatial shard, repeats allowed); ``weights[device]`` is the net's
    prepared weights on that device."""

    render_planar = False  # the render's planes would cut across shards

    def __init__(self, executor: Executor, devices: Sequence[torch.device],
                 weights: Mapping[torch.device, Any]):
        self.base = executor
        self.graph = executor.graph
        self.ctx = executor.ctx
        self.raw_weights = executor.raw_weights
        self.devices = [torch.device(d) for d in devices]
        self.weights = dict(weights)

    def run(self, inputs: Mapping[str, Any], outputs: Sequence[str],
            ctx: Dict[str, Any] | None = None) -> List[Any]:
        ctx = {**self.ctx, **ctx} if ctx else dict(self.ctx)
        ctx.pop("planar_outputs", None)
        tall = [v for v in inputs.values()
                if isinstance(v, torch.Tensor) and v.dim() == 4]
        if not tall:
            raise ValueError("a sharded run needs a (B,C,H,W) input")
        home = tall[0].device
        height = max(v.shape[2] for v in tall)
        bounds = shard_bounds(height, len(self.devices))
        run = _Run(self, ctx, home, bounds)
        blobs: Dict[str, Any] = {k: run.scatter(k, v, height)
                                 for k, v in inputs.items()}
        needed = self.graph.required_nodes(outputs, list(inputs.keys()))
        for idx in needed:
            node = self.graph.nodes[idx]
            if node.type == "Input":
                if node.tops[0] not in blobs:
                    raise KeyError(
                        f"graph input {node.tops[0]!r} not provided")
                continue
            if all(t in blobs for t in node.tops):
                continue
            if node.type not in self.base.op_table:
                raise NotImplementedError(f"layer type {node.type!r}")
            outs = run.node(node, [blobs[b] for b in node.bottoms])
            if len(outs) != len(node.tops):
                raise RuntimeError(
                    f"{node.type} {node.name}: produced {len(outs)} outputs, "
                    f"graph expects {len(node.tops)}")
            for top, val in zip(node.tops, outs):
                if top not in blobs:
                    blobs[top] = val
        return [run.gather(blobs[b]) for b in outputs]


class _Run:
    """The state of one sharded run: the shards' devices and contexts and
    the gathered warp sources."""

    def __init__(self, ex: SpatialExecutor, ctx, home, bounds):
        self.ex = ex
        self.ctx = ctx
        self.home = home
        self.bounds = bounds
        self.devices = ex.devices[:len(bounds) - 1]
        self.full: Dict[tuple, torch.Tensor] = {}

    # --- moving blobs ------------------------------------------------------

    def scatter(self, name, v, height):
        if not (isinstance(v, torch.Tensor) and v.dim() == 4):
            return v
        h = v.shape[2]
        if any(b * h % height for b in self.bounds):
            raise ValueError(f"input {name!r} of {h} rows cannot be cut at "
                             f"the run's boundaries {self.bounds}")
        edges = [b * h // height for b in self.bounds]
        return Rows([v[:, :, s:e].to(dev, non_blocking=True)
                     for dev, s, e in zip(self.devices, edges, edges[1:])])

    def gather(self, v):
        if isinstance(v, Rows):
            return v.rows(0, v.height, self.home)
        return v.to(self.home, non_blocking=True)

    def whole(self, blob: Rows, device) -> torch.Tensor:
        """The whole of ``blob`` on ``device``: the warp's all-gather, once
        per blob and device."""
        key = (id(blob), device)
        if key not in self.full:
            self.full[key] = blob.rows(0, blob.height, device).contiguous()
        return self.full[key]

    def shard_ctx(self, k, **extra):
        return {**self.ctx, "w": self.ex.weights[self.devices[k]], **extra}

    # --- nodes -------------------------------------------------------------

    def node(self, node, ins):
        kind = node.type
        fn = self.ex.base.op_table[kind]
        raw = self.ex.raw_weights.get(node.name)
        if not any(isinstance(v, Rows) for v in ins):
            # (B,C) vectors: replicated on the home device
            ctx = {**self.ctx, "w": self.ex.weights[self.home]}
            return fn(node, ins, raw, ctx)
        if kind in _CONVS or kind in _DECONVS:
            return [self._halo(node, ins, fn, raw)]
        if kind == "Interp":
            return [self._interp(node, ins[0])]
        if kind == "Pooling":
            return [self._pooling(node, ins[0])]
        if kind in _WARPS:
            return self._warp(node, ins)
        if kind in ("Concat", "Crop", "Slice"):
            self._check_axes(node, kind)
        outs = [fn(node, [v.parts[k] if isinstance(v, Rows)
                          else v.to(dev, non_blocking=True) for v in ins],
                   raw, self.shard_ctx(k))
                for k, dev in enumerate(self.devices)]
        return [Rows([o[i] for o in outs]) for i in range(len(outs[0]))]

    @staticmethod
    def _check_axes(node, kind):
        if kind == "Concat":
            axes = [int(node.p(0, 0))]
        elif kind == "Slice":
            axes = [int(node.p(1, 0))]
        else:
            axes = [int(a) for a in node.p(-23311, [])]
        if 1 in axes:  # ncnn CHW axis 1: the rows
            raise NotImplementedError(
                f"{kind} {node.name} along the height under height sharding")

    def _halo(self, node, ins, fn, raw):
        x = ins[0]
        h = x.height
        r = 1
        if node.type in ("rife.ConvPS", "rife.DeconvPS"):
            r = int(node.p(25, 2))
        rows = _deconv_rows if node.type in _DECONVS else _conv_rows
        parts = []
        for k, dev in enumerate(self.devices):
            s, e = x.starts[k], x.starts[k + 1]
            ws, we, o_ws, o_s, o_e = rows(node, s, e, h)
            win = [v.rows(ws, we, dev) for v in ins]
            TRAFFIC["halo"] += sum(_row_bytes(t) for t in win) * (
                we - ws - (e - s))
            y = fn(node, win, raw, self.shard_ctx(k, site_rows=h))[0]
            parts.append(y[:, :, r * (o_s - o_ws):r * (o_e - o_ws)])
        return Rows(parts)

    def _interp(self, node, x: Rows):
        h, w = x.height, x.width
        rtype, oh, ow = C.interp_out_size(h, w, node)
        parts = []
        for k, dev in enumerate(self.devices):
            s, e = x.starts[k], x.starts[k + 1]
            if rtype == 1:
                # the global source row of each output row, as
                # resize_nearest computes it
                o_s, o_e = s * oh // h, e * oh // h
                pos = (torch.arange(oh, dtype=torch.float32) + 0.5) * h / oh
                idx = torch.floor(pos).long()[o_s:o_e]
                lo, hi = int(idx.min()), int(idx.max()) + 1
                y = x.rows(lo, hi, dev)
                TRAFFIC["halo"] += _row_bytes(y) * (
                    max(hi, e) - min(lo, s) - (e - s))
                y = y.index_select(2, (idx - lo).to(dev))
                parts.append(T.resize_nearest(y, o_e - o_s, ow))
                continue
            if rtype != 2:
                raise NotImplementedError(f"Interp resize_type {rtype}: only "
                                          f"nearest and bilinear are ported")
            if oh > h:  # upsample: one source row each side
                n = oh // h
                ws, we = max(0, s - 1), min(h, e + 1)
                y = x.rows(ws, we, dev)
                TRAFFIC["halo"] += _row_bytes(y) * (we - ws - (e - s))
                y = T.resize2d(y, n * (we - ws), ow)
                parts.append(y[:, :, n * (s - ws):n * (e - ws)])
            else:  # same rows or a downsample: boundaries are multiples
                n = h // oh
                if s % n or e % n:
                    raise NotImplementedError(
                        f"Interp {node.name}: 1/{n} at a shard boundary on "
                        f"row {s} or {e}")
                parts.append(T.resize2d(x.parts[k], (e - s) // n, ow))
        return Rows(parts)

    def _pooling(self, node, x: Rows):
        """Global average pooling: f32 partial sums per shard, added on the
        home device, divided once and rounded once (``_op_pooling``)."""
        if int(node.p(4, 0)) != 1 or int(node.p(0, 0)) != 1:
            raise NotImplementedError("only global average pooling is used "
                                      "by the zoo")
        total = None
        for p in x.parts:
            part = torch.sum(p, dim=(2, 3), dtype=torch.float32).to(
                self.home, non_blocking=True)
            total = part if total is None else total + part
        return (total / (x.height * x.width)).to(x.parts[0].dtype)

    # --- warps -------------------------------------------------------------

    def _single(self, node, image: Rows, flow: Rows, blob, ds4=False):
        if (image.height, image.width) != (flow.height, flow.width):
            raise ValueError(
                f"{node.type} {node.name}: flow {flow.height}x{flow.width} "
                f"is not on the grid of image {image.height}x{image.width}")
        u8 = T._is_u8(blob, image.parts[0], self.ctx)
        if ds4 and (image.height % 4 or image.width % 4
                    or any(s % 4 for s in image.starts)):
            raise NotImplementedError(
                f"{node.type} {node.name}: the 1/4 warp needs rows, columns "
                f"and shard boundaries that are multiples of 4")
        parts = []
        for k, dev in enumerate(self.devices):
            full = self.whole(image, dev)
            TRAFFIC["gather"] += _row_bytes(full) * (
                image.height - image.parts[k].shape[2])
            parts.append(W.warp_spatial(full, flow.parts[k].contiguous(),
                                        image.starts[k], u8=u8, ds4=ds4))
        return Rows(parts)

    def _warp(self, node, ins):
        kind, b = node.type, node.bottoms
        if kind in ("rife.Warp", "rife.WarpDs4"):
            return [self._single(node, ins[0], ins[1], b[0],
                                 ds4=kind == "rife.WarpDs4")]
        if kind in ("rife.WarpPair", "rife.WarpDs4Pair"):
            ds4 = kind == "rife.WarpDs4Pair"
            return [self._single(node, ins[0], ins[1], b[0], ds4=ds4),
                    self._single(node, ins[2], ins[3], b[2], ds4=ds4)]
        if kind == "rife.WarpDs2":
            y = self._single(node, ins[0], ins[1], b[0])
            if y.width % 2 or any(s % 2 for s in y.starts):
                raise NotImplementedError(
                    f"{kind} {node.name}: odd columns or shard boundary")
            return [Rows([T.resize2d(p, p.shape[2] // 2, p.shape[3] // 2)
                          for p in y.parts])]
        # rife.RenderBlend: both warps, then the blend on each shard
        wm = self._single(node, ins[0], ins[1], b[0])
        wi = self._single(node, ins[2], ins[3], b[2])
        mask = ins[4]
        return [Rows([m_ * mk + i_ * (1 - mk) for m_, i_, mk in
                      zip(wm.parts, wi.parts, mask.parts)])]
