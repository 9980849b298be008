"""Reader for ncnn ``.bin`` weight streams + deterministic synthetic weights
(copy of ``rife_tpu/graph/weights.py``, trimmed to what the port runs).

Binary format:

* the stream is a flat concatenation of per-layer arrays in param-file order;
* Convolution / Deconvolution / InnerProduct weight arrays are preceded by a
  little-endian u32 *flag*: ``0`` = raw fp32, ``0x01306B47`` = fp16 payload
  (padded to 4-byte alignment), ``0x000D4B38`` = int8 (not used by the zoo);
* bias arrays (Convolution/Deconvolution with ``5=1``) and PReLU slopes are
  raw fp32 with **no** flag.

Weight tensor layouts (as flattened in the stream):

* Convolution:    (out_ch, in_ch, kh, kw)
* Deconvolution:  (in_ch, out_ch, kh, kw) — torch ``ConvTranspose2d`` order
* InnerProduct:   (out_features, in_features)
* PReLU:          (num_slopes,)

``in_ch`` is never stated in the param file; it is recovered from
``weight_data_size / (out_ch * kh * kw)`` exactly as ncnn does.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

from .ir import Graph, LayerNode

FLAG_FP32 = 0
FLAG_FP16 = 0x01306B47

SYNTH_MODES = ("mix", "iid")


class _BinReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(
                f"bin underrun: need {n} bytes at offset {self.pos}, "
                f"file has {len(self.data)}"
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_flagged(self, count: int) -> np.ndarray:
        flag = int(np.frombuffer(self._take(4), dtype="<u4")[0])
        if flag == FLAG_FP32:
            return np.frombuffer(self._take(count * 4), dtype="<f4").copy()
        if flag == FLAG_FP16:
            nbytes = count * 2
            aligned = (nbytes + 3) // 4 * 4
            raw = self._take(aligned)[:nbytes]
            return np.frombuffer(raw, dtype="<f2").astype(np.float32)
        raise ValueError(f"unsupported weight flag 0x{flag:08X} at {self.pos - 4}")

    def read_raw_f32(self, count: int) -> np.ndarray:
        return np.frombuffer(self._take(count * 4), dtype="<f4").copy()

    @property
    def fully_consumed(self) -> bool:
        return self.pos == len(self.data)


@dataclass
class LayerWeights:
    """Arrays for one layer, in canonical (ncnn-order) numpy form."""

    weight: Optional[np.ndarray] = None
    bias: Optional[np.ndarray] = None
    slope: Optional[np.ndarray] = None


def _conv_shapes(node: LayerNode) -> Tuple[int, int, int]:
    out_ch = int(node.p(0))
    k = int(node.p(1))
    wsize = int(node.p(6))
    in_ch = wsize // (out_ch * k * k)
    if in_ch * out_ch * k * k != wsize:
        raise ValueError(f"{node.name}: weight size {wsize} not divisible")
    return out_ch, in_ch, k


def _load_layer(node: LayerNode, reader: _BinReader) -> Optional[LayerWeights]:
    if node.type == "Convolution":
        out_ch, in_ch, k = _conv_shapes(node)
        w = reader.read_flagged(out_ch * in_ch * k * k).reshape(out_ch, in_ch, k, k)
        b = reader.read_raw_f32(out_ch) if int(node.p(5)) == 1 else None
        return LayerWeights(weight=w, bias=b)
    if node.type == "Deconvolution":
        out_ch, in_ch, k = _conv_shapes(node)
        w = reader.read_flagged(in_ch * out_ch * k * k).reshape(in_ch, out_ch, k, k)
        b = reader.read_raw_f32(out_ch) if int(node.p(5)) == 1 else None
        return LayerWeights(weight=w, bias=b)
    if node.type == "InnerProduct":
        out_f = int(node.p(0))
        wsize = int(node.p(2))
        in_f = wsize // out_f
        w = reader.read_flagged(wsize).reshape(out_f, in_f)
        b = reader.read_raw_f32(out_f) if int(node.p(1)) == 1 else None
        return LayerWeights(weight=w, bias=b)
    if node.type == "PReLU":
        n = int(node.p(0))
        return LayerWeights(slope=reader.read_raw_f32(n))
    return None


def load_bin(graph: Graph, path: Union[str, Path]) -> Dict[str, LayerWeights]:
    """Bind a .bin stream to ``graph``; returns layer-name -> weights."""
    reader = _BinReader(Path(path).read_bytes())
    out: Dict[str, LayerWeights] = {}
    for node in graph.nodes:
        lw = _load_layer(node, reader)
        if lw is not None:
            out[node.name] = lw
    if not reader.fully_consumed:
        raise ValueError(
            f"{path}: {len(reader.data) - reader.pos} trailing bytes unread"
        )
    return out


def _seed_for(tag: str) -> int:
    return int.from_bytes(hashlib.sha256(tag.encode()).digest()[:4], "little")


# Global weight multipliers for synthetic flownets, calibrated so the final
# flow magnitude is a realistic ~10 px (raw He-init explodes ~15x per pyramid
# level through the residual trunks).  Baked from the JAX package's
# calibration (``rife_tpu/models/calibrate.py``).
SYNTHETIC_FLOWNET_SCALE = {
    "rife": 0.9512, "rife-HD": 0.9712, "rife-UHD": 0.9179,
    "rife-anime": 0.924, "rife-v2": 1.3172, "rife-v2.3": 1.1953,
    "rife-v2.4": 1.2594, "rife-v3.0": 1.1814, "rife-v3.1": 1.1601,
    "rife-v4": 1.0579, "rife-v4.6": 0.7155,
}


# Global multipliers for synthetic fusionnets (flow-rendering U-Nets),
# calibrated so the final u8 output std is image-like (~60) instead of a
# saturated black frame.  Baked from the same calibration.
SYNTHETIC_FUSIONNET_SCALE = {
    "rife": 1.6218, "rife-HD": 0.9866, "rife-UHD": 0.9866,
    "rife-anime": 0.8435, "rife-v2": 1.6218, "rife-v2.3": 0.3038,
    "rife-v2.4": 0.427, "rife-v3.0": 0.702, "rife-v3.1": 0.427,
}


def _weight_scale_for(tag: str) -> float:
    model, _, net = tag.partition("/")
    if net == "flownet":
        return SYNTHETIC_FLOWNET_SCALE.get(model, 1.0)
    if net == "fusionnet":
        return SYNTHETIC_FUSIONNET_SCALE.get(model, 1.0)
    return 1.0


def _binomial_envelope(k: int) -> np.ndarray:
    """k x k normalized binomial (approx. Gaussian) low-pass stencil."""
    row = np.array([math.comb(k - 1, i) for i in range(k)], np.float64)
    g = np.outer(row, row)
    return (g / g.sum()).astype(np.float32)


def synthesize_weights(graph: Graph, tag: str,
                       mode: str = "mix") -> Dict[str, LayerWeights]:
    """Deterministic random weights for graphs whose .bin is absent.

    Shapes/dtypes are exactly what ``load_bin`` would produce.  ``mode``:

    * ``mix`` (default) — delta spatial taps for convolutions (pure random
      channel mixing, so the calibrated scale transfers across resolutions)
      + a binomial envelope for deconvolutions (the k=4 s2 stencil is the
      bilinear x2 kernel), deconv output channels tied in groups of 4 (no
      checkerboard through a PixelShuffle head): smooth, trained-model-like
      flow fields;
    * ``iid`` — He-init iid taps: spatially white flows, the adversarial
      worst case (the JAX package's ``RIFE_TPU_SYNTH_MODE=iid``).
    """
    if mode not in SYNTH_MODES:
        raise ValueError(f"synthesis mode {mode!r}: one of {SYNTH_MODES}")
    out: Dict[str, LayerWeights] = {}
    wscale = _weight_scale_for(tag)
    for node in graph.nodes:
        rng = np.random.default_rng(_seed_for(f"{tag}:{node.name}"))
        if node.type in ("Convolution", "Deconvolution"):
            out_ch, in_ch, k = _conv_shapes(node)
            fan_in = in_ch * k * k
            shape = (
                (out_ch, in_ch, k, k)
                if node.type == "Convolution"
                else (in_ch, out_ch, k, k)
            )
            if mode == "iid":
                std = float(np.sqrt(2.0 / fan_in)) * wscale
                w = rng.normal(0.0, std, size=shape).astype(np.float32)
            else:
                std = float(np.sqrt(2.0 / in_ch)) * wscale
                mix = rng.normal(0.0, std, size=(out_ch, in_ch)).astype(
                    np.float32
                )
                if node.type == "Deconvolution" and out_ch % 4 == 0:
                    mix = np.repeat(mix[::4], 4, axis=0)
                if node.type == "Convolution":
                    env = np.zeros((k, k), np.float32)
                    env[(k - 1) // 2, (k - 1) // 2] = 1.0
                else:
                    env = _binomial_envelope(k)
                w = mix[:, :, None, None] * env[None, None]
                if node.type == "Deconvolution":
                    w = np.ascontiguousarray(np.swapaxes(w, 0, 1))
            b = (
                np.zeros(out_ch, dtype=np.float32)
                if int(node.p(5)) == 1
                else None
            )
            out[node.name] = LayerWeights(weight=w, bias=b)
        elif node.type == "InnerProduct":
            out_f = int(node.p(0))
            in_f = int(node.p(2)) // out_f
            std = float(np.sqrt(2.0 / in_f)) * wscale
            w = rng.normal(0.0, std, size=(out_f, in_f)).astype(np.float32)
            b = np.zeros(out_f, dtype=np.float32) if int(node.p(1)) == 1 else None
            out[node.name] = LayerWeights(weight=w, bias=b)
        elif node.type == "PReLU":
            n = int(node.p(0))
            out[node.name] = LayerWeights(
                slope=np.full(n, 0.25, dtype=np.float32)
            )
    return out
