"""ncnn model files: the ``.param`` text parser and the ``.bin`` weight
stream, read and written.

A frozen copy of the format rules of the program's ``graph/param.py`` and
``graph/weights.py``, so that the benchmark's reference and work counts read
a model without the program.  Format:

* ``.param``: magic ``7767517``, ``layer_count blob_count``, then one line a
  layer: ``Type Name #bottoms #tops bottom... top... key=value...``; array
  params take negative ids (``-233xx``) and the value ``count,v0,v1,...``;
* ``.bin``: per layer in file order, a Convolution/Deconvolution/
  InnerProduct weight preceded by a little-endian u32 flag (``0`` fp32,
  ``0x01306B47`` fp16, padded to 4 bytes), then its f32 bias (``5=1``; an
  InnerProduct's ``1=1``) with no flag; a PReLU's f32 slopes with no flag.
  Convolution weights are (out, in, k, k), Deconvolution weights
  (in, out, k, k); ``in`` is ``6=`` / (out * k * k).  InnerProduct weights
  are (out, in); ``out`` is ``0=``, ``in`` is ``2=`` / out.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

MAGIC = 7767517
FLAG_FP32 = 0
FLAG_FP16 = 0x01306B47


@dataclass
class Node:
    type: str
    name: str
    bottoms: List[str]
    tops: List[str]
    params: Dict[int, object] = field(default_factory=dict)

    def p(self, pid: int, default=0):
        return self.params.get(pid, default)


def _value(text: str):
    if any(c in text for c in ".eE") and not text.lstrip("+-").isdigit():
        return float(text)
    try:
        return int(text)
    except ValueError:
        return float(text)


def _kv(token: str):
    key_s, _, val_s = token.partition("=")
    key = int(key_s)
    if key <= -23300:
        parts = val_s.split(",")
        count = int(parts[0])
        values = [_value(v) for v in parts[1:1 + count]]
        if len(values) != count:
            raise ValueError(f"array param {token!r}: expected {count} values")
        return key, values
    return key, _value(val_s)


def parse_param_text(text: str) -> List[Node]:
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines or int(lines[0]) != MAGIC:
        raise ValueError("not an ncnn param file (bad magic)")
    n_layers, n_blobs = (int(t) for t in lines[1].split())
    nodes, blobs = [], set()
    for ln in lines[2:2 + n_layers]:
        toks = ln.split()
        nb, nt = int(toks[2]), int(toks[3])
        bottoms = toks[4:4 + nb]
        tops = toks[4 + nb:4 + nb + nt]
        params = dict(_kv(t) for t in toks[4 + nb + nt:])
        nodes.append(Node(toks[0], toks[1], bottoms, tops, params))
        blobs.update(tops)
    if len(nodes) != n_layers or len(blobs) != n_blobs:
        raise ValueError(f"param declares {n_layers} layers / {n_blobs} "
                         f"blobs, parsed {len(nodes)} / {len(blobs)}")
    return nodes


def parse_param(path: Union[str, Path]) -> List[Node]:
    return parse_param_text(Path(path).read_text())


def conv_shape(node: Node):
    """(out, in, k) of a Convolution or Deconvolution node."""
    out_ch, k, size = int(node.p(0)), int(node.p(1)), int(node.p(6))
    in_ch = size // (out_ch * k * k)
    if in_ch * out_ch * k * k != size:
        raise ValueError(f"{node.name}: weight size {size} not divisible")
    return out_ch, in_ch, k


@dataclass
class LayerWeights:
    weight: Optional[np.ndarray] = None
    bias: Optional[np.ndarray] = None
    slope: Optional[np.ndarray] = None


def inner_shape(node: Node):
    """(out, in) of an InnerProduct node."""
    out_ch, size = int(node.p(0)), int(node.p(2))
    if out_ch <= 0 or size % out_ch:
        raise ValueError(f"{node.name}: weight size {size} not divisible")
    return out_ch, size // out_ch


def bias_size(node: Node) -> int:
    """The number of f32 biases a weighted node stores after its weight."""
    if node.type == "InnerProduct":
        return inner_shape(node)[0] if int(node.p(1)) == 1 else 0
    return conv_shape(node)[0] if int(node.p(5)) == 1 else 0


def weight_shape(node: Node):
    """The stored shape of a weighted node's weight, or None."""
    if node.type == "InnerProduct":
        return inner_shape(node)
    if node.type not in ("Convolution", "Deconvolution"):
        return None
    out_ch, in_ch, k = conv_shape(node)
    if node.type == "Convolution":
        return (out_ch, in_ch, k, k)
    return (in_ch, out_ch, k, k)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"bin underrun at {self.pos} (+{n})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def flagged(self, count: int) -> np.ndarray:
        flag = int(np.frombuffer(self.take(4), "<u4")[0])
        if flag == FLAG_FP32:
            return np.frombuffer(self.take(4 * count), "<f4").copy()
        if flag == FLAG_FP16:
            raw = self.take((2 * count + 3) // 4 * 4)[:2 * count]
            return np.frombuffer(raw, "<f2").astype(np.float32)
        raise ValueError(f"unsupported weight flag 0x{flag:08X}")

    def raw(self, count: int) -> np.ndarray:
        return np.frombuffer(self.take(4 * count), "<f4").copy()


def read_bin(nodes: List[Node], path: Union[str, Path]) -> Dict[str, LayerWeights]:
    r = _Reader(Path(path).read_bytes())
    out = {}
    for node in nodes:
        shape = weight_shape(node)
        if shape is not None:
            w = r.flagged(int(np.prod(shape))).reshape(shape)
            b = r.raw(bias_size(node)) if bias_size(node) else None
            out[node.name] = LayerWeights(weight=w, bias=b)
        elif node.type == "PReLU":
            out[node.name] = LayerWeights(slope=r.raw(int(node.p(0))))
    if r.pos != len(r.data):
        raise ValueError(f"{path}: {len(r.data) - r.pos} trailing bytes")
    return out


def bin_bytes(nodes: List[Node], weights: Dict[str, LayerWeights]) -> bytes:
    """The ``.bin`` stream of ``weights``: weights fp16-flagged (as the
    zoo's files store them), biases and slopes f32."""
    parts = []
    for node in nodes:
        lw = weights.get(node.name)
        if weight_shape(node) is not None:
            w = np.ascontiguousarray(lw.weight, "<f2")
            pad = (-w.nbytes) % 4
            parts += [np.uint32(FLAG_FP16).astype("<u4").tobytes(),
                      w.tobytes(), b"\0" * pad]
            if bias_size(node):
                parts.append(np.ascontiguousarray(lw.bias, "<f4").tobytes())
        elif node.type == "PReLU":
            parts.append(np.ascontiguousarray(lw.slope, "<f4").tobytes())
    return b"".join(parts)
