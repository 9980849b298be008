"""Parser for ncnn text ``.param`` graph files (copy of
``rife_tpu/graph/param.py``).

Format:

    line 1: magic ``7767517``
    line 2: ``layer_count blob_count``
    lines:  ``Type  Name  #bottoms #tops  bottom... top...  key=value...``

Scalar params are ``id=int`` or ``id=float``; array params use negative ids
``-233xx`` where the stored id is ``-(id+23300)`` in ncnn's own tables, and the
value is ``count,v0,v1,...``.  We keep the raw negative id as the key.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Union

from .ir import Graph, LayerNode

NCNN_MAGIC = 7767517


def _parse_value(text: str) -> Union[int, float]:
    if any(c in text for c in ".eE") and not text.lstrip("+-").isdigit():
        return float(text)
    try:
        return int(text)
    except ValueError:
        return float(text)


def _parse_kv(token: str):
    key_s, _, val_s = token.partition("=")
    key = int(key_s)
    if key <= -23300:
        parts = val_s.split(",")
        count = int(parts[0])
        values = [_parse_value(v) for v in parts[1 : 1 + count]]
        if len(values) != count:
            raise ValueError(f"array param {token!r}: expected {count} values")
        return key, values
    return key, _parse_value(val_s)


# ncnn layer kinds the reference build enables that no shipped RIFE graph
# uses; a clear error at parse time instead of a KeyError mid-execution
_UNSUPPORTED_KINDS = frozenset(("Flatten", "Padding", "Cast", "Packing"))


def parse_param_text(text: str) -> Graph:
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines or int(lines[0]) != NCNN_MAGIC:
        raise ValueError("not an ncnn param file (bad magic)")
    layer_count, blob_count = (int(t) for t in lines[1].split())
    nodes: List[LayerNode] = []
    producer = {}
    input_blobs: List[str] = []
    for ln in lines[2 : 2 + layer_count]:
        toks = ln.split()
        ltype, lname = toks[0], toks[1]
        if ltype in _UNSUPPORTED_KINDS:
            raise ValueError(
                f"layer kind {ltype!r} ({lname}) is not supported: it is "
                f"enabled by the reference build but used by no shipped "
                f"RIFE model graph"
            )
        n_bottom, n_top = int(toks[2]), int(toks[3])
        pos = 4
        bottoms = toks[pos : pos + n_bottom]
        pos += n_bottom
        tops = toks[pos : pos + n_top]
        pos += n_top
        params = dict(_parse_kv(t) for t in toks[pos:])
        node = LayerNode(ltype, lname, bottoms, tops, params)
        idx = len(nodes)
        nodes.append(node)
        for slot, top in enumerate(tops):
            producer[top] = (idx, slot)
        if ltype == "Input":
            input_blobs.extend(tops)
    if len(nodes) != layer_count:
        raise ValueError(
            f"param declares {layer_count} layers, parsed {len(nodes)}"
        )
    if len(producer) != blob_count:
        raise ValueError(
            f"param declares {blob_count} blobs, parsed {len(producer)}"
        )
    return Graph(nodes=nodes, producer=producer, input_blobs=input_blobs)


def parse_param(path: Union[str, Path]) -> Graph:
    return parse_param_text(Path(path).read_text())
