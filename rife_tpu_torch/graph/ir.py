"""Graph IR for ncnn-format model graphs (copy of ``rife_tpu/graph/ir.py``).

A list of layer nodes in file order (always topological in ncnn param
files) plus blob-name bookkeeping.  Execution and weight binding live in
``graph/executor.py`` and ``graph/weights.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple, Union

ParamValue = Union[int, float, List[int], List[float]]


@dataclass
class LayerNode:
    """One layer line of a .param file.

    ``params`` maps the integer param id to its value.  Array params use the
    ncnn convention of negative ids (-233xx) and decode to Python lists.
    """

    type: str
    name: str
    bottoms: List[str]
    tops: List[str]
    params: Dict[int, ParamValue] = field(default_factory=dict)

    def p(self, pid: int, default: ParamValue = 0) -> ParamValue:
        return self.params.get(pid, default)


@dataclass
class Graph:
    """A parsed model graph.

    * ``nodes`` — layers in param-file order (topological).
    * ``producer`` — blob name -> (node index, output slot).
    * ``input_blobs`` — blobs produced by ``Input`` layers.
    """

    nodes: List[LayerNode]
    producer: Dict[str, Tuple[int, int]]
    input_blobs: List[str]

    def required_nodes(
        self,
        outputs: Sequence[str],
        provided: Sequence[str],
    ) -> List[int]:
        """Node indices (topological order) needed to compute ``outputs``.

        ``provided`` blobs are treated as already materialised: traversal stops
        there (ncnn Extractor semantics; the v4 TTA path re-injects the
        pyramid taps flow0..flow3 this way).
        """
        provided_set: Set[str] = set(provided)
        needed: Set[int] = set()
        stack: List[str] = [b for b in outputs if b not in provided_set]
        visited_blobs: Set[str] = set(provided_set)
        while stack:
            blob = stack.pop()
            if blob in visited_blobs:
                continue
            visited_blobs.add(blob)
            if blob not in self.producer:
                raise KeyError(f"blob {blob!r} has no producer and was not provided")
            node_idx, _ = self.producer[blob]
            if node_idx in needed:
                continue
            needed.add(node_idx)
            node = self.nodes[node_idx]
            for b in node.bottoms:
                if b not in visited_blobs:
                    stack.append(b)
        return sorted(needed)

    def value_copies_of(
        self, seeds: Sequence[str], seed_channels: int = 3
    ) -> Set[str]:
        """Blobs whose values are exact channel-rearrangements of ``seeds``.

        Tracks per-blob channel *segments* ``(seed, nch)`` through the pure
        data-movement layers — ``Split`` (fan-out copy), scale-1 ``Interp``,
        channel-axis ``Concat``, and channel-axis ``Crop``/``Slice`` whose cut
        points land on segment boundaries.  A blob qualifies when every one
        of its channels comes verbatim from some seed (the v2/v3 flownet
        pattern ``Crop(Split(Concat(input0, input1)))``), so such warps keep
        the u8-origin kernels.

        ``seed_channels`` is the channel count of every seed blob (the
        engine's seeds are always 3-channel RGB frames); the IR itself
        carries no shapes, and concat/crop arithmetic needs widths.
        """
        present = lambda b: b in self.producer or b in self.input_blobs  # noqa: E731
        segments: Dict[str, Tuple[Tuple[str, int], ...]] = {
            s: ((s, seed_channels),) for s in seeds if present(s)
        }

        def crop_like(segs, start: int, end: int):
            """Slice a segment tuple at channel [start, end); None unless the
            cuts align with segment boundaries."""
            out: List[Tuple[str, int]] = []
            off = 0
            for name, nch in segs:
                if off >= end:
                    break
                if off >= start:
                    if off + nch > end:
                        return None  # cut mid-segment
                    out.append((name, nch))
                elif off + nch > start:
                    return None  # cut mid-segment
                off += nch
            total = sum(n for _, n in out)
            if total != end - start:
                return None  # ran past the known channels
            return tuple(out)

        for node in self.nodes:  # param order is topological
            if node.type == "Split":
                src = segments.get(node.bottoms[0])
                if src is not None:
                    for t in node.tops:
                        segments[t] = src
            elif node.type == "Interp" and float(node.p(1, 1.0)) == 1.0 \
                    and float(node.p(2, 1.0)) == 1.0 and not node.p(3, 0) \
                    and not node.p(4, 0):
                # scale-1 resize with no fixed output size: identity
                src = segments.get(node.bottoms[0])
                if src is not None:
                    segments[node.tops[0]] = src
            elif node.type == "Concat" and int(node.p(0, 0)) == 0:
                parts = [segments.get(b) for b in node.bottoms]
                if all(p is not None for p in parts):
                    segments[node.tops[0]] = tuple(
                        s for p in parts for s in p
                    )
            elif node.type == "Crop":
                starts = node.p(-23309, [])
                ends = node.p(-23310, [])
                axes = node.p(-23311, [])
                src = segments.get(node.bottoms[0])
                if src is not None and list(axes) == [0] and len(starts) == 1:
                    s = int(starts[0])
                    e = int(ends[0])
                    width = sum(n for _, n in src)
                    e = width if e >= 2147483647 else (e if e >= 0 else width + e)
                    got = crop_like(src, s, min(e, width))
                    if got:
                        segments[node.tops[0]] = got
            elif node.type == "Slice" and int(node.p(1, 0)) == 0:
                src = segments.get(node.bottoms[0])
                if src is not None:
                    from ..ops.common import slice_sizes

                    width = sum(n for _, n in src)
                    off = 0
                    for t, sz in zip(
                        node.tops, slice_sizes(node, width, len(node.tops))
                    ):
                        got = crop_like(src, off, off + int(sz))
                        if got:
                            segments[t] = got
                        off += int(sz)
        return set(segments)

    def layers_of_type(self, type_name: str) -> List[LayerNode]:
        return [n for n in self.nodes if n.type == type_name]

    def type_histogram(self) -> Dict[str, int]:
        hist: Dict[str, int] = {}
        for n in self.nodes:
            hist[n.type] = hist.get(n.type, 0) + 1
        return hist
