"""Graph executor, the replacement for ncnn::Net/Extractor (copy of
``Executor`` in ``rife_tpu/graph/executor.py``).

``Executor.run`` mirrors ncnn Extractor semantics: callers provide input
blobs (any blob may be pinned, not just graph inputs — the v4 TTA pyramid
re-injects flow0..flow3 this way) and request any named blobs as outputs.
The layer kinds come from an op table (``ops/torch_ops.OP_TABLE``).  Each
run is one ``executor.run`` span (``utils/profiling.py``), id the net's
``name``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

from ..utils.profiling import span
from .ir import Graph
from .weights import LayerWeights


class Executor:
    def __init__(
        self,
        graph: Graph,
        op_table: Mapping[str, Any],
        raw_weights: Mapping[str, LayerWeights],
        ctx: Dict[str, Any] | None = None,
        name: str = "",
    ):
        self.graph = graph
        self.op_table = op_table
        self.raw_weights = raw_weights
        self.ctx = ctx or {}
        self.name = name

    def run(
        self,
        inputs: Mapping[str, Any],
        outputs: Sequence[str],
        ctx: Dict[str, Any] | None = None,
    ) -> List[Any]:
        """Execute; ``ctx`` entries override the constructor context (the
        pipelines pass the prepared weights this way)."""
        with span("executor.run", self.name):
            return self._run(inputs, outputs, ctx)

    def _run(self, inputs, outputs, ctx) -> List[Any]:
        ctx = {**self.ctx, **ctx} if ctx else self.ctx
        blobs: Dict[str, Any] = dict(inputs)
        needed = self.graph.required_nodes(outputs, list(inputs.keys()))
        for idx in needed:
            node = self.graph.nodes[idx]
            if node.type == "Input":
                if node.tops[0] not in blobs:
                    raise KeyError(f"graph input {node.tops[0]!r} not provided")
                continue
            # a node may be "needed" while all its tops are already pinned
            if all(t in blobs for t in node.tops):
                continue
            fn = self.op_table.get(node.type)
            if fn is None:
                raise NotImplementedError(f"layer type {node.type!r}")
            ins = [blobs[b] for b in node.bottoms]
            outs = fn(node, ins, self.raw_weights.get(node.name), ctx)
            if len(outs) != len(node.tops):
                raise RuntimeError(
                    f"{node.type} {node.name}: produced {len(outs)} outputs, "
                    f"graph expects {len(node.tops)}"
                )
            for top, val in zip(node.tops, outs):
                if top not in blobs:  # pinned blobs always win
                    blobs[top] = val
        return [blobs[b] for b in outputs]
