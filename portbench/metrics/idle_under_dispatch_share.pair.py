"""Of the device's idle time within the profiled window's calls (each from
its ``session.step`` span's start to its ``session.download`` span's end),
the share that falls inside an ``executor.run`` span: the card waiting on
the graph's dispatch."""

from portbench import spans
from portbench.trace import _merge

LAYER = "graph/executor.py + ops/torch_ops.py"
UNIT = "%"
MOVES = "latency_p50_ms"
KINDS = ("pair",)


def read(view):
    w = spans.window(view)
    if w is None:
        return None
    ends = {s.id: s.end for s in w.named("session.download")}
    calls = _merge([(s.start, ends[s.id])
                          for s in w.named("session.step") if s.id in ends])
    if not calls:
        return None
    return spans.idle_share_under(w, calls, "executor.run")
