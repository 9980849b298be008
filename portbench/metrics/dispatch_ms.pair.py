"""Host milliseconds a ``RIFE.process`` call spends in the executor's
dispatch of the graph: the sum of the program's ``executor.run`` spans
over the calls (``session.step`` spans) of the untraced run that precedes
the profiled window."""

from portbench import spans

LAYER = "graph/executor.py + ops/torch_ops.py"
UNIT = "ms"
MOVES = "latency_p50_ms"
KINDS = ("pair",)


def read(view):
    n = view.outcome.counters.get("calls", 0)
    return spans.per_step_ms(spans.untraced(view, "session.step", n),
                             "executor.run")
