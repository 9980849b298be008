"""Device kernels a call of ``RIFE.process`` launches (eager dispatch of
the executor's nodes), counted in the trace."""

LAYER = "graph/executor.py + ops/torch_ops.py"
UNIT = "kernels"
MOVES = "latency_p50_ms"
KINDS = ("pair",)


def read(view):
    tr, calls = view.trace, view.outcome.counters.get("calls", 0)
    if tr is None or calls <= 0 or tr.kernels == 0:
        return None
    return tr.kernels / calls
