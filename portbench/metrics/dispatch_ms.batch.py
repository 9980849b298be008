"""Host milliseconds a step spends in the executor's dispatch of the
graphs: the sum of the program's ``executor.run`` spans over the
``session.step`` spans of the untraced run that precedes the profiled
window."""

from portbench import spans

LAYER = "graph/executor.py + ops/torch_ops.py"
UNIT = "ms"
MOVES = "frames_per_s"
KINDS = ("device_batch",)


def read(view):
    n = view.outcome.counters.get("steps", 0)
    return spans.per_step_ms(spans.untraced(view, "session.step", n),
                             "executor.run")
