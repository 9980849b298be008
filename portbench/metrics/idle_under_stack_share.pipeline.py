"""Of the device's idle time in the profiled runner run (its extent less
the union of the window's device intervals), the share that falls inside a
``runner.stack`` span: the card waiting while the proc thread stacks."""

from portbench import spans

LAYER = "io/runner.py"
UNIT = "%"
MOVES = "pipeline_frames_per_s"
KINDS = ("host_pipeline",)


def read(view):
    return spans.idle_share_under(spans.window(view), None, "runner.stack")
