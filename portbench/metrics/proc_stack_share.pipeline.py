"""Share of the untraced runner run's wall time that its proc thread spent
stacking batches into the pinned slots: the sum of the program's
``runner.stack`` spans in that run over ``free_window_s``."""

from portbench import spans

LAYER = "io/runner.py"
UNIT = "%"
MOVES = "pipeline_frames_per_s"
KINDS = ("host_pipeline",)


def read(view):
    w = spans.untraced(view, "runner.run", 1)
    wall = view.outcome.counters.get("free_window_s", 0)
    if w is None or wall <= 0 or not w.named("runner.stack"):
        return None
    return 100.0 * w.seconds("runner.stack") / wall
