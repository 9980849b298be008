"""Share of the untraced runner run's wall time that its proc thread spent
dispatching steps: the sum of the program's ``session.step`` spans on the
``proc`` thread in that run over ``free_window_s``."""

from portbench import spans

LAYER = "engine/session.py"
UNIT = "%"
MOVES = "pipeline_frames_per_s"
KINDS = ("host_pipeline",)


def read(view):
    w = spans.untraced(view, "runner.run", 1)
    wall = view.outcome.counters.get("free_window_s", 0)
    if w is None or wall <= 0 or not w.named("session.step", "proc"):
        return None
    return 100.0 * w.seconds("session.step", "proc") / wall
