"""Share of the runner's wall time that its proc thread waited on the load
stage (its queue empty): ``StageMetrics.waits["on load"]``."""

LAYER = "io/runner.py"
UNIT = "%"
MOVES = "pipeline_frames_per_s"
KINDS = ("host_pipeline",)


def read(view):
    c = view.outcome.counters
    if "wait_on_load_s" not in c or c.get("free_window_s", 0) <= 0:
        return None
    return 100.0 * c["wait_on_load_s"] / c["free_window_s"]
