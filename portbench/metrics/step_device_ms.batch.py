"""Device milliseconds of a step: the mean, over the ``session.step`` spans
of the untraced run that precedes the profiled window, of the CUDA
timing-event pair the session records around ``session.forward`` on the
step's stream (under the profiler the host is slower, and the pair times
the idle within the step too)."""

from portbench import spans

LAYER = "engine/session.py"
UNIT = "ms"
MOVES = "frames_per_s"
KINDS = ("device_batch",)


def read(view):
    w = spans.untraced(view, "session.step",
                       view.outcome.counters.get("steps", 0))
    if w is None:
        return None
    ms = spans.device_ms()
    got = [ms[s.seq] for s in w.named("session.step") if s.seq in ms]
    return sum(got) / len(got) if got else None
