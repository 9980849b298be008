"""Host milliseconds a ``RIFE.process`` call spends copying frames: the
program's ``session.upload`` (both inputs onto the card) and
``session.download`` (the output back) spans, over the calls of the
untraced run that precedes the profiled window."""

from portbench import spans

LAYER = "engine/session.py"
UNIT = "ms"
MOVES = "latency_p50_ms"
KINDS = ("pair",)


def read(view):
    w = spans.untraced(view, "session.step",
                       view.outcome.counters.get("calls", 0))
    up = spans.per_step_ms(w, "session.upload")
    down = spans.per_step_ms(w, "session.download")
    if up is None or down is None:
        return None
    return up + down
