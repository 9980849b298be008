"""Device time a call of ``RIFE.process`` spends in host-device copies
(the Memcpy HtoD and DtoH events of the trace), per call."""

LAYER = "engine/session.py"
UNIT = "ms"
MOVES = "latency_p50_ms"
KINDS = ("pair",)


def read(view):
    tr, calls = view.trace, view.outcome.counters.get("calls", 0)
    if tr is None or calls <= 0:
        return None
    s = tr.copies_s.get("HtoD", 0.0) + tr.copies_s.get("DtoH", 0.0)
    return 1e3 * s / calls if s > 0 else None
