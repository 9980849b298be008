"""Share of the untraced pace's time in which nothing ran on the card: 1 -
the union of every kernel, memcpy and memset interval of the traced window
over the untraced window of the same work (the profiler slows the host,
not the card's work)."""

LAYER = "device"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("device_batch",)


def read(view):
    tr, free = view.trace, view.outcome.counters.get("free_window_s", 0)
    if tr is None or tr.busy_s <= 0 or free <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / free)
