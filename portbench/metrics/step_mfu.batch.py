"""The whole step's share of the card's bf16 peak: the graphs' operations
a frame (``portbench/counts.py``) times the frames of the traced run's
untraced window, over that window times 989 TFLOP/s."""

from portbench import peaks

LAYER = "engine/session.py"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("device_batch",)


def read(view):
    c = view.outcome.counters
    frames, free = c.get("frames", 0), c.get("free_window_s", 0)
    if frames <= 0 or free <= 0:
        return None
    flop = view.work.flop_per_frame * frames
    return 100.0 * flop / (free * peaks.BF16_FLOP_S)
