"""The warp kernels' share of their roofline: every ``rife.Warp`` node's
bytes once (``portbench/counts.py``) over 3.35 TB/s, times the window's
steps, over the device time of the ``warp`` kernels."""

LAYER = "kernels: ops/warp.py, csrc/warp.cu"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("device_batch",)


def read(view):
    tr, steps = view.trace, view.outcome.counters.get("steps", 0)
    spent = 0.0 if tr is None else tr.device_by_kind.get("warp", 0.0)
    if spent <= 0 or steps <= 0:
        return None
    return 100.0 * view.work.least_s("warp") * steps / spent
