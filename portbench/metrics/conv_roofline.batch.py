"""The conv kernels' share of their roofline: the least time of every
Convolution and Deconvolution site of the graphs (``portbench/counts.py``,
bf16 operations over 989 TFLOP/s or bytes over 3.35 TB/s, the larger) times
the window's steps, over the device time of the ``conv`` kernels."""

LAYER = "kernels: ops/conv.py, csrc/conv.cu, conv_ps.cu, deconv.cu, cuDNN"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("device_batch",)


def read(view):
    tr, steps = view.trace, view.outcome.counters.get("steps", 0)
    spent = 0.0 if tr is None else tr.device_by_kind.get("conv", 0.0)
    if spent <= 0 or steps <= 0:
        return None
    return 100.0 * view.work.least_s("conv|deconv") * steps / spent
