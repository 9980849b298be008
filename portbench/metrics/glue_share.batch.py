"""Share of all device time taken by kernels that no
``portbench/kernels/*.json`` family names: the eager glue."""

LAYER = "graph/executor.py + ops/torch_ops.py"
UNIT = "%"
MOVES = "frames_per_s"
KINDS = ("device_batch",)


def read(view):
    tr = view.trace
    if tr is None or tr.device_s <= 0:
        return None
    return 100.0 * tr.device_by_kind.get("glue", 0.0) / tr.device_s
