"""The one way a kernel wrapper calls into ``csrc``: the C function runs under
a device guard for its tensors' device, on that device's current stream,
and a non-zero return (``cudaGetLastError()`` or the reason the launch was
refused) raises.

The C functions launch on the calling thread's current device and keep
their per-device state (``csrc/conv.cu``: SM count, shared-memory opt-in)
keyed by it, so the guard is what puts a launch on ``cuda:1`` when the
thread's current device is ``cuda:0``.

Meta tensors are a plan's (``engine/plan.py``): a wrapper given them takes
the kernel's branch, checks its operands and allocates its output, and
``launch`` launches nothing.  ``on_card`` answers every check that decides
by device, a meta tensor's as the device the running plan stands for, and
``count`` records each call in the running plan instead of the wrapper's
launch counter.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from ..native import build

# the plan running on this thread: the device it stands for and its record
_PLAN = threading.local()


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer for the C call (None: a null pointer)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def on_card(device) -> bool:
    """Whether work on ``device`` runs on the card: a CUDA device's does, the
    CPU's does not, the meta device's as the running plan's device does."""
    kind = torch.device(device).type
    if kind == "meta":
        kind = getattr(_PLAN, "device", torch.device("cpu")).type
    return kind == "cuda"


@contextlib.contextmanager
def planning(device):
    """While it runs, meta tensors stand for ``device`` and ``count`` appends
    (kernel, site) to the list it yields."""
    _PLAN.device, _PLAN.record = torch.device(device), []
    try:
        yield _PLAN.record
    finally:
        del _PLAN.device, _PLAN.record


def count(launches: dict, name: str, site=None) -> None:
    """One call of kernel ``name`` (``site``: what the plan lists of it):
    into ``launches``, or the running plan's record."""
    record = getattr(_PLAN, "record", None)
    if record is None:
        launches[name] += 1
    else:
        record.append((name, site))


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call ``fn_name(*args, stream)`` on ``device`` (on meta: nothing);
    raise if it fails."""
    if device.type == "meta":
        return
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} "
                           f"({build.error_string(rc)})")
