"""The one way a kernel wrapper calls into ``csrc``: the C function runs under
a device guard for its tensors' device, on that device's current stream,
and a non-zero return (``cudaGetLastError()`` or the reason the launch was
refused) raises.

The C functions launch on the calling thread's current device and keep
their per-device state (``csrc/conv.cu``: SM count, shared-memory opt-in)
keyed by it, so the guard is what puts a launch on ``cuda:1`` when the
thread's current device is ``cuda:0``.
"""

from __future__ import annotations

import ctypes

import torch

from ..native import build


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer for the C call (None: a null pointer)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call ``fn_name(*args, stream)`` on ``device``; raise if it fails."""
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} "
                           f"({build.error_string(rc)})")
