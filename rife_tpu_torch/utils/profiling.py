"""Profiling / tracing helpers (port of ``rife_tpu/utils/profiling.py``).

* ``trace(logdir)`` — context manager around ``torch.profiler`` writing a
  Chrome trace (``<host>_<pid>.<time>.pt.trace.json``, the layout
  TensorBoard's profiler plugin reads) under the log dir;
* ``WallTimer`` — lightweight named wall-clock sections for host-side
  stage accounting (the pipeline runner keeps its own StageMetrics).

Nothing on the serving path calls ``trace``: wrap the code to trace in
``with trace(dir):``, or set RIFE_TORCH_TRACE=<logdir> for the ``trace()``
calls that name no log dir.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


def require_device_events(events) -> None:
    """Raise unless the profiler's ``events`` hold CUDA activity: a trace
    that was asked to record the card never drops it silently."""
    if not any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in events):
        raise RuntimeError(
            "torch.profiler recorded no CUDA activity although a card is "
            "visible (CUPTI unavailable?); the trace would hold host events "
            "only")


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace when a log dir is given (or via
    the RIFE_TORCH_TRACE env var); no-op otherwise.

    CPU activity is always recorded, CUDA activity whenever a card is
    visible; then one small kernel on the current card opens the window, so
    that a profiler unable to record the card raises ``RuntimeError``
    instead of writing a host-only trace."""
    logdir = logdir or os.environ.get("RIFE_TORCH_TRACE")
    if not logdir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, acc_events=True,
                   on_trace_ready=tensorboard_trace_handler(str(logdir)))
    with prof:
        if cuda:
            with torch.profiler.record_function("rife_trace_probe"):
                torch.zeros(1, device="cuda").add_(1)
        yield
        if cuda:
            torch.cuda.synchronize()
    if cuda:
        require_device_events(prof.events())


class WallTimer:
    """Accumulating named wall-clock sections."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"{name}: {self.totals[name]:.3f}s over {self.counts[name]} calls"
            )
        return "\n".join(lines)
