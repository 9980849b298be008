"""The program's own spans in a traced run, on the profiler's clock.

The program records spans always (``rife_tpu_torch.utils.profiling``:
``spans()``, ``trace_ns`` and, on a card, ``device_ms()``).  A traced run
does the same work twice: untraced first, then under the window profile.

* ``window``: the profiled run, found from the window profile's device
  events (``cell.profiler.events["window"]``): their range, widened to the
  root spans (those with no parent) that overlap it, so that the first
  batch's stacking and the last call's copy out count.  The device's busy
  intervals are the union of the same events (``trace._merge``).  The
  readers of device idle time (``device_trace``) read it.
* ``untraced``: the run just before it, at the untraced pace (the
  profiler slows the host, so host times and the steps' event pairs read
  higher under it): the last ``n`` root spans of a name that end before
  the window, and every span from the first of them to the window.  The
  readers of the program's own times (``program_counter``) read it.

Times are the profiler's nanoseconds.  A program without the recorder, a
run without a card or an untraced run gives no window: every reader
returns None then.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from .trace import _merge


def program():
    """The program's profiling module where it records spans, else None."""
    try:
        from rife_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "spans") and hasattr(profiling, "trace_ns")):
        return None
    return profiling


@dataclass
class Span:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    role: str
    id: object
    parent: Optional[int]
    seq: int

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


@dataclass
class Window:
    """One profiled run: its extent, the device's busy intervals and the
    spans inside it."""
    t0: int
    t1: int
    busy: List[List[int]]
    spans: List[Span]

    def named(self, name: str, role: Optional[str] = None) -> List[Span]:
        return [s for s in self.spans if s.name == name
                and (role is None or s.role == role)]

    def seconds(self, name: str, role: Optional[str] = None) -> float:
        return sum(s.seconds for s in self.named(name, role))

    def idle(self, within=None) -> List[List[int]]:
        """The intervals in which nothing ran on the device, inside
        ``within`` (merged intervals; the whole extent by default)."""
        return subtract(within or [[self.t0, self.t1]], self.busy)


def length(a) -> int:
    return sum(e - s for s, e in a)


def intersect(a, b) -> List[List[int]]:
    """The overlap of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> List[List[int]]:
    """``a`` less ``b`` (both sorted, disjoint)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def union(spans: List[Span]) -> List[List[int]]:
    return _merge([(s.start, s.end) for s in spans])


def device_intervals(events) -> List[List[int]]:
    """The merged intervals of every device event (kernels, copies,
    memsets) that is not an annotation."""
    cuda = torch.autograd.DeviceType.CUDA
    return _merge([(e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events if e.device_type() == cuda
                   and not e.is_user_annotation()])


def mapped(prof) -> List[Span]:
    """The program's spans on the profiler's clock."""
    return [Span(s.name, prof.trace_ns(s.start), prof.trace_ns(s.end),
                 s.role, s.id, s.parent, s.seq) for s in prof.spans()]


def in_window(events, spans: List[Span]) -> Optional[Window]:
    """The ``Window`` of ``spans`` (mapped) around the device ``events``."""
    busy = device_intervals(events)
    if not busy:
        return None
    lo, hi = busy[0][0], busy[-1][1]
    roots = [s for s in spans if s.parent is None
             and s.start < hi and s.end > lo]
    t0 = min([lo] + [s.start for s in roots])
    t1 = max([hi] + [s.end for s in roots])
    inside = [s for s in spans if s.start >= t0 and s.end <= t1]
    if not inside:
        return None
    return Window(t0, t1, busy, inside)


def window(view) -> Optional[Window]:
    """The profiled run's ``Window``, or None (no recorder, no card, no
    trace)."""
    prof = program()
    cell = getattr(view, "cell", None)
    if prof is None or cell is None or view.trace is None:
        return None
    events = cell.profiler.events.get("window")
    if not events:
        return None
    return in_window(events, mapped(prof))


def untraced(view, root: str, n: int) -> Optional[Window]:
    """The run before the profiled window: from the start of the last
    ``n`` root spans named ``root`` that end before it, to its start."""
    w = window(view)
    if w is None or n <= 0:
        return None
    spans = mapped(program())
    roots = sorted((s for s in spans if s.name == root and s.parent is None
                    and s.end <= w.t0), key=lambda s: s.start)[-n:]
    if len(roots) < n:
        return None
    t0 = roots[0].start
    return Window(t0, w.t0, [], [s for s in spans
                                 if s.start >= t0 and s.end <= w.t0])


def device_ms() -> Dict[int, float]:
    """{seq of a span: device ms of its CUDA event pair}, or {}."""
    prof = program()
    if prof is None or not hasattr(prof, "device_ms"):
        return {}
    return prof.device_ms()


def per_step_ms(w: Optional[Window], name: str) -> Optional[float]:
    """Milliseconds of span ``name`` a ``session.step`` of ``w``."""
    if w is None:
        return None
    steps = len(w.named("session.step"))
    spans = w.named(name)
    if not steps or not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / steps


def idle_share_under(w: Optional[Window], within, name: str
                     ) -> Optional[float]:
    """Of the device's idle time inside ``within``, the share (%) that
    falls inside a span ``name``."""
    if w is None:
        return None
    idle = w.idle(within)
    total = length(idle)
    if total <= 0:
        return None
    return 100.0 * length(intersect(idle, union(w.named(name)))) / total
