"""The traced run's reading of ``torch.profiler``.

A traced run profiles twice:

* the measured window, with CUDA activity alone (no host-side operator
  events, which would slow the host's dispatch and so the window): from
  its device events, the device's busy time (the union of the intervals of
  every kernel, memcpy and memset on the card; streams that overlap count
  once) over the window's length by the host clock, the device time by
  kernel name, and each kernel sorted into a kind by the
  ``portbench/kernels/*.json`` families (a kernel that no family names is
  ``glue``);
* after it, a short span of the same traffic with CPU and CUDA activity,
  marked by one ``record_function`` span (``WINDOW``) whose start and end
  are on the clock of every other event: the idle gaps between its busy
  intervals, each named after the innermost host event running at its
  middle (what the host was doing while the card waited; "(no traced host
  event)" where the host ran Python that no operator or runtime call
  covers).  Only the breakdown's ``idle_gaps`` come from this span.

Events are read from the profiler's result in memory; nothing is written.
"""

from __future__ import annotations

import heapq
import contextlib
import json
import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
NAME_CHARS = 160  # a kernel's symbol, cut for the result line
KERNELS_DIR = Path(__file__).resolve().parent / "kernels"


def families(kernels_dir: Path = KERNELS_DIR) -> List[Tuple[str, re.Pattern]]:
    """(kind, pattern) of every kernel family file, in name order."""
    out = []
    for path in sorted(kernels_dir.glob("*.json")):
        spec = json.loads(path.read_text())
        out.append((spec["kind"], re.compile("|".join(spec["patterns"]))))
    return out


def kind_of(name: str, fams) -> str:
    for kind, pat in fams:
        if pat.search(name):
            return kind
    return "glue"


@dataclass
class Trace:
    """What the traced window holds; times in seconds."""
    window_s: float
    busy_s: float
    kernels: int
    device_by_name: Dict[str, float] = field(default_factory=dict)
    device_by_kind: Dict[str, float] = field(default_factory=dict)
    copies_s: Dict[str, float] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    @property
    def device_s(self) -> float:
        """Summed device time of every operation (overlaps counted twice)."""
        return sum(self.device_by_name.values())

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.device_by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:NAME_CHARS], v] for k, v in top],
                "idle_gaps": [[k[:NAME_CHARS], v] for k, v in gaps]}


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _copy_kind(name: str) -> Optional[str]:
    if "HtoD" in name:
        return "HtoD"
    if "DtoH" in name:
        return "DtoH"
    if "DtoD" in name:
        return "DtoD"
    return None


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host event running at each gap's
    middle (the alive event that started last); one sweep over both
    sorted lists."""
    host = sorted(host)
    idle: Dict[str, float] = defaultdict(float)
    alive: list = []
    i = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(alive, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while alive and alive[0][1] < mid:
            heapq.heappop(alive)
        name = alive[0][2] if alive else "(no traced host event)"
        idle[name] += (g1 - g0) / 1e9
    return dict(idle)


def read(events, fams, window_s: Optional[float] = None) -> Trace:
    """The ``Trace`` of the kineto ``events`` (``prof.profiler.
    kineto_results.events()``): inside the ``WINDOW`` span where the
    events hold one, else every device event over ``window_s`` seconds
    (a window whose device work all lies inside the profile)."""
    win = [e for e in events if e.name() == WINDOW
           and e.device_type() != torch.autograd.DeviceType.CUDA]
    if win and len(win) != 1:
        raise RuntimeError(f"expected one {WINDOW} span, found {len(win)}")
    if win:
        w0 = win[0].start_ns()
        w1 = w0 + win[0].duration_ns()
    elif window_s is None:
        raise RuntimeError(f"no {WINDOW} span and no window length")
    else:
        w0, w1 = -2 ** 62, 2 ** 62
    device, host = [], []
    by_name: Dict[str, float] = defaultdict(float)
    by_kind: Dict[str, float] = defaultdict(float)
    copies: Dict[str, float] = defaultdict(float)
    kernels = 0
    for e in events:
        s = max(e.start_ns(), w0)
        t = min(e.start_ns() + e.duration_ns(), w1)
        if t <= s:
            continue
        name = e.name()
        if name == WINDOW or e.is_user_annotation():
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((s, t))
            by_name[name] += (t - s) / 1e9
            low = name.lower()
            if low.startswith("memcpy"):
                ck = _copy_kind(name)
                if ck:
                    copies[ck] += (t - s) / 1e9
                by_kind["copy"] += (t - s) / 1e9
            elif low.startswith("memset"):
                by_kind["memset"] += (t - s) / 1e9
            else:
                kernels += 1
                by_kind[kind_of(name, fams)] += (t - s) / 1e9
        else:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    busy = _merge(device)
    idle: Dict[str, float] = {}
    if win:
        gaps = []
        edge = w0
        for s, t in busy:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, t)
        if w1 > edge:
            gaps.append((edge, w1))
        idle = _name_gaps(gaps, host)
        window_s = (w1 - w0) / 1e9
    return Trace(window_s=window_s,
                 busy_s=sum(t - s for s, t in busy) / 1e9,
                 kernels=kernels, device_by_name=dict(by_name),
                 device_by_kind=dict(by_kind), copies_s=dict(copies),
                 idle_by_host=dict(idle))


class Profiler:
    """The traced run's two profiles: ``window()`` around the measured
    window (CUDA activity alone where the run is on the card), ``gaps()``
    around the short span after it (CPU and CUDA, marked by ``WINDOW``).
    Both are no-ops in an untraced run."""

    def __init__(self, on: bool, cuda: bool):
        self.on, self.cuda = on, cuda
        self.events = {}

    @contextlib.contextmanager
    def _profile(self, key: str, acts, span: bool):
        if not self.on:
            yield
            return
        with torch.profiler.profile(activities=acts) as prof:
            with (torch.profiler.record_function(WINDOW) if span
                  else contextlib.nullcontext()):
                yield
        self.events[key] = prof.profiler.kineto_results.events()

    def window(self):
        cpu = torch.profiler.ProfilerActivity.CPU
        cuda = torch.profiler.ProfilerActivity.CUDA
        return self._profile("window", [cuda] if self.cuda else [cpu], False)

    def gaps(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return self._profile("gaps", acts, True)

    def read(self, window_s: float) -> Optional[Trace]:
        """The window's ``Trace`` (``window_s``: its length by the host
        clock), with the idle gaps of the span after it."""
        if not self.on:
            return None
        fams = families()
        tr = read(self.events["window"], fams, window_s)
        if "gaps" in self.events:
            tr.idle_by_host = read(self.events["gaps"], fams).idle_by_host
        return tr
