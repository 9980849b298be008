"""Profiling and tracing of the port (port of ``rife_tpu/utils/profiling.py``,
plus the port's span recorder).

* The span recorder, always on: ``span(name, id)`` (a context manager) and
  ``record(name, start, end, id)`` (a span timed by its caller) keep every
  span as a ``Span``: its name, start and end on ``time.perf_counter``, its
  thread's role (``set_role``; the thread's name by default), an id that
  links spans across threads (a task or batch id in the runner, a step
  number in the session), its parent (the innermost span open on the same
  thread) and the time its children took.  The newest ``RING`` spans stay
  in memory (``spans()``), a long run's last minutes; the sums by name
  (``totals()``) cover the whole process.  ``trace_ns`` maps a span's time
  onto ``torch.profiler``'s clock (Unix-epoch nanoseconds) through one
  anchor pair read when this module loads.  A span costs a few
  microseconds; the program opens about ten a step.
* ``EventTimer``: CUDA timing-event pairs around a step's device work, from
  a pool reused once a pair has completed; ``device_ms()`` reads their
  elapsed times lazily, after the caller's synchronize.
* ``Sums`` (count and seconds by span name) is what ``WallTimer`` (named
  wall-clock sections) and the runner's ``StageMetrics`` are: views of the
  spans recorded into them.
* ``trace(logdir)``: ``torch.profiler`` around a block, written as a
  Chrome trace (``<host>_<pid>.<time>.pt.trace.json``, the layout
  TensorBoard's profiler plugin reads) with the recorder's spans of the
  window beside the profiler's events, one row per thread role.  Nothing
  on the serving path calls it: wrap the code to trace in
  ``with trace(dir):``, or set RIFE_TORCH_TRACE=<logdir> for the
  ``trace()`` calls that name no log dir.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import socket
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

RING = 65536  # spans kept in memory: ~10k a 30 s run of a host-bound cell

# one (epoch ns, perf_counter) pair: the profiler's clock is Unix-epoch
# nanoseconds, and perf_counter runs at its rate
_ANCHOR_NS, _ANCHOR_PC = time.time_ns(), time.perf_counter()


def trace_ns(t: float) -> int:
    """``time.perf_counter`` seconds as the profiler's epoch nanoseconds."""
    return _ANCHOR_NS + round((t - _ANCHOR_PC) * 1e9)


class Span(NamedTuple):
    name: str
    start: float  # time.perf_counter seconds
    end: float
    role: str  # the recording thread's role
    id: Any  # links spans across threads: task, batch or step
    parent: Optional[int]  # seq of the innermost span open on the thread
    seq: int  # the recorder's number of this span, in order of opening
    thread: int  # threading.get_ident() of the recording thread
    child_s: float  # seconds in the spans directly inside it

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def self_s(self) -> float:
        """Seconds not covered by a child span."""
        return self.end - self.start - self.child_s


class Sums:
    """Count and seconds by span name, summed under a lock: the spans
    recorded ``into`` it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n: Dict[str, int] = {}
        self._s: Dict[str, float] = {}

    def add(self, name: str, seconds: float, n: int = 1) -> None:
        with self._lock:
            self._n[name] = self._n.get(name, 0) + n
            self._s[name] = self._s.get(name, 0.0) + seconds

    def snapshot(self) -> Dict[str, Tuple[int, float]]:
        """{name: (count, seconds)}."""
        with self._lock:
            return {k: (self._n[k], self._s[k]) for k in self._n}


class _Thread:
    """A thread's open spans, role and sums (written by that thread only)."""
    __slots__ = ("stack", "role", "ident", "sums")

    def __init__(self):
        self.stack: list = []
        self.role = threading.current_thread().name
        self.ident = threading.get_ident()
        self.sums: Dict[str, list] = {}  # name: [count, seconds, self s]


class _Open:
    """A span: open between ``__enter__`` and ``__exit__``."""
    __slots__ = ("rec", "name", "id", "into", "n", "seq", "start", "child_s",
                 "st")

    def __init__(self, rec, name, id, into, n):
        self.rec, self.name, self.id = rec, name, id
        self.into, self.n = into, n

    def __enter__(self) -> "_Open":
        self.seq = next(self.rec._seq)
        self.child_s = 0.0
        self.st = self.rec._state()
        self.st.stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        self.st.stack.pop()
        self.rec._keep(self.st, self.name, self.start, end, self.id,
                       self.seq, self.child_s, self.into, self.n)
        return False


class Recorder:
    """Spans in a ring of ``maxlen`` (as plain tuples, made ``Span`` when
    read), sums by name (per thread, merged when read), device times by
    the seq of the span they belong to."""

    def __init__(self, maxlen: int = RING):
        self.ring: deque = deque(maxlen=maxlen)
        self.device: deque = deque(maxlen=maxlen)  # (seq, ms)
        self._local = threading.local()
        self._seq = itertools.count()
        self._threads: List[_Thread] = []
        self._retired: Dict[str, list] = {}  # the sums of ended threads
        self._lock = threading.Lock()

    def _state(self) -> _Thread:
        try:
            return self._local.st
        except AttributeError:
            st = self._local.st = _Thread()
            with self._lock:
                self._threads.append(st)
            weakref.finalize(threading.current_thread(), self._retire, st)
            return st

    def _retire(self, st: _Thread) -> None:
        with self._lock:
            self._threads.remove(st)
            _merge_sums(self._retired, st.sums)

    def set_role(self, role: str) -> None:
        self._state().role = role

    def span(self, name: str, id: Any = None, *, into: Optional[Sums] = None,
             n: int = 1) -> _Open:
        """Context manager: a span from entry to exit (also when the block
        raises), summed into ``into`` too (``n`` items); it yields itself,
        whose ``seq`` is the span's."""
        return _Open(self, name, id, into, n)

    def record(self, name: str, start: float, end: float, id: Any = None, *,
               into: Optional[Sums] = None, n: int = 1) -> None:
        """A span its caller timed (``start``/``end`` on perf_counter), on
        this thread, inside the innermost span open here."""
        self._keep(self._state(), name, start, end, id, next(self._seq), 0.0,
                   into, n)

    def _keep(self, st, name, start, end, id, seq, child_s, into, n):
        dt = end - start
        parent = None
        if st.stack:
            up = st.stack[-1]
            parent = up.seq
            if start >= up.start:
                up.child_s += dt
        self.ring.append((name, start, end, st.role, id, parent, seq,
                          st.ident, child_s))
        v = st.sums.get(name)
        if v is None:
            st.sums[name] = [1, dt, dt - child_s]
        else:
            v[0] += 1
            v[1] += dt
            v[2] += dt - child_s
        if into is not None:
            into.add(name, dt, n)

    def spans(self) -> List[Span]:
        """The spans in the ring, oldest first."""
        return [Span(*t) for t in list(self.ring)]

    def totals(self) -> Dict[str, Tuple[int, float, float]]:
        """{span name: (count, seconds, self seconds)} over the process."""
        out: Dict[str, list] = {}
        with self._lock:
            _merge_sums(out, self._retired)
            for st in self._threads:
                _merge_sums(out, st.sums)
        return {k: tuple(v) for k, v in out.items()}


def _merge_sums(into: Dict[str, list], sums: Dict[str, list]) -> None:
    for name, v in list(sums.items()):
        acc = into.setdefault(name, [0, 0.0, 0.0])
        for i in range(3):
            acc[i] += v[i]


RECORDER = Recorder()
span = RECORDER.span
record = RECORDER.record
set_role = RECORDER.set_role
spans = RECORDER.spans
totals = RECORDER.totals


class EventTimer:
    """CUDA timing-event pairs of one device, around a step's device work.

    ``start(stream)`` records a pair's first event (None when all ``cap``
    pairs are still pending: that step goes untimed), ``stop(pair, stream,
    seq)`` its second, kept with the span ``seq``.  The pool grows to
    ``cap`` pairs; then, when it runs dry (every ``cap`` steps), every
    completed pair's elapsed time is read at once and the pair reused.
    ``device_ms()`` reads the rest: never right after the step."""

    def __init__(self, cap: int = 64, recorder: Recorder = RECORDER):
        self.cap, self.recorder = cap, recorder
        self._free: list = []
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._made = 0
        self.untimed = 0
        _TIMERS.add(self)

    def start(self, stream):
        with self._lock:
            if not self._free and self._made < self.cap:
                self._made += 1
                self._free.append((torch.cuda.Event(enable_timing=True),
                                   torch.cuda.Event(enable_timing=True)))
            if not self._free:
                self._reap()
            if not self._free:
                self.untimed += 1
                return None
            pair = self._free.pop()
        pair[0].record(stream)
        return pair

    def stop(self, pair, stream, seq: int):
        """Record the pair's second event; returns it (an event recorded
        after the step)."""
        pair[1].record(stream)
        with self._lock:
            self._pending.append((seq, pair))
        return pair[1]

    def _reap(self) -> None:
        while self._pending and self._pending[0][1][1].query():
            seq, pair = self._pending.popleft()
            self.recorder.device.append((seq, pair[0].elapsed_time(pair[1])))
            self._free.append(pair)

    def reap(self) -> None:
        with self._lock:
            self._reap()

    def __del__(self):
        # a session freed before its times were read: keep what completed
        try:
            self._reap()
        except Exception:  # noqa: BLE001 - CUDA may be gone at exit
            pass


_TIMERS: "weakref.WeakSet[EventTimer]" = weakref.WeakSet()


def device_ms() -> Dict[int, float]:
    """{seq of a span: device milliseconds of its event pair} for every
    pair that has completed (call after a synchronize to have them all)."""
    for timer in list(_TIMERS):
        timer.reap()
    return dict(RECORDER.device)


def chrome_events(window: Tuple[float, float], base_ns: int,
                  pid: int) -> List[dict]:
    """The ring's spans inside ``window`` (perf_counter seconds) as Chrome
    trace events on the profiler's clock (``ts`` in microseconds after
    ``base_ns``), under process ``pid``, one thread row per role (and per
    thread where a role has several)."""
    t0, t1 = window
    rows: Dict[int, int] = {}
    names: Dict[int, str] = {}
    per_role: Dict[str, int] = {}
    out = []
    for s in RECORDER.spans():
        if s.start < t0 or s.end > t1:
            continue
        if s.thread not in rows:
            k = per_role[s.role] = per_role.get(s.role, 0) + 1
            rows[s.thread] = len(rows) + 1
            names[s.thread] = s.role if k == 1 else f"{s.role}#{k}"
        out.append({"ph": "X", "cat": "rife_span", "name": s.name,
                    "pid": pid, "tid": rows[s.thread],
                    "ts": (trace_ns(s.start) - base_ns) / 1e3,
                    "dur": s.seconds * 1e6,
                    "args": {"id": repr(s.id), "role": s.role, "seq": s.seq,
                             "parent": s.parent}})
    meta = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": "rife_tpu_torch spans"}}]
    meta += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
              "args": {"name": names[th]}} for th, tid in rows.items()]
    return meta + out


def require_device_events(events) -> None:
    """Raise unless the profiler's ``events`` hold CUDA activity: a trace
    that was asked to record the card never drops it silently."""
    if not any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in events):
        raise RuntimeError(
            "torch.profiler recorded no CUDA activity although a card is "
            "visible (CUPTI unavailable?); the trace would hold host events "
            "only")


_EVENTS = re.compile(r'"traceEvents"\s*:\s*\[')
_BASE = re.compile(r'"baseTimeNanoseconds"\s*:\s*(\d+)')


def _write_trace(prof, logdir: str, window: Tuple[float, float]) -> str:
    """The profile as TensorBoard's handler names it, with the spans of
    ``window`` put at the head of its ``traceEvents`` (a text insertion:
    the profiler's events are not parsed again)."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        text = f.read()
    base = _BASE.search(text)
    events = json.dumps(chrome_events(window, int(base.group(1)) if base
                                      else 0, os.getpid() + 10**6))[1:-1]
    head = _EVENTS.search(text)
    if head is None or not events:
        return path
    rest = text[head.end():]
    sep = "" if rest.lstrip().startswith("]") else ","
    with open(path, "w") as f:
        f.write(text[:head.end()] + events + sep + rest)
    return path


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace when a log dir is given (or via
    the RIFE_TORCH_TRACE env var); no-op otherwise.

    CPU activity is always recorded, CUDA activity whenever a card is
    visible; then one small kernel on the current card opens the window, so
    that a profiler unable to record the card raises ``RuntimeError``
    instead of writing a host-only trace.  The recorder's spans that lie
    inside the window are written into the same file."""
    logdir = logdir or os.environ.get("RIFE_TORCH_TRACE")
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, acc_events=True)
    t0 = time.perf_counter()
    with prof:
        if cuda:
            with torch.profiler.record_function("rife_trace_probe"):
                torch.zeros(1, device="cuda").add_(1)
        yield
        if cuda:
            torch.cuda.synchronize()
    _write_trace(prof, str(logdir), (t0, time.perf_counter()))
    if cuda:
        require_device_events(prof.events())


class WallTimer(Sums):
    """Accumulating named wall-clock sections: spans of the section's name,
    summed here."""

    @property
    def totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._s)

    @property
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)

    def section(self, name: str) -> _Open:
        return span(name, into=self)

    def report(self) -> str:
        totals, counts = self.totals, self.counts
        lines = []
        for name in sorted(totals):
            lines.append(
                f"{name}: {totals[name]:.3f}s over {counts[name]} calls"
            )
        return "\n".join(lines)
