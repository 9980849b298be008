"""The port's span recorder (``rife_tpu_torch/utils/profiling.py``) on the
CPU: nesting, parents and self time, the ring's bound, the sums that
``StageMetrics`` and ``WallTimer`` read, thread roles, the clock against
``torch.profiler``'s, the runner's and the session's spans, the CUDA event
pool (with stand-in events), ``trace()``'s export of the spans, and the
benchmark's eight span readers (``portbench/metrics``) on hand-made events
and spans."""

import importlib.util
import json
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rife_tpu_torch.io import runner as R
from rife_tpu_torch.utils import profiling as P

ROOT = Path(__file__).resolve().parent.parent


class Clock:
    """``time.perf_counter`` stepping by 1.0 a call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_nesting_parents_and_self_time(monkeypatch):
    rec = P.Recorder()
    monkeypatch.setattr(time, "perf_counter", Clock())
    with rec.span("outer", 7) as outer:          # 1
        with rec.span("inner", 8):               # 2
            with rec.span("leaf"):               # 3
                pass                             # 4
        # a span its caller timed, inside outer: 5.5 .. 6.0
        rec.record("timed", 5.5, 6.0, 9)         # (5) inner ends at 5
    # outer ends at 6
    by = {s.name: s for s in rec.spans()}
    assert [s.name for s in rec.spans()] == ["leaf", "inner", "timed", "outer"]
    assert by["outer"].parent is None and by["outer"].seq == outer.seq
    assert by["inner"].parent == by["outer"].seq
    assert by["leaf"].parent == by["inner"].seq
    assert by["timed"].parent == by["outer"].seq
    assert (by["outer"].start, by["outer"].end) == (1.0, 6.0)
    assert by["inner"].seconds == 3.0 and by["inner"].self_s == 2.0
    assert by["outer"].self_s == 5.0 - 3.0 - 0.5
    assert by["leaf"].self_s == 1.0
    assert by["outer"].id == 7 and by["timed"].id == 9
    sums = rec.totals()
    assert sums["outer"] == (1, 5.0, 1.5)
    assert sums["inner"] == (1, 3.0, 2.0)


def test_span_closes_when_the_block_raises(monkeypatch):
    rec = P.Recorder()
    with pytest.raises(ValueError):
        with rec.span("fails"):
            raise ValueError
    with rec.span("next"):
        pass
    fails, nxt = rec.spans()
    assert fails.name == "fails" and nxt.parent is None


def test_ring_is_bounded_and_sums_are_not():
    rec = P.Recorder(maxlen=4)
    for i in range(10):
        rec.record("s", float(i), i + 0.5, i)
    assert [s.id for s in rec.spans()] == [6, 7, 8, 9]
    assert rec.totals()["s"] == (10, 5.0, 5.0)
    assert P.RECORDER.ring.maxlen == P.RING == 65536


def test_thread_roles():
    rec = P.Recorder()
    got = {}

    def work(role):
        if role:
            rec.set_role(role)
        with rec.span("x"):
            pass
        got[role] = threading.current_thread().name

    for role in ("load", None):
        t = threading.Thread(target=work, args=(role,), name=f"t-{role}")
        t.start()
        t.join()
    with rec.span("x"):
        pass
    roles = [s.role for s in rec.spans()]
    assert roles == ["load", "t-None", threading.current_thread().name]
    assert rec.spans()[-1].thread == threading.get_ident()


def test_threads_lose_no_span():
    """More threads than cores, switching often: every span is kept once,
    with its own seq, and the sums count them all."""
    import sys

    rec = P.Recorder()
    into = P.Sums()
    n_threads, n = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            rec.set_role(f"w{k}")
            for i in range(n):
                with rec.span("outer", (k, i), into=into):
                    rec.record("inner", 0.0, 0.0, (k, i))
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = rec.spans()
    assert len(spans) == 2 * n_threads * n
    assert len({s.seq for s in spans}) == len(spans)
    assert rec.totals()["outer"][0] == n_threads * n
    assert into.snapshot()["outer"][0] == n_threads * n
    outer = {s.seq: s for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner":
            up = outer[s.parent]
            assert up.id == s.id and up.role == s.role


def test_sums_outlive_their_threads():
    """A thread's sums are kept once the thread is gone, and the recorder
    stops holding its state."""
    import gc

    rec = P.Recorder()

    def work():
        for _ in range(3):
            rec.record("ended", 0.0, 0.5)

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    rec.record("ended", 0.0, 0.25)
    assert len(rec._threads) == 2
    del t
    gc.collect()
    assert len(rec._threads) == 1
    assert rec.totals()["ended"] == (4, 1.75, 1.75)


def test_wall_timer_and_stage_metrics_are_views_of_the_recorder():
    timer = P.WallTimer()
    with timer.section("phase_a"):
        with timer.section("phase_b"):
            pass
    a, b = P.spans()[-2:]
    assert (a.name, b.name) == ("phase_b", "phase_a") and a.parent == b.seq
    assert timer.counts == {"phase_a": 1, "phase_b": 1}
    assert timer.totals["phase_a"] == b.seconds
    before = P.totals().get("runner.save", (0, 0.0, 0.0))[0]
    m = R.StageMetrics()
    m.add("load", 0.5, 2)
    m.add("save", 0.25)
    m.wait("on device", 1.0)
    m.wait("on load", 2.0)
    assert m.counts == {"load": 2, "save": 1}
    assert m.seconds == {"load": 0.5, "save": 0.25}
    assert m.waits == {"on device": 1.0, "on load": 2.0}
    assert m.summary() == ("load: 2 in 0.50s (4.0/s); save: 1 in 0.25s "
                           "(4.0/s); proc waited on device 1.00s, "
                           "on load 2.00s")
    assert P.totals()["runner.save"][0] == before + 1
    assert P.spans()[-1].name == "runner.wait_load"


def test_span_contains_the_profilers_event():
    """Kineto's host events are on Unix-epoch nanoseconds: a span around
    ``x.add(1)``, mapped by ``trace_ns``, contains its ``aten::add``."""
    x = torch.ones(1024)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.span("around_add") as f:
            x.add(1)
    s = next(s for s in P.spans() if s.seq == f.seq)
    (add,) = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::add"]
    assert P.trace_ns(s.start) <= add.start_ns()
    assert add.start_ns() + add.duration_ns() <= P.trace_ns(s.end)


@pytest.fixture
def frames(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        p = tmp_path / f"{i:03d}.png"
        Image.fromarray(rng.integers(0, 255, (16, 24, 3)).astype(np.uint8)
                        ).save(p)
        paths.append(str(p))
    return paths


def _blend(in0, in1, ts):
    return ((in0.astype(np.uint16) + in1) // 2).astype(np.uint8)


def _tasks(paths, out, ts):
    return [R.Task(id=i, in0_path=paths[i % len(paths)],
                   in1_path=paths[(i + 1) % len(paths)],
                   out_path=str(out / f"{i:03d}.png"), timestep=t)
            for i, t in enumerate(ts)]


def test_runner_spans_carry_task_and_batch_ids(frames, tmp_path):
    """The async path on CPU tensors: every task has its ``runner.load``,
    ``runner.wait_save`` and ``runner.save``; every batch its
    ``runner.stack`` (batch id and task ids), ``runner.wait_device``,
    ``runner.launch``, ``runner.copy_out`` and ``runner.proc``, each on its
    thread's role."""
    out = tmp_path / "out"
    out.mkdir()
    first = max((s.seq for s in P.spans()), default=-1)
    runner = R.PipelineRunner(
        [None], batch_size=2, jobs_load=2, jobs_save=2,
        device_fns=[lambda *a: torch.from_numpy(_blend(*a))])
    assert runner.run(_tasks(frames, out, [0.5] * 5)) == []
    mine = [s for s in P.spans() if s.seq > first]
    by = {}
    for s in mine:
        by.setdefault(s.name, []).append(s)
    roles = {n: {s.role for s in v} for n, v in by.items()}
    assert roles["runner.load"] == {"load"}
    assert roles["runner.stack"] == roles["runner.launch"] == {"proc"}
    assert roles["runner.wait_load"] == roles["runner.wait_device"] == {"proc"}
    assert roles["runner.copy_out"] == roles["runner.proc"] == {"download"}
    assert roles["runner.save"] == {"save"}
    assert len(by["runner.run"]) == 1
    run = by["runner.run"][0]
    assert all(run.start <= s.start and s.end <= run.end for s in mine)
    for name in ("runner.load", "runner.wait_save", "runner.save"):
        assert sorted(s.id for s in by[name]) == list(range(5)), name
    stacks = {s.id[0]: s.id[1] for s in by["runner.stack"]}
    assert sorted(t for ids in stacks.values() for t in ids) == list(range(5))
    for name in ("runner.wait_device", "runner.launch", "runner.copy_out",
                 "runner.proc"):
        assert sorted(s.id for s in by[name]) == sorted(stacks), name
    # a task's spans in order: loaded, stacked, launched, copied, saved
    for bid, ids in stacks.items():
        stack = next(s for s in by["runner.stack"] if s.id[0] == bid)
        launch = next(s for s in by["runner.launch"] if s.id == bid)
        copy = next(s for s in by["runner.copy_out"] if s.id == bid)
        for t in ids:
            load = next(s for s in by["runner.load"] if s.id == t)
            save = next(s for s in by["runner.save"] if s.id == t)
            assert load.end <= stack.start <= launch.start <= copy.start
            assert copy.end <= save.start
    assert runner.metrics.counts == {"load": 5, "proc": 5, "save": 5}
    assert set(runner.metrics.waits) == {"on load", "on device", "on save"}


def test_shortcut_tasks_wait_on_save_like_the_others(frames, tmp_path):
    """t == 0 and t == 1 tasks skip the device but go to the save stage
    through the same timed ``runner.wait_save``."""
    out = tmp_path / "out"
    out.mkdir()
    runner = R.PipelineRunner([_blend], batch_size=2)
    ts = [0.0, 1.0, 0.5, 0.0, 0.5, 1.0]
    assert runner.run(_tasks(frames, out, ts)) == []
    assert runner.metrics.sums.snapshot()["runner.wait_save"][0] == len(ts)
    assert runner.metrics.counts["proc"] == 2


@pytest.fixture(scope="module")
def v46_dir(tmp_path_factory):
    from rife_tpu_torch.models.v46_arch import write_flownet_param

    return write_flownet_param(tmp_path_factory.mktemp("spans"),
                               (16, 16, 16, 16))


def test_session_step_spans_on_the_cpu(v46_dir, monkeypatch):
    """``process_batch``: ``session.step`` holds ``session.upload`` and
    ``session.forward``, which holds ``executor.run`` (the flownet); then
    ``session.wait`` and ``session.download``, all with the step's number;
    no CUDA event on the CPU."""
    from rife_tpu_torch import RIFE

    sess = RIFE(str(v46_dir), device="cpu")
    assert sess._timer is None

    def no_event(*a, **k):
        raise AssertionError("a CUDA event on the CPU")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 256, (1, 64, 96, 3), np.uint8) for _ in range(2))
    first = max((s.seq for s in P.spans()), default=-1)
    for _ in range(2):
        sess.process_batch(a, b, np.array([0.5], np.float32))
    mine = [s for s in P.spans() if s.seq > first]
    seq = {s.seq: s for s in mine}
    steps = [s for s in mine if s.name == "session.step"]
    assert [s.id for s in steps] == [0, 1]
    for step in steps:
        kids = {s.name: s for s in mine if s.parent == step.seq}
        assert set(kids) == {"session.upload", "session.forward"}
        (run,) = [s for s in mine if s.parent == kids["session.forward"].seq]
        assert run.name == "executor.run" and run.id == "flownet"
        assert kids["session.upload"].end <= kids["session.forward"].start
        after = [s for s in mine if s.id == step.id and s.parent is None
                 and s is not step]
        assert [s.name for s in after] == ["session.wait", "session.download"]
        assert step.end <= after[0].start <= after[1].start
        assert seq[run.parent].parent == step.seq
    assert not any(k in P.device_ms() for k in seq)


class FakeEvent:
    """Stands in for ``torch.cuda.Event``: complete once ``done`` is set."""
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t, self.done = None, False

    def record(self, stream=None):
        self.t, self.done = stream.now, False
        stream.events.append(self)

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t - self.t

    def synchronize(self):
        self.done = True


def test_event_pool_reuses_completed_pairs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.made = 0
    rec = P.Recorder()
    timer = P.EventTimer(cap=3, recorder=rec)
    stream = SimpleNamespace(now=0.0, events=[])

    def step(seq, ms):
        pair = timer.start(stream)
        if pair is None:
            return None
        stream.now += ms
        return timer.stop(pair, stream, seq)

    for seq in range(3):
        assert step(seq, 10.0 + seq) is not None
    assert step(3, 1.0) is None and timer.untimed == 1  # all pending
    for e in stream.events:
        e.done = True
    assert not rec.device
    # the pool ran dry: the completed pairs are read, then reused
    assert step(4, 20.0) is not None
    assert FakeEvent.made == 6
    assert list(rec.device) == [(0, 10.0), (1, 11.0), (2, 12.0)]
    for e in stream.events[-2:]:
        e.done = True
    timer.reap()
    assert list(rec.device)[-1] == (4, 20.0)
    # a timer freed with completed pairs pending keeps their times
    assert step(5, 30.0) is not None
    for e in stream.events[-2:]:
        e.done = True
    del timer
    import gc
    gc.collect()
    assert list(rec.device)[-1] == (5, 30.0)


def test_trace_writes_the_spans_beside_the_profilers_events(monkeypatch,
                                                             tmp_path):
    monkeypatch.delenv("RIFE_TORCH_TRACE", raising=False)
    with P.span("before_the_window"):
        pass
    with P.trace(str(tmp_path)):
        with P.span("traced_outer", 3):
            with P.span("traced_inner"):
                torch.ones(64).add(1)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "rife_span"}
    assert set(mine) == {"traced_outer", "traced_inner"}
    add = next(e for e in events if e.get("name") == "aten::add")
    inner = mine["traced_inner"]
    assert inner["ts"] <= add["ts"]
    assert add["ts"] + add["dur"] <= inner["ts"] + inner["dur"] + 1e-3
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("name") == "thread_name" and e["pid"] == inner["pid"]}
    assert rows[inner["tid"]] == threading.current_thread().name
    assert mine["traced_outer"]["args"]["id"] == "3"


@pytest.mark.parametrize("events", ["[]", '[{"ph": "X", "name": "k", '
                                    '"ts": 5, "dur": 1, "pid": 1, "tid": 1}]'])
def test_spans_go_into_the_exported_text(tmp_path, events):
    """The spans are put at the head of ``traceEvents`` as text: the file
    stays JSON whether the profiler wrote events or none."""
    class Prof:
        def export_chrome_trace(self, path):
            Path(path).write_text('{"schemaVersion": 1, '
                                  '"baseTimeNanoseconds": 1000, '
                                  f'"traceEvents": {events}, '
                                  '"traceName": "x"}')

    with P.span("exported") as f:
        pass
    s = next(s for s in P.spans() if s.seq == f.seq)
    path = P._write_trace(Prof(), str(tmp_path), (s.start, s.end))
    data = json.loads(Path(path).read_text())
    mine = [e for e in data["traceEvents"] if e.get("cat") == "rife_span"]
    assert [e["name"] for e in mine] == ["exported"]
    assert mine[0]["ts"] == (P.trace_ns(s.start) - 1000) / 1e3
    assert len(data["traceEvents"]) == len(json.loads(events)) + 3
    assert data["traceName"] == "x"


# -- the benchmark's readers ------------------------------------------------

def _reader(name):
    from portbench import harness
    return harness.metric_reader(name)


class Ev:
    def __init__(self, name, t0, t1, cuda=True):
        self._n, self._t0, self._t1, self._cuda = name, t0, t1, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return False


def S(name, t0, t1, seq, parent=None, role="proc", id=None):
    return P.Span(name, t0, t1, role, id, parent, seq, 0, 0.0)


def _view(monkeypatch, events, spans, counters, device=None):
    from portbench import harness
    from portbench import spans as PS

    prog = SimpleNamespace(spans=lambda: spans, trace_ns=lambda t: int(t),
                           device_ms=lambda: dict(device or {}))
    monkeypatch.setattr(PS, "program", lambda: prog)
    cell = SimpleNamespace(profiler=SimpleNamespace(events={"window": events}))
    return harness.MetricView(cell, harness.Outcome(
        metrics={}, attempted=1, counters=counters), SimpleNamespace(), None)


def test_pipeline_readers_by_hand(monkeypatch):
    """The profiled run (device events 100-950) gives the idle share; the
    untraced run before it (-1000 to -100) the proc thread's shares."""
    events = [Ev("k", 100, 200), Ev("k", 150, 300),
              Ev("Memcpy HtoD (Pinned -> Device)", 500, 600),
              Ev("k", 900, 950), Ev("cudaLaunchKernel", 0, 5000, cuda=False)]
    spans = [S("runner.run", -1000, -100, 0, role="MainThread"),
             S("runner.stack", -990, -890, 1, id=(0, (0, 1))),
             S("runner.launch", -890, -700, 2, id=0),
             S("session.step", -890, -710, 3, parent=2, id=0),
             S("runner.stack", -700, -600, 4, id=(1, (2, 3))),
             S("session.step", -500, -400, 5, role="other"),
             S("runner.run", 50, 1000, 10, role="MainThread"),
             S("runner.stack", 60, 120, 11, id=(2, (4, 5))),
             S("runner.launch", 120, 345, 12, id=2),
             S("session.step", 120, 340, 13, parent=12, id=2),
             S("runner.stack", 350, 550, 14, id=(3, (6, 7))),
             S("runner.stack", 2000, 2100, 16)]  # a later run
    view = _view(monkeypatch, events, spans,
                 {"window_s": 1e-6, "free_window_s": 1e-6})
    # idle in [50, 1000]: 50-100, 300-500, 600-900, 950-1000 (600 ns);
    # under a stack: 60-100 and 350-500 (190 ns)
    assert _reader("idle_under_stack_share.pipeline").read(view) == \
        pytest.approx(100 * 190 / 600)
    # untraced: stacks 100 + 100 ns, the proc thread's step 180 ns, of 1 us
    assert _reader("proc_stack_share.pipeline").read(view) == \
        pytest.approx(20.0)
    assert _reader("proc_dispatch_share.pipeline").read(view) == \
        pytest.approx(18.0)


def _call(k, seq0, run=120):
    o = 400 * k
    return [S("session.step", 100 + o, 280 + o, seq0, role="MainThread", id=k),
            S("session.upload", 105 + o, 135 + o, seq0 + 1, seq0, id=k),
            S("session.forward", 140 + o, 275 + o, seq0 + 2, seq0, id=k),
            S("executor.run", 150 + o, 150 + run + o, seq0 + 3, seq0 + 2,
              id="flownet"),
            S("session.wait", 280 + o, 295 + o, seq0 + 4, id=k),
            S("session.download", 295 + o, 325 + o - k, seq0 + 5, id=k)]


def test_pair_readers_by_hand(monkeypatch):
    """Calls -4 to -2 before the window (the untraced run, its last two
    counted), calls 0 and 1 in it."""
    events = []
    for k in range(2):
        o = 400 * k
        events += [Ev("Memcpy HtoD (Pageable -> Device)", 110 + o, 130 + o),
                   Ev("k", 200 + o, 260 + o),
                   Ev("Memcpy DtoH (Device -> Pageable)", 300 + o, 320 + o)]
    spans = (_call(-4, 100, 50) + _call(-3, 110, 100) + _call(-2, 120, 110)
             + _call(0, 10) + _call(1, 20))
    view = _view(monkeypatch, events, spans, {"calls": 2})
    assert _reader("dispatch_ms.pair").read(view) == pytest.approx(105e-6)
    # uploads 30 + 30, downloads 33 + 32 ns over two calls
    assert _reader("copy_host_ms.pair").read(view) == pytest.approx(62.5e-6)
    # idle within a window call: 100-110, 130-200, 260-300, 320-325 (125
    # ns; call 1 ends at 724: 124); under executor.run: 150-200, 260-270
    assert _reader("idle_under_dispatch_share.pair").read(view) == \
        pytest.approx(100 * 120 / 249)


def test_batch_readers_by_hand(monkeypatch):
    """Steps 0 and 1 untraced, 2 and 3 in the window."""
    events = [Ev("k", 210, 350), Ev("k", 360, 450)]
    spans = [S("session.step", 0, 100, 10, role="MainThread", id=0),
             S("executor.run", 5, 85, 11, 10),
             S("session.step", 100, 200, 12, role="MainThread", id=1),
             S("executor.run", 105, 195, 13, 12),
             S("session.step", 200, 300, 20, role="MainThread", id=2),
             S("executor.run", 205, 290, 21, 20),
             S("session.step", 300, 400, 22, role="MainThread", id=3),
             S("executor.run", 305, 390, 23, 22)]
    view = _view(monkeypatch, events, spans, {"steps": 2},
                 device={10: 40.0, 12: 41.0, 20: 47.0, 22: 48.0})
    assert _reader("step_device_ms.batch").read(view) == pytest.approx(40.5)
    assert _reader("dispatch_ms.batch").read(view) == pytest.approx(85e-6)


NEW = ("proc_stack_share.pipeline", "proc_dispatch_share.pipeline",
       "idle_under_stack_share.pipeline", "dispatch_ms.pair",
       "copy_host_ms.pair", "idle_under_dispatch_share.pair",
       "step_device_ms.batch", "dispatch_ms.batch")


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_the_recorder(monkeypatch, name):
    """On a program without the span recorder, or without device events
    in the window, each reader returns None."""
    from portbench import spans as PS

    with monkeypatch.context() as m:
        m.delattr(P, "spans")
        assert PS.program() is None
    counters = {"window_s": 1.0, "free_window_s": 1.0, "calls": 1,
                "steps": 1}
    view = _view(monkeypatch, [Ev("k", 110, 120)], _call(-1, 1) + _call(0, 9),
                 counters)
    monkeypatch.setattr(PS, "program", lambda: None)
    assert _reader(name).read(view) is None
    view = _view(monkeypatch, [Ev("k", 10, 20, cuda=False)], _call(0, 1),
                 counters)
    assert _reader(name).read(view) is None


def test_step_profile_idle_takes_the_union():
    spec = importlib.util.spec_from_file_location(
        "torch_step_profile", ROOT / "tools" / "torch_step_profile.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    events = [Ev("a", 0, 100), Ev("b", 50, 150), Ev("c", 200, 300),
              Ev("host", 0, 1000, cuda=False)]
    assert tool.busy_us(events) == 0.25
