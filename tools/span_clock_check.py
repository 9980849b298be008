"""The span recorder (``rife_tpu_torch/utils/profiling.py``) on the card:
its clock against ``torch.profiler``'s device events, the CUDA event pairs
against the trace's busy time, and what the recorder and ``trace()``'s
export cost.

On the v4.6-architecture graph (in-repo reconstruction, synthetic weights,
bf16, 1080p):

1. pair: ``RIFE.process`` on host frames, ``--calls`` calls under a
   CUDA-only profile: each call's first host-to-device memcpy must start
   inside that call's ``session.upload`` span (mapped by ``trace_ns``);
2. batch: B=8 steps on frames resident on the card, two in flight, as the
   benchmark's device cells run them: the untraced period a step and the
   mean of those steps' event pairs (``device_ms``), then as many steps
   profiled: the union of the device intervals a step.  The untraced
   steps' mean should lie between the busy time and the period;
3. costs: a span opened and closed, an event pair recorded, ``RIFE.process``
   calls with the recorder and without it (its spans and event pairs
   switched off), in turns call by call on one CPU, and ``trace()``'s
   export (the profiler's Chrome export alone, then with the spans added).

Prints one JSON line a part; exits 1 when a check fails.  Needs one NVIDIA
GPU.

Run: python tools/span_clock_check.py [--calls 50] [--steps 48]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _device_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def _union_ns(events) -> int:
    total, edge = 0, None
    for s, e in sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in events):
        if edge is None or s > edge:
            total, edge = total + e - s, e
        elif e > edge:
            total, edge = total + e - edge, e
    return total


def check_pair(sess, frames, calls, P):
    from torch.profiler import ProfilerActivity, profile

    for k in range(3):
        sess.process(frames[k], frames[k + 1], 0.5)
    first = max((s.seq for s in P.spans()), default=-1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(calls):
            sess.process(frames[k % 8], frames[k % 8 + 1], 0.5)
    ups = sorted((s for s in P.spans()
                  if s.seq > first and s.name == "session.upload"),
                 key=lambda s: s.start)
    htod = sorted(e.start_ns() for e in _device_events(prof)
                  if "HtoD" in e.name() and "Pageable" in e.name())
    inside, lead, lag = 0, [], []
    for i, up in enumerate(ups):
        s, e = P.trace_ns(up.start), P.trace_ns(up.end)
        nxt = P.trace_ns(ups[i + 1].start) if i + 1 < len(ups) else 2 ** 63
        first_copy = next((t for t in htod if s <= t < nxt), None)
        if first_copy is None:
            # the copy started before the span: the clocks disagree
            first_copy = max((t for t in htod if t < s), default=None)
        if first_copy is not None and s <= first_copy <= e:
            inside += 1
        if first_copy is not None:
            lead.append((first_copy - s) / 1e3)
            lag.append((e - first_copy) / 1e3)
    return {"calls": len(ups), "first_htod_inside_upload": inside,
            "us_from_upload_start": [min(lead), max(lead)] if lead else None,
            "us_to_upload_end": [min(lag), max(lag)] if lag else None}


def _loop(sess, batches, ts, steps):
    queued = []
    for n in range(steps):
        a, b = batches[n % len(batches)]
        sess.process_batch_device(a, b, ts)
        ev = torch.cuda.Event()
        ev.record()
        queued.append(ev)
        if len(queued) >= 2:
            queued.pop(0).synchronize()
    torch.cuda.synchronize()


def check_batch(sess, clip, steps, P):
    from torch.profiler import ProfilerActivity, profile

    batches = [(clip[k * 8:(k + 1) * 8], clip[k * 8 + 1:(k + 1) * 8 + 1])
               for k in range(4)]
    ts = np.full(8, 0.5, np.float32)
    _loop(sess, batches, ts, 8)

    def event_ms(first):
        ms = P.device_ms()
        got = [ms[s.seq] for s in P.spans()
               if s.seq > first and s.name == "session.step" and s.seq in ms]
        return (sum(got) / len(got) if got else None), len(got)

    first = max((s.seq for s in P.spans()), default=-1)
    t0 = time.perf_counter()
    _loop(sess, batches, ts, steps)
    period = (time.perf_counter() - t0) / steps * 1e3
    event, timed = event_ms(first)
    first = max(s.seq for s in P.spans())
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _loop(sess, batches, ts, steps)
    traced_period = (time.perf_counter() - t0) / steps * 1e3
    busy = _union_ns(_device_events(prof)) / steps / 1e6
    return {"steps": steps, "timed_steps": timed,
            "busy_ms_a_step": busy, "step_device_ms": event,
            "untraced_period_ms": period,
            "between": event is not None and busy <= event <= period,
            "traced_period_ms": traced_period,
            "traced_step_device_ms": event_ms(first)[0]}


class _Off:
    """A span that records nothing."""

    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def recorder_ab(sess, frames, calls):
    """p50 ms of ``RIFE.process`` with the recorder and without it, the two
    in turns call by call, on one CPU as the benchmark's pair cell runs.
    Off: no span, no event pair, and ``process_batch`` as it was before
    the recorder (the step, then ``.cpu()``)."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine import session as S
    from rife_tpu_torch.graph import executor as X

    def plain(in0, in1, ts):
        return RIFE.process_batch_device(sess, in0, in1, ts).cpu().numpy()

    timer, spans = sess._timer, (S.span, X.span)
    cpus, threads = os.sched_getaffinity(0), torch.get_num_threads()
    os.sched_setaffinity(0, {max(cpus)})
    torch.set_num_threads(1)
    lat = {"on": [], "off": []}
    try:
        for k in range(2 * calls):
            arm = ("on", "off")[(k + k // 2) % 2]  # on off off on on off ...
            if arm == "off":
                S.span = X.span = _Off
                sess._timer = None
                sess.process_batch = plain
            p = k // 2 % 8
            t0 = time.perf_counter()
            sess.process(frames[p], frames[p + 1], 0.5)
            lat[arm].append(time.perf_counter() - t0)
            S.span, X.span = spans
            sess._timer = timer
            sess.__dict__.pop("process_batch", None)
    finally:
        os.sched_setaffinity(0, cpus)
        torch.set_num_threads(threads)
    return {arm: {"p50_ms": float(np.median(v)) * 1e3,
                  "p95_ms": float(np.percentile(v, 95)) * 1e3,
                  "calls": len(v)} for arm, v in lat.items()}


def costs(sess, clip, frames, P):
    from torch.profiler import ProfilerActivity, profile

    n = 100_000
    t0 = time.perf_counter()
    for i in range(n):
        with P.span("cost.span", i):
            pass
    span_us = (time.perf_counter() - t0) / n * 1e6
    timer = P.EventTimer()
    stream = torch.cuda.current_stream()
    m = 2000
    t0 = time.perf_counter()
    for i in range(m):
        pair = timer.start(stream)
        if pair is not None:
            timer.stop(pair, stream, -1)
    pair_us = (time.perf_counter() - t0) / m * 1e6
    torch.cuda.synchronize()
    a, b = clip[:8], clip[1:9]
    ts = np.full(8, 0.5, np.float32)

    def profiled():
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        w0 = time.perf_counter()
        with prof:
            for _ in range(3):
                sess.process_batch_device(a, b, ts)
            torch.cuda.synchronize()
        return prof, (w0, time.perf_counter())

    out = {"span_us": span_us, "event_pair_us": pair_us}
    with tempfile.TemporaryDirectory() as d:
        for k in range(2):
            prof, _ = profiled()
            t0 = time.perf_counter()
            prof.export_chrome_trace(str(Path(d) / f"plain{k}.json"))
            out.setdefault("export_s", []).append(time.perf_counter() - t0)
            prof, window = profiled()
            t0 = time.perf_counter()
            path = P._write_trace(prof, d, window)
            out.setdefault("export_with_spans_s", []).append(
                time.perf_counter() - t0)
        out["trace_bytes"] = [(Path(d) / "plain1.json").stat().st_size,
                              Path(path).stat().st_size]
        out["spans_in_trace"] = sum(
            e.get("cat") == "rife_span"
            for e in json.loads(Path(path).read_text())["traceEvents"])
    out["process"] = recorder_ab(sess, frames, 600)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--steps", type=int, default=48)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.models.v46_arch import write_flownet_param
    from rife_tpu_torch.utils import profiling as P

    model = write_flownet_param(ROOT / "rife_tpu_torch" / "_build" / "models")
    sess = RIFE(str(model), device="cuda")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (1080, 1920 + 66, 3), np.uint8)
    frames = [np.ascontiguousarray(base[:, 2 * k:2 * k + 1920])
              for k in range(33)]
    clip = torch.from_numpy(np.stack(frames)).cuda()
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    pair = check_pair(sess, frames, args.calls, P)
    print(json.dumps({"pair": pair}), flush=True)
    batch = check_batch(sess, clip, args.steps, P)
    print(json.dumps({"batch": batch}), flush=True)
    print(json.dumps({"costs": costs(sess, clip, frames, P)}), flush=True)
    ok = pair["first_htod_inside_upload"] == pair["calls"] and batch["between"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
