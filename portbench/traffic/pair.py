"""``pair``: one pair at a time through ``RIFE.process`` in a closed loop,
(H,W,3) u8 frames in host memory in and out, the next call as soon as the
previous returns.  Pairs cycle through the clip's consecutive pairs.

Every call's latency is taken by the host clock; the window lasts
``--seconds`` and ``latency_p50_ms`` / ``latency_p95_ms`` are the median
and 95th percentile of all its calls.  A traced run times ``trace_calls``
calls untraced (``free_window_s``), then profiles ``trace_calls`` more,
then ``gap_calls`` for the idle gaps' span.
The answers of ``sample_calls`` calls, drawn from the seed, are judged.
"""

from __future__ import annotations

import time

import numpy as np

from ..harness import Outcome
from .common import Reservoir


def run(cell, sess, clip) -> Outcome:
    wl = cell.wl
    frames = [f.numpy() for f in clip.cpu()]
    n_pairs = len(frames) - 1
    t = wl["timestep"]
    for p in range(wl["warmup_calls"]):
        sess.process(frames[p % n_pairs], frames[p % n_pairs + 1], t)
    sample = Reservoir(cell.rng("sample"), wl["sample_calls"])
    lat = []
    t0 = cell.start_window()
    n = 0
    while True:
        p = n % n_pairs
        c0 = time.perf_counter()
        out = sess.process(frames[p], frames[p + 1], t)
        c1 = time.perf_counter()
        lat.append(c1 - c0)
        sample.offer((p, out))
        n += 1
        if (n >= wl["trace_calls"] if cell.traced
                else c1 - t0 >= cell.seconds):
            break
    t1 = time.perf_counter()
    free = t1 - t0
    if cell.traced:
        with cell.profiler.window():
            t0 = time.perf_counter()
            for k in range(n):
                sess.process(frames[k % n_pairs], frames[k % n_pairs + 1], t)
            t1 = time.perf_counter()
        with cell.profiler.gaps():
            for k in range(wl["gap_calls"]):
                sess.process(frames[k % n_pairs], frames[k % n_pairs + 1], t)
    ms = np.asarray(lat) * 1e3
    return Outcome(
        metrics={"latency_p50_ms": float(np.percentile(ms, 50)),
                 "latency_p95_ms": float(np.percentile(ms, 95))},
        attempted=n, sample=list(sample.items),
        counters={"calls": n, "frames": n, "window_s": t1 - t0,
                  "free_window_s": free},
        notes=[f"latency over {n} calls: p50 "
               f"{float(np.percentile(ms, 50))!r} ms, p95 "
               f"{float(np.percentile(ms, 95))!r} ms, max "
               f"{float(ms.max())!r} ms"])
