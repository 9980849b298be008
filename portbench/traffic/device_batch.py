"""``device_batch``: batches of pairs resident on the card, stepped through
``RIFE.process_batch_device`` in a closed loop with ``in_flight`` steps
queued (the runner's depth): step n+1 is dispatched while step n runs, and
the loop waits for step n-1 before it dispatches further.

The clip's ``frames`` frames give ``frames - 1`` consecutive pairs, cut
into batches of ``batch`` and cycled.  The window lasts ``--seconds`` and
ends at the synchronize after its last step; ``frames_per_s`` is the frames
of every step over that time.  A traced run times ``trace_steps`` steps
untraced (``free_window_s``: the pace the step's share of the peak and the
device's idle share are taken at), then profiles ``trace_steps`` more, then
``gap_steps`` for the idle gaps' span.  The outputs of ``sample_steps``
steps, drawn from the seed, are judged.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from ..harness import Outcome
from .common import Reservoir


def _loop(cell, sess, batches, ts, in_flight, stop, keep=None) -> int:
    queued = deque()
    n = 0
    while not stop(n):
        a, b = batches[n % len(batches)]
        out = sess.process_batch_device(a, b, ts)
        queued.append(cell.done_marker())
        if keep is not None:
            keep((n, out))
        n += 1
        if len(queued) >= in_flight:
            queued.popleft().synchronize()
    cell.sync()
    return n


def run(cell, sess, clip) -> Outcome:
    wl = cell.wl
    bsz = wl["batch"]
    n_batches = (clip.shape[0] - 1) // bsz
    batches = [(clip[k * bsz:(k + 1) * bsz], clip[k * bsz + 1:(k + 1) * bsz + 1])
               for k in range(n_batches)]
    ts = np.full(bsz, wl["timestep"], np.float32)
    in_flight = wl["in_flight"]
    _loop(cell, sess, batches, ts, in_flight,
          lambda n: n >= wl["warmup_steps"])
    sample = Reservoir(cell.rng("sample"), wl["sample_steps"])
    t0 = cell.start_window()
    if cell.traced:
        steps = _loop(cell, sess, batches, ts, in_flight,
                      lambda n: n >= wl["trace_steps"], sample.offer)
        free = time.perf_counter() - t0
        with cell.profiler.window():
            t0 = time.perf_counter()
            _loop(cell, sess, batches, ts, in_flight,
                  lambda n: n >= steps)
            t1 = time.perf_counter()
        with cell.profiler.gaps():
            _loop(cell, sess, batches, ts, in_flight,
                  lambda n: n >= wl["gap_steps"])
    else:
        steps = _loop(cell, sess, batches, ts, in_flight,
                      lambda n: time.perf_counter() - t0 >= cell.seconds,
                      sample.offer)
        t1 = time.perf_counter()
        free = t1 - t0
    frames = steps * bsz
    kept = []
    for n, out in sample.items:
        k = n % n_batches
        kept += [(k * bsz + r, out[r]) for r in range(bsz)]
    return Outcome(metrics={"frames_per_s": frames / free},
                   attempted=frames, sample=kept,
                   counters={"steps": steps, "frames": frames,
                             "window_s": t1 - t0, "free_window_s": free})
