"""``host_pipeline``: the CLI's runner, ``io/runner.py`` ``PipelineRunner``,
over a clip in host memory: one session, batch ``batch``, the pinned
side-stream device path (``device_fns`` + the card as device),
``loader_threads`` decode and ``saver_threads`` encode threads.

Decode and encode are the codecs' places on the runner module; the run
puts the in-memory clip and a sink keyed by task id there, and puts the
codecs back after.  Task i interpolates pair i mod (frames - 1).  The
window is one ``PipelineRunner.run``, sized from warm-up runs' rate to
last about ``--seconds`` (traced: a run of ``trace_frames`` tasks, whose
wall time and waits are read, then one as long under the profiler, then a
run of ``gap_frames`` for the idle gaps' span);
``pipeline_frames_per_s`` is the frames delivered to the sink over its wall
time.  The sink keeps the answers of ``sample_tasks`` task ids drawn from
the seed, and counts every delivery: a task delivered never, twice or
malformed is ``missing``.
"""

from __future__ import annotations

import math
import time

import numpy as np

from ..harness import Outcome


class _Sink:
    def __init__(self, keep, shape):
        self.keep, self.shape = set(keep), shape
        self.kept, self.seen, self.bad = {}, {}, 0

    def __call__(self, path, img):
        i = int(path)
        self.seen[i] = self.seen.get(i, 0) + 1
        if img.shape != self.shape or img.dtype != np.uint8:
            self.bad += 1
        elif i in self.keep:
            self.kept[i] = np.array(img, copy=True)


def _tasks(R, n, n_pairs, t):
    return [R.Task(id=i, in0_path=str(i % n_pairs),
                   in1_path=str(i % n_pairs + 1), out_path=str(i),
                   timestep=t) for i in range(n)]


def run(cell, sess, clip) -> Outcome:
    from rife_tpu_torch.io import runner as R

    wl = cell.wl
    frames = [f.numpy() for f in clip.cpu()]
    n_pairs = len(frames) - 1
    bsz, t = wl["batch"], wl["timestep"]
    shape = frames[0].shape

    def one_run(n, sink):
        runner = R.PipelineRunner(
            [sess.process_batch], jobs_load=wl["loader_threads"],
            jobs_save=wl["saver_threads"], batch_size=bsz,
            device_fns=[sess.process_batch_device], devices=[cell.device])
        R.encode_image = sink
        t0 = time.perf_counter()
        errors = runner.run(_tasks(R, n, n_pairs, t))
        return time.perf_counter() - t0, errors, runner.metrics

    codecs = R.decode_image, R.encode_image
    try:
        R.decode_image = lambda path: frames[int(path)]
        # the first warm-up run pays the first use of every shape; the
        # rate is the margin between the other two
        warm = [one_run(bsz * k, _Sink((), shape))[0]
                for k in wl["warmup_batches"]]
        k1, k2 = wl["warmup_batches"][1:]
        rate = bsz * (k2 - k1) / (warm[2] - warm[1])
        if not 0 < rate < 1e4:
            rate = bsz * k2 / warm[2]
        n = (wl["trace_frames"] if cell.traced
             else bsz * max(2, math.ceil(rate * cell.seconds / bsz)))
        keep = cell.rng("sample").choice(n, size=min(n, wl["sample_tasks"]),
                                         replace=False)
        sink = _Sink(keep.tolist(), shape)
        cell.start_window()
        wall, errors, stages = one_run(n, sink)
        traced_wall = wall
        if cell.traced:
            with cell.profiler.window():
                traced_wall = one_run(n, _Sink((), shape))[0]
            with cell.profiler.gaps():
                one_run(wl["gap_frames"], _Sink((), shape))
    finally:
        R.decode_image, R.encode_image = codecs
    delivered = sum(1 for i in range(n) if sink.seen.get(i) == 1)
    missing = n - delivered + sink.bad + sum(
        1 for i in sink.seen if not 0 <= i < n)
    waits = dict(stages.waits)
    return Outcome(
        metrics={"pipeline_frames_per_s": delivered / wall},
        attempted=n, failed=len(errors), missing=missing,
        sample=[(i % n_pairs, sink.kept[i]) for i in sorted(sink.kept)],
        counters={"frames": delivered, "window_s": traced_wall,
                  "free_window_s": wall,
                  "wait_on_device_s": waits.get("on device", 0.0),
                  "wait_on_load_s": waits.get("on load", 0.0),
                  "wait_on_save_s": waits.get("on save", 0.0)},
        notes=[f"runner: {n} tasks, warm-up rate {rate!r} frames/s; "
               f"{stages.summary()}"] + [f"runner error: {e}"
                                         for e in errors[:5]])
