"""The port's PipelineRunner (``rife_tpu_torch/io/runner.py``) with fake
device steps (no model): ``tests/test_runner.py``'s six cases against the
port, the async case on torch CPU tensors, plus the port's own rules (several
sessions pad every partial batch; the proc stage's waits are recorded)."""

import numpy as np
import pytest

import torch

from rife_tpu_torch.io.runner import PipelineRunner, Task


@pytest.fixture
def frames(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        p = tmp_path / f"{i:03d}.png"
        Image.fromarray(
            rng.integers(0, 255, (16, 24, 3)).astype(np.uint8)
        ).save(p)
        paths.append(str(p))
    return paths


def _mean_blend(in0, in1, ts):
    t = ts.reshape(-1, 1, 1, 1).astype(np.float32)
    return ((1 - t) * in0 + t * in1).astype(np.uint8)


def _tasks(paths, out_dir, n):
    return [
        Task(
            id=i,
            in0_path=paths[i % len(paths)],
            in1_path=paths[(i + 1) % len(paths)],
            out_path=str(out_dir / f"{i:04d}.png"),
            timestep=0.25 + 0.5 * (i % 2),
        )
        for i in range(n)
    ]


def test_runner_sync_path(frames, tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    runner = PipelineRunner([_mean_blend], batch_size=4)
    errors = runner.run(_tasks(frames, out, 10))
    assert errors == []
    assert len(list(out.iterdir())) == 10


def test_runner_async_device_path(frames, tmp_path):
    """device_fns dispatch without blocking; the downloader drains them.
    A torch CPU tensor stands in for the device output (np.asarray
    materializes it)."""
    out = tmp_path / "out"
    out.mkdir()
    calls = []

    def device_fn(in0, in1, ts):
        calls.append(len(ts))
        return torch.from_numpy(_mean_blend(in0, in1, ts))

    def never(*a):  # sync fn must not be used when device_fns are given
        raise AssertionError("sync path used")

    runner = PipelineRunner([never], batch_size=4, device_fns=[device_fn])
    errors = runner.run(_tasks(frames, out, 11))
    assert errors == []
    assert len(list(out.iterdir())) == 11
    # 11 tasks -> 2 full batches + tail of 3 PADDED to 4 (every step of one
    # shape runs at one B)
    assert calls == [4, 4, 4]


def test_runner_tail_batch_padded_to_one_shape(frames, tmp_path):
    """N % batch != 0 must not produce a second batch shape once a full
    batch has been seen — but a run smaller than one batch must NOT be
    padded up (no reason to compile a bigger shape than the workload)."""
    out = tmp_path / "out"
    out.mkdir()
    shapes = []

    def fn(in0, in1, ts):
        shapes.append(in0.shape)
        return _mean_blend(in0, in1, ts)

    runner = PipelineRunner([fn], batch_size=4)
    assert runner.run(_tasks(frames, out, 10)) == []
    assert len(list(out.iterdir())) == 10
    assert {s[0] for s in shapes} == {4}  # one compiled batch shape

    shapes.clear()
    out2 = tmp_path / "out2"
    out2.mkdir()
    runner = PipelineRunner([fn], batch_size=4)
    assert runner.run(_tasks(frames, out2, 3)) == []
    assert [s[0] for s in shapes] == [3]  # sub-batch run stays unpadded


def test_runner_async_error_capture(frames, tmp_path):
    out = tmp_path / "out"
    out.mkdir()

    def boom(in0, in1, ts):
        raise RuntimeError("device on fire")

    runner = PipelineRunner([lambda *a: None], batch_size=2,
                            device_fns=[boom])
    errors = runner.run(_tasks(frames, out, 4))
    assert errors and "device on fire" in errors[0]
    assert len(list(out.iterdir())) == 0


def test_runner_save_backpressure(frames, tmp_path, monkeypatch):
    """A slow encoder must propagate backpressure to proc: live rendered
    frames are bounded by tosave depth + 2*jobs_save in-flight encodes,
    NOT by the task count (the reference's bounded-queue memory contract,
    the reference's src/main.cpp:259)."""
    import threading
    import rife_tpu_torch.io.runner as runner_mod

    out = tmp_path / "out"
    out.mkdir()
    live = 0
    peak = 0
    lock = threading.Lock()

    real_encode = runner_mod.encode_image

    def slow_encode(path, arr):
        nonlocal live
        import time as _t
        _t.sleep(0.03)
        real_encode(path, arr)
        with lock:
            live -= 1

    monkeypatch.setattr(runner_mod, "encode_image", slow_encode)

    def fast_proc(in0, in1, ts):
        nonlocal live, peak
        with lock:
            live += len(ts)
            peak = max(peak, live)
        return _mean_blend(in0, in1, ts)

    n = 64
    jobs_save = 2
    runner = PipelineRunner([fast_proc], batch_size=1, jobs_save=jobs_save)
    errors = runner.run(_tasks(frames, out, n))
    assert errors == []
    assert len(list(out.iterdir())) == n
    # bound: tosave depth (8) + 2*jobs_save in-flight encodes + 1 held by
    # proc while put() blocks + 1 held by save between get() and acquire()
    bound = runner_mod.QUEUE_DEPTH + 2 * jobs_save + 2
    assert peak <= bound, f"peak live frames {peak} > bound {bound}"


def test_runner_per_device_batch_sizes(frames, tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    seen = {0: [], 1: []}

    def mk(i):
        def fn(in0, in1, ts):
            seen[i].append(len(ts))
            return _mean_blend(in0, in1, ts)
        return fn

    runner = PipelineRunner([mk(0), mk(1)], batch_size=[2, 3])
    errors = runner.run(_tasks(frames, out, 12))
    assert errors == []
    assert len(list(out.iterdir())) == 12
    # several sessions on one queue: every batch is padded to its
    # session's B, whichever tasks the race gave it
    assert all(n == 2 for n in seen[0]) and all(n == 3 for n in seen[1])


def test_runner_sync_path_outputs_match(frames, tmp_path):
    """Every output is the step's row for its own task, padded tail
    included: the runner's rows, read back, equal the blend of each task's
    decoded inputs."""
    from PIL import Image

    out = tmp_path / "out"
    out.mkdir()
    tasks = _tasks(frames, out, 10)
    runner = PipelineRunner([_mean_blend], batch_size=4)
    assert runner.run(tasks) == []
    for t in _tasks(frames, out, 10):
        a, b = (np.asarray(Image.open(p)) for p in (t.in0_path, t.in1_path))
        want = _mean_blend(a[None], b[None],
                           np.asarray([t.timestep], np.float32))[0]
        np.testing.assert_array_equal(np.asarray(Image.open(t.out_path)),
                                      want)


def test_runner_records_proc_waits(frames, tmp_path):
    """The proc stage's waits on load and save (and on the device on the
    async path) are recorded and printed in the summary."""
    out = tmp_path / "out"
    out.mkdir()
    runner = PipelineRunner([_mean_blend], batch_size=2,
                            device_fns=[lambda *a: torch.from_numpy(
                                _mean_blend(*a))])
    assert runner.run(_tasks(frames, out, 6)) == []
    assert set(runner.metrics.waits) == {"on load", "on device", "on save"}
    summary = runner.metrics.summary()
    assert "proc: 6 in" in summary and "proc waited on device" in summary


def test_runner_cuda_device_without_device_fn_takes_sync_path(frames,
                                                              tmp_path):
    """A session whose device_fn is None runs ``process_batch`` even where
    its device is named: no pinned memory, no stream."""
    out = tmp_path / "out"
    out.mkdir()
    calls = []

    def fn(in0, in1, ts):
        calls.append(type(in0))
        return _mean_blend(in0, in1, ts)

    runner = PipelineRunner([fn], batch_size=4, device_fns=[None],
                            devices=[torch.device("cpu")])
    assert runner.run(_tasks(frames, out, 5)) == []
    assert calls == [np.ndarray, np.ndarray]
    with pytest.raises(ValueError, match="one device_fn"):
        PipelineRunner([fn, fn], device_fns=[None])
