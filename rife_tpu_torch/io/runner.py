"""Three-stage load -> proc -> save pipeline runtime (port of
``rife_tpu/io/runner.py``).

The reference runs this as producer/consumer threads over two bounded
queues with a poison-pill shutdown (the reference's src/main.cpp:231-436).
The topology is ``rife_tpu``'s: decode pool, one proc thread per device
session, encode pool, bounded queues of depth 8; the proc stage packs tasks
into fixed-size batches per frame shape, and once a full batch of a shape
has run, a tail batch of that shape is padded up to it, so every step of one
shape has the same B.

The device path of the proc stage is rewritten for CUDA (``_CudaStaging``):
each batch is stacked into a pinned host slot, copied to the card with
``non_blocking=True`` on the session device's current stream, stepped with
``process_batch_device``, and copied back into the slot's pinned output on
a side stream that waits on the compute stream; an event recorded after
that copy is what a download thread waits on before it hands the rows to the
save stage and frees the slot.  At most two batches are in flight per
session, so upload, compute, download and the codecs overlap.  A session on
the CPU takes the sync path (``process_batch``): pinning memory would
initialise CUDA.

Every stage records spans (``utils/profiling.py``), on threads whose roles
are ``load``, ``proc``, ``download`` and ``save``: ``runner.run`` (the
caller), ``runner.load`` and ``runner.save`` (a task id), ``runner.wait_load``
(``toproc`` empty), ``runner.stack`` (a batch id with its task ids),
``runner.wait_device`` (both batches in flight), ``runner.launch`` (the
upload and the step's dispatch), ``runner.wait_download`` and
``runner.copy_out`` (the rows out of the pinned slot), ``runner.wait_save``
(``tosave`` full; a task id) and ``runner.proc`` (a batch from its stacking
to its rows' delivery).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils import profiling
from ..utils.profiling import record, set_role, span
from .image import decode_image, encode_image

QUEUE_DEPTH = 8  # reference uses 8-deep task queues (main.cpp:259)
IN_FLIGHT = 2  # batches a session has between dispatch and download
_BATCH_IDS = itertools.count()
STAGE, WAIT = "runner.", "runner.wait_"


class StageMetrics:
    """Per-stage counters + wall time (the reference has no observability at
    all, SURVEY.md §5; production serving needs at least this much), and the
    time the proc stage waited: on the load stage (``toproc`` empty), on the
    device (both batches in flight) and on the save stage (``tosave``
    full).  A view of the runner's spans summed into ``sums``: stage ``x``
    is span ``runner.x`` (tasks counted), wait ``on x`` span
    ``runner.wait_x``."""

    def __init__(self):
        self.sums = profiling.Sums()

    def _by(self, col: int, waits: bool) -> dict:
        snap = self.sums.snapshot()
        if waits:
            return {"on " + k[len(WAIT):]: v[col] for k, v in snap.items()
                    if k.startswith(WAIT)}
        return {k[len(STAGE):]: v[col] for k, v in snap.items()
                if not k.startswith(WAIT)}

    @property
    def counts(self) -> Dict[str, int]:
        return self._by(0, False)

    @property
    def seconds(self) -> Dict[str, float]:
        return self._by(1, False)

    @property
    def waits(self) -> Dict[str, float]:
        return self._by(1, True)

    def add(self, stage: str, seconds: float, n: int = 1):
        t = time.perf_counter()
        record(STAGE + stage, t - seconds, t, into=self.sums, n=n)

    def wait(self, what: str, seconds: float):
        t = time.perf_counter()
        record(WAIT + what.removeprefix("on ").replace(" ", "_"),
               t - seconds, t, into=self.sums)

    def summary(self) -> str:
        counts, seconds, waits = self.counts, self.seconds, self.waits
        parts = []
        for stage in sorted(counts):
            n, s = counts[stage], seconds[stage]
            rate = n / s if s > 0 else float("inf")
            parts.append(f"{stage}: {n} in {s:.2f}s ({rate:.1f}/s)")
        if waits:
            parts.append("proc waited " + ", ".join(
                f"{w} {s:.2f}s" for w, s in sorted(waits.items())))
        return "; ".join(parts)


@dataclass
class Task:
    id: int
    in0_path: str
    in1_path: str
    out_path: str
    timestep: float
    in0: Optional[np.ndarray] = None
    in1: Optional[np.ndarray] = None
    out: Optional[np.ndarray] = None


class _DecodeCache:
    """Tiny LRU so directory mode doesn't decode every frame twice
    (each frame is in1 of one task and in0 of the next)."""

    def __init__(self, maxsize: int = 16):
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.maxsize = maxsize

    def get(self, path: str) -> np.ndarray:
        with self._lock:
            if path in self._d:
                self._d.move_to_end(path)
                return self._d[path]
        img = decode_image(path)
        with self._lock:
            self._d[path] = img
            if len(self._d) > self.maxsize:
                self._d.popitem(last=False)
        return img


@dataclass
class _Slot:
    """Pinned host buffers of one batch in flight: (B,H,W,3) u8 inputs and
    output, and the event recorded after the output's copy from the card."""
    in0: torch.Tensor
    in1: torch.Tensor
    out: torch.Tensor
    done: torch.cuda.Event
    busy: bool = False


class _CudaStaging:
    """The CUDA device path of one session's proc thread: IN_FLIGHT pinned
    slots per batch shape, a side stream for the downloads.  Call
    ``acquire``, ``launch`` and ``fetch`` with the session's device current
    (``torch.cuda.device``); ``release`` after the rows are copied out."""

    def __init__(self, device: torch.device, device_fn: Callable):
        self.device = device
        self.device_fn = device_fn
        self.side = torch.cuda.Stream(device)
        self._slots: Dict[tuple, List[_Slot]] = {}
        self._lock = threading.Lock()

    def acquire(self, shape: tuple) -> _Slot:
        with self._lock:
            slots = self._slots.setdefault(shape, [])
            slot = next((s for s in slots if not s.busy), None)
            if slot is None:
                if len(slots) >= IN_FLIGHT:
                    raise RuntimeError(f"no free pinned slot for {shape}")
                slot = _Slot(*(torch.empty(shape, dtype=torch.uint8,
                                           pin_memory=True)
                               for _ in range(3)), torch.cuda.Event())
                slots.append(slot)
            if not slot.done.query():
                raise RuntimeError("pinned slot reused before its copy from "
                                   "the card completed")
            slot.busy = True
            return slot

    def release(self, slot: _Slot) -> None:
        with self._lock:
            slot.busy = False

    def launch(self, slot: _Slot, ts: np.ndarray) -> None:
        """Upload the slot's inputs on the compute stream, step, and queue
        the output's copy into the slot on the side stream."""
        compute = torch.cuda.current_stream(self.device)
        a = slot.in0.to(self.device, non_blocking=True)
        b = slot.in1.to(self.device, non_blocking=True)
        out = self.device_fn(a, b, ts)
        self.side.wait_stream(compute)
        with torch.cuda.stream(self.side):
            out.record_stream(self.side)
            slot.out.copy_(out, non_blocking=True)
            slot.done.record(self.side)

    @staticmethod
    def fetch(slot: _Slot, n: int, batch_id: int) -> np.ndarray:
        """The first ``n`` output rows, copied out of the slot once its
        download has completed."""
        with span("runner.wait_download", batch_id):
            slot.done.synchronize()
        with span("runner.copy_out", batch_id):
            return slot.out.numpy()[:n].copy()


class PipelineRunner:
    """Drives tasks through load / proc / save stages.

    ``process_batch(in0, in1, timesteps) -> out`` is the device step (one
    per device session); multiple sessions consume the same queue — the
    reference's heterogeneous multi-device work stealing
    (the reference's src/main.cpp:819-866).
    """

    def __init__(
        self,
        process_batches: Sequence[Callable],
        *,
        jobs_load: int = 1,
        jobs_save: int = 2,
        batch_size=1,
        verbose: bool = False,
        on_done: Optional[Callable[[Task], None]] = None,
        device_fns: Optional[Sequence[Optional[Callable]]] = None,
        devices: Optional[Sequence[Optional[torch.device]]] = None,
    ):
        """``device_fns`` (optional, one per session; None where a session
        takes the sync path) are asynchronous variants returning the output
        on the device (``RIFE.process_batch_device``): the proc stage
        dispatches batch k+1 while batch k is still computing/downloading.
        ``devices`` (one per session): where it names a CUDA device, that
        session's batches go through pinned slots and a side stream
        (``_CudaStaging``); elsewhere the output is downloaded with
        ``np.asarray`` on a download thread."""
        self.process_batches = list(process_batches)
        n = len(self.process_batches)
        self.device_fns = list(device_fns) if device_fns else [None] * n
        self.devices = list(devices) if devices else [None] * n
        if len(self.device_fns) != n or len(self.devices) != n:
            raise ValueError("need one device_fn and device per process_batch")
        self.jobs_load = max(1, jobs_load)
        self.jobs_save = max(1, jobs_save)
        # per-device batch sizes (the analog of the reference's per-device
        # proc thread counts, -j l:p0,p1,...:s — main.cpp:548-551)
        if isinstance(batch_size, int):
            batch_size = [batch_size] * n
        if len(batch_size) != n:
            raise ValueError("need one batch size per device session")
        self.batch_sizes = [max(1, b) for b in batch_size]
        self.verbose = verbose
        self.on_done = on_done
        self.toproc: "queue.Queue[Optional[Task]]" = queue.Queue(QUEUE_DEPTH)
        self.tosave: "queue.Queue[Optional[Task]]" = queue.Queue(QUEUE_DEPTH)
        self.errors: List[str] = []
        self._err_lock = threading.Lock()
        self.metrics = StageMetrics()

    def _record_error(self, msg: str):
        with self._err_lock:
            self.errors.append(msg)

    # -- stages --------------------------------------------------------------

    def _load(self, tasks: Sequence[Task]):
        cache = _DecodeCache()

        def decode(task: Task) -> Optional[Task]:
            t0 = time.perf_counter()
            try:
                task.in0 = cache.get(task.in0_path)
                task.in1 = cache.get(task.in1_path)
                if task.in0.shape != task.in1.shape:
                    raise ValueError(
                        f"size mismatch {task.in0.shape} vs {task.in1.shape}"
                    )
                record("runner.load", t0, time.perf_counter(), task.id,
                       into=self.metrics.sums)
                return task
            except Exception as e:  # noqa: BLE001 - stage must not die
                self._record_error(f"decode {task.in0_path}/{task.in1_path}: {e}")
                return None

        with ThreadPoolExecutor(self.jobs_load, initializer=set_role,
                                initargs=("load",)) as pool:
            for done in pool.map(decode, tasks):
                if done is not None:
                    self.toproc.put(done)

    def _proc(self, process_batch: Callable, batch_size: int,
              device_fn: Optional[Callable],
              device: Optional[torch.device]):
        set_role("proc")
        if device is not None and device.type == "cuda" and device_fn:
            # streams and the current device are per thread
            with torch.cuda.device(device), torch.inference_mode():
                self._proc_loop(process_batch, batch_size, device_fn,
                                _CudaStaging(device, device_fn))
        else:
            self._proc_loop(process_batch, batch_size, device_fn, None)

    def _proc_loop(self, process_batch: Callable, batch_size: int,
                   device_fn: Optional[Callable],
                   staging: Optional[_CudaStaging]):
        pending: "OrderedDict[tuple, List[Task]]" = OrderedDict()
        # shapes for which a full batch has already been submitted: partial
        # tail batches of those shapes are padded up to batch_size (padding
        # rows replay the last pair, outputs dropped), so every step of one
        # shape runs at one B.  With several sessions on one queue, which
        # session takes which task is a race, and on the card a frame's
        # bytes depend on the B of its step (cuDNN picks its algorithms by
        # shape): there every partial batch is padded, so the bytes do not
        # depend on the race.
        saw_full: set = set()
        pad_all = len(self.process_batches) > 1
        # async path: at most IN_FLIGHT batches in flight (dispatch k+1
        # while k computes/downloads), downloads drain in order on one thread
        inflight = threading.BoundedSemaphore(IN_FLIGHT)
        downloads = (ThreadPoolExecutor(1, initializer=set_role,
                                        initargs=("download",))
                     if device_fn else None)
        sums = self.metrics.sums

        def to_save(task):
            with span("runner.wait_save", task.id, into=sums):
                self.tosave.put(task)

        def deliver(batch, outs):
            for t, o in zip(batch, outs):
                t.out = o
                to_save(t)

        def download(batch, bid, dev_out, t0):
            try:
                if staging is not None:
                    try:
                        outs = staging.fetch(dev_out, len(batch), bid)
                    finally:
                        staging.release(dev_out)
                else:
                    with span("runner.copy_out", bid):
                        outs = np.asarray(dev_out)
                deliver(batch, outs)
                record("runner.proc", t0, time.perf_counter(), bid,
                       into=sums, n=len(batch))
            except Exception as e:  # noqa: BLE001
                self._record_error(f"download batch: {e}")
            finally:
                inflight.release()

        def stack(batch, bid, in0, in1):
            """Stack the batch's frames into ``in0``/``in1`` (B rows); rows
            past the batch replay its last pair."""
            n = len(batch)
            with span("runner.stack", (bid, tuple(t.id for t in batch))):
                for dst, key in ((in0, "in0"), (in1, "in1")):
                    np.stack([getattr(t, key) for t in batch], out=dst[:n])
                    dst[n:] = dst[n - 1]

        def flush(shape_key):
            batch = pending.pop(shape_key, None)
            if not batch:
                return
            try:
                t0 = time.perf_counter()
                bid = next(_BATCH_IDS)
                ts = np.asarray([t.timestep for t in batch], np.float32)
                bp = len(batch)
                if len(batch) >= batch_size:
                    saw_full.add(shape_key)
                elif shape_key in saw_full or pad_all:
                    bp = batch_size
                    ts = np.concatenate([ts, np.repeat(ts[-1:], bp - len(ts))])
                shape = (bp, *shape_key)
                if downloads is None:
                    in0, in1 = np.empty(shape, np.uint8), np.empty(shape, np.uint8)
                    stack(batch, bid, in0, in1)
                    with span("runner.launch", bid):
                        outs = process_batch(in0, in1, ts)
                    record("runner.proc", t0, time.perf_counter(), bid,
                           into=sums, n=len(batch))
                    deliver(batch, outs)
                    return
                with span("runner.wait_device", bid, into=sums):
                    inflight.acquire()
                slot = None
                try:
                    if staging is None:
                        in0 = np.empty(shape, np.uint8)
                        in1 = np.empty(shape, np.uint8)
                        stack(batch, bid, in0, in1)
                        with span("runner.launch", bid):
                            dev_out = device_fn(in0, in1, ts)
                    else:
                        slot = dev_out = staging.acquire(shape)
                        stack(batch, bid, slot.in0.numpy(), slot.in1.numpy())
                        with span("runner.launch", bid):
                            staging.launch(slot, ts)
                except Exception:
                    if slot is not None:
                        staging.release(slot)
                    inflight.release()
                    raise
                downloads.submit(download, batch, bid, dev_out, t0)
            except Exception as e:  # noqa: BLE001
                self._record_error(f"process batch: {e}")

        while True:
            with span("runner.wait_load", into=sums):
                task = self.toproc.get()
            if task is None:
                for key in list(pending.keys()):
                    flush(key)
                if downloads is not None:
                    downloads.shutdown(wait=True)
                self.tosave.put(None)
                return
            # t==0/1 short-circuit, as the reference engine does
            # (rife.cpp:395-405) — no device work at all
            if task.timestep == 0.0:
                task.out = task.in0
                to_save(task)
                continue
            if task.timestep == 1.0:
                task.out = task.in1
                to_save(task)
                continue
            key = task.in0.shape
            pending.setdefault(key, []).append(task)
            if len(pending[key]) >= batch_size:
                flush(key)

    def _save(self):
        # Bound in-flight encodes so the depth-8 ``tosave`` queue actually
        # exerts backpressure on proc: without this the executor's internal
        # queue is unbounded and decoded+rendered frames pile up in memory
        # whenever encode is slower than proc.  The reference's bounded
        # queues are its memory contract (main.cpp:259).
        inflight = threading.BoundedSemaphore(2 * self.jobs_save)

        def encode(task: Task):
            t0 = time.perf_counter()
            try:
                encode_image(task.out_path, task.out)
                record("runner.save", t0, time.perf_counter(), task.id,
                       into=self.metrics.sums)
                if self.verbose:
                    print(
                        f"{task.in0_path} {task.in1_path} {task.timestep} "
                        f"-> {task.out_path} done"
                    )
                if self.on_done is not None:
                    self.on_done(task)
            except Exception as e:  # noqa: BLE001
                self._record_error(f"encode {task.out_path}: {e}")
            finally:
                task.in0 = task.in1 = task.out = None  # free pixels
                inflight.release()

        set_role("save")
        n_procs = len(self.process_batches)
        finished_procs = 0
        with ThreadPoolExecutor(self.jobs_save, initializer=set_role,
                                initargs=("save",)) as pool:
            while finished_procs < n_procs:
                task = self.tosave.get()
                if task is None:
                    finished_procs += 1
                    continue
                inflight.acquire()  # blocks -> tosave fills -> proc blocks
                pool.submit(encode, task)

    # -- run ---------------------------------------------------------------------

    def run(self, tasks: Sequence[Task]) -> List[str]:
        """Run all tasks; returns accumulated stage errors (empty = clean)."""
        with span("runner.run"):
            self._run(tasks)
        if self.verbose:
            print(f"pipeline: {self.metrics.summary()}")
        return self.errors

    def _run(self, tasks: Sequence[Task]) -> None:
        loader = threading.Thread(target=self._load, args=(tasks,))
        procs = [
            threading.Thread(target=self._proc, args=(fn, bs, dfn, dev))
            for fn, bs, dfn, dev in zip(self.process_batches,
                                        self.batch_sizes, self.device_fns,
                                        self.devices)
        ]
        saver = threading.Thread(target=self._save)
        loader.start()
        for p in procs:
            p.start()
        saver.start()
        loader.join()
        for _ in procs:
            self.toproc.put(None)  # poison pills (reference id==-233)
        for p in procs:
            p.join()
        saver.join()
