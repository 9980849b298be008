"""Multi-device execution (port of ``rife_tpu/parallel/sharding.py``):
device meshes, ``ShardedRIFE`` (batch and height sharding, ``-g all``) and
the static task partitioning of multi-host directory mode.

A mesh is an (n_data, n_spatial) grid of ``torch.device`` with its axis
names.  ``ShardedRIFE`` runs any port session over one:

* **batch sharding** (``batch_axis``): each data shard runs the session's
  own pipeline on its device for its rows of the batch, with no traffic
  between devices, as ``rife_tpu``'s ``shard_map`` of the per-device step
  does.  A partial batch is padded to a multiple of the data shards by
  replaying the last pair.  A shard's rows equal those of the session run
  at the shard's batch on the same device, bit for bit.
* **height sharding** (``height_axis``): each data shard's nets run through
  ``graph/spatial.py``'s ``SpatialExecutor`` over its row of the mesh (the
  halo exchanges and the warps' all-gather that GSPMD and
  ``jax_ops.warp_spatial`` do for ``rife_tpu``).

Each distinct device holds one prepared copy of the session's weights;
repeated devices share it.  A mesh may name one card several times (every
sharded path then runs on that card) or the CPU (which takes the kernels'
plain twins).  The data shards on distinct devices are driven from one host
thread per device, so that eager launch work on one card does not hold up
another; shards on one device run in turn.  A height-sharded row is driven
from its data shard's thread.  Outputs are gathered on the mesh's first
device.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine import plan
from ..graph.spatial import SpatialExecutor
from ..ops.torch_ops import weights_on


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _visible_cards() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False; list the devices of the mesh explicitly")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """An (n_data, n_spatial) grid of devices and its two axis names."""

    def __init__(self, devices: Sequence[Sequence], axis_names=("data",
                                                                 "spatial")):
        self.devices = [[_canonical(d) for d in row] for row in devices]
        if not self.devices or len({len(r) for r in self.devices}) != 1 \
                or not self.devices[0]:
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names,
                        (len(self.devices), len(self.devices[0]))))

    def flat(self) -> List[torch.device]:
        return [d for row in self.devices for d in row]


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "data") -> Mesh:
    """A one-axis mesh over ``devices`` (default: every visible CUDA card;
    raises without one)."""
    devices = list(devices) if devices is not None else _visible_cards()
    return Mesh([[d] for d in devices], (axis_name, "_"))


def make_mesh_2d(n_data: int, n_spatial: int,
                 devices: Optional[Sequence] = None) -> Mesh:
    """An ``n_data`` x ``n_spatial`` mesh with axes ("data", "spatial")
    over ``devices`` in row-major order (default: every visible card)."""
    devices = list(devices) if devices is not None else _visible_cards()
    if n_data * n_spatial != len(devices):
        raise ValueError(f"mesh {n_data}x{n_spatial} != {len(devices)} "
                         f"devices")
    return Mesh([devices[i * n_spatial:(i + 1) * n_spatial]
                 for i in range(n_data)])


class ShardedRIFE:
    """A ``RIFE`` session run over a ``Mesh``: ``batch_axis`` names the axis
    that cuts the batch (or None), ``height_axis`` the one that cuts the
    frames' height (or None)."""

    def __init__(self, session, mesh: Mesh, *,
                 batch_axis: Optional[str] = "data",
                 height_axis: Optional[str] = None):
        names = mesh.axis_names
        for axis in (batch_axis, height_axis):
            if axis is not None and axis not in names:
                raise ValueError(f"mesh has no axis {axis!r} ({names})")
        if batch_axis is not None and batch_axis == height_axis:
            raise ValueError("batch and height need different mesh axes")
        grid = mesh.devices
        if batch_axis == names[1] or height_axis == names[0]:
            grid = [list(col) for col in zip(*grid)]  # (data, spatial)
        n_data, n_sp = len(grid), len(grid[0])
        if (batch_axis is None and n_data > 1) or (height_axis is None
                                                   and n_sp > 1):
            raise ValueError(f"mesh {n_data}x{n_sp}: an axis of size > 1 "
                             f"shards neither the batch nor the height")
        self.session = session
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.height_axis = height_axis
        self.grid = grid
        self.device = grid[0][0]
        self.weights = {_canonical(session.device): session.weights}
        for d in mesh.flat():
            if d not in self.weights:
                self.weights[d] = weights_on(session.weights, d)
        self.executors = []
        for row in grid:
            if height_axis is None:
                self.executors.append(session.executors)
            else:
                self.executors.append({
                    net: SpatialExecutor(ex, row, {
                        d: self.weights[d][net] for d in row})
                    for net, ex in session.executors.items()})

    @property
    def model(self):
        return self.session.model

    @property
    def n_data(self) -> int:
        return len(self.grid)

    def kernel_sites(self, h: int, w: int) -> Dict[str, int]:
        """Kernel launches of one ``process_batch`` step on (h, w) frames:
        ``engine/plan.py``'s count of one data shard's step, height-sharded
        over the mesh's row when ``height_axis`` is set, times the data
        shards."""
        n_sp = len(self.grid[0]) if self.height_axis is not None else 1
        per = plan.kernel_sites(self.session, h, w, n_spatial=n_sp)
        return {k: v * self.n_data for k, v in per.items()}

    def _shard(self, k, a, b, ts):
        home = self.grid[k][0]
        guard = (torch.cuda.device(home) if home.type == "cuda"
                 else nullcontext())
        with guard:
            out = self.session.forward(
                self.session.frames_on(a, home),
                self.session.frames_on(b, home), ts, self.executors[k],
                self.weights[home])
            return out.to(self.device, non_blocking=True)

    def process_batch_device(self, in0, in1, timesteps) -> torch.Tensor:
        """Run one sharded step and return the (B,H,W,3) u8 result on the
        mesh's first device, without synchronising.  The batch is padded
        to a multiple of the data shards by replaying the last pair; the
        padding rows are dropped."""
        ts = self.session.timesteps_of(in0, in1, timesteps)
        n = in0.shape[0]
        per = -(-n // self.n_data)
        rep = per * self.n_data - n

        def pad(x):
            if not rep:
                return x
            if isinstance(x, torch.Tensor):
                return torch.cat([x, x[-1:].expand(rep, *x.shape[1:])])
            return np.concatenate([x, np.repeat(x[-1:], rep, axis=0)])

        in0, in1, ts = pad(in0), pad(in1), pad(ts)
        jobs = [(k, in0[k * per:(k + 1) * per], in1[k * per:(k + 1) * per],
                 ts[k * per:(k + 1) * per]) for k in range(self.n_data)]
        homes = {}
        for job in jobs:
            homes.setdefault(self.grid[job[0]][0], []).append(job)
        if len(homes) == 1:
            outs = [self._shard(*job) for job in jobs]
        else:
            def drive(group):
                with torch.inference_mode():
                    return [self._shard(*job) for job in group]

            with ThreadPoolExecutor(len(homes)) as pool:
                done = list(pool.map(drive, homes.values()))
            by_k = {job[0]: out for group, outs_g in zip(homes.values(), done)
                    for job, out in zip(group, outs_g)}
            outs = [by_k[k] for k in range(self.n_data)]
        return torch.cat(outs)[:n] if len(outs) > 1 else outs[0][:n]

    def process_batch(self, in0, in1, timesteps) -> np.ndarray:
        """Like ``RIFE.process_batch``, sharded over the mesh."""
        return self.process_batch_device(in0, in1, timesteps).cpu().numpy()


def partition_tasks(tasks: Sequence, rank: int, world: int):
    """Static file-range partitioning for multi-host directory mode
    (SURVEY.md §5: hosts never need to communicate — outputs are
    independently named files)."""
    if world <= 1:
        return list(tasks)
    return [t for i, t in enumerate(tasks) if i % world == rank]
