"""Command-line interface of the PyTorch port — flag-compatible with the
reference binary and with ``rife_tpu.cli``.

Usage mirrors the reference's src/main.cpp:102-121:

    python -m rife_tpu_torch.cli -0 in0.png -1 in1.png -o out.png [options]
    python -m rife_tpu_torch.cli -i indir -o outdir [options]

  -h                   show help
  -v                   verbose output
  -0 input0-path       input image0 (jpg/png/webp)
  -1 input1-path       input image1
  -i input-path        input image directory
  -o output-path       output image path or directory
  -n num-frame         target frame count (default N*2)
  -s time-step         time step 0~1 (default 0.5)
  -m model-path        model dir or zoo name (default rife-v2.3)
  -g device-id         CUDA device to use (default 0; -1 = cpu); comma list
                       for independent per-device sessions over one queue;
                       'all' = one session batch-sharded over every card
  -j load:proc:save    thread counts (default 1:2:2); proc = device batch size here,
                       comma list per device (with -g all: per card)
  -x                   spatial TTA
  -z                   temporal TTA
  -u                   UHD mode
  -f pattern-format    output name pattern (%08d.png default)

Job planning (directory mode) reproduces main.cpp:697-766 exactly:
``fx = i * count/numframe``, ``sx = floor(fx)`` with edge clamping, output
names start at 1 (ffmpeg convention).

Sessions run on the card, bf16 (``rife_tpu.cli``'s TPU policy, with the card
in the TPU's place); ``-g -1`` runs f32 on the CPU.  Without a card only
``-g -1`` runs: nothing moves to the CPU on its own.  Multi-host directory
mode partitions the tasks by ``RIFE_TORCH_RANK`` / ``RIFE_TORCH_WORLD``.
"""

from __future__ import annotations

import getopt
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional


def parse_int_list(text: str) -> List[int]:
    return [int(t) for t in text.split(",") if t != ""]


def mesh_devices():
    """The devices ``-g all`` shards over: every visible card."""
    import torch

    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_batch(jobs_proc: List[int], n_devices: int) -> int:
    """The step batch of ``-g all``: the ``-j`` proc value (default 2) is
    the per-card batch, as in ``rife_tpu.cli``."""
    return (jobs_proc[0] if jobs_proc else 2) * n_devices


def parse_jobs(text: str):
    """'load:proc[,proc...]:save' -> (load, [proc...], save)."""
    parts = text.split(":")
    if len(parts) != 3:
        raise ValueError(f"invalid -j argument {text!r}")
    return int(parts[0]), parse_int_list(parts[1]), int(parts[2])


def guess_format(outputpath: str, pattern_format: str):
    """Reference format guessing (main.cpp:600-636)."""
    pattern = Path(pattern_format).stem
    fmt = Path(pattern_format).suffix.lstrip(".")
    if not fmt:
        pattern, fmt = "%08d", pattern_format
    if not pattern:
        pattern = "%08d"
    if not Path(outputpath).is_dir():
        ext = Path(outputpath).suffix.lstrip(".").lower()
        if ext == "jpeg":
            ext = "jpg"
        if ext not in ("png", "webp", "jpg"):
            raise ValueError("invalid outputpath extension type")
        fmt = ext
    if fmt not in ("png", "webp", "jpg"):
        raise ValueError("invalid format argument")
    return pattern, fmt


def plan_directory_jobs(inputpath: str, outputpath: str, numframe: int,
                        pattern: str, fmt: str):
    """(in0, in1, out, timestep) per output frame (main.cpp:697-766)."""
    names = sorted(
        f for f in os.listdir(inputpath)
        if (Path(inputpath) / f).is_file() and not f.startswith(".")
    )
    count = len(names)
    if count < 2:
        raise ValueError(f"input directory needs >=2 frames, found {count}")
    if numframe == 0:
        numframe = count * 2
    jobs = []
    scale = count / numframe
    for i in range(numframe):
        fx = i * scale
        sx = int(math.floor(fx))
        fx -= sx
        if sx < 0:
            sx, fx = 0, 0.0
        if sx >= count - 1:
            sx, fx = count - 2, 1.0
        out_name = (pattern % (i + 1)) + "." + fmt
        jobs.append((
            os.path.join(inputpath, names[sx]),
            os.path.join(inputpath, names[sx + 1]),
            os.path.join(outputpath, out_name),
            float(fx),
        ))
    return jobs


@dataclass
class Args:
    input0: str = ""
    input1: str = ""
    inputpath: str = ""
    outputpath: str = ""
    numframe: int = 0
    timestep: float = 0.5
    model: str = "rife-v2.3"
    deviceids: str = ""
    jobs: str = "1:2:2"
    pattern_format: str = "%08d.png"
    tta_mode: bool = False
    tta_temporal: bool = False
    uhd_mode: bool = False
    verbose: bool = False
    show_help: bool = False


OPTSTRING = "0:1:i:o:n:s:m:g:j:f:vxzuh"  # identical to main.cpp:520


def parse_args(argv: List[str]) -> Args:
    """getopt-style parsing, as the reference does — option values may start
    with '-' (e.g. ``-g -1`` selects the CPU device)."""
    a = Args()
    opts, _ = getopt.getopt(argv, OPTSTRING)
    for opt, val in opts:
        if opt == "-0":
            a.input0 = val
        elif opt == "-1":
            a.input1 = val
        elif opt == "-i":
            a.inputpath = val
        elif opt == "-o":
            a.outputpath = val
        elif opt == "-n":
            a.numframe = int(val)
        elif opt == "-s":
            a.timestep = float(val)
        elif opt == "-m":
            a.model = val
        elif opt == "-g":
            a.deviceids = val
        elif opt == "-j":
            a.jobs = val
        elif opt == "-f":
            a.pattern_format = val
        elif opt == "-v":
            a.verbose = True
        elif opt == "-x":
            a.tta_mode = True
        elif opt == "-z":
            a.tta_temporal = True
        elif opt == "-u":
            a.uhd_mode = True
        elif opt == "-h":
            a.show_help = True
    return a


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    try:
        args = parse_args(argv)
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        print(__doc__, file=sys.stderr)
        return 255
    if args.show_help:
        print(__doc__, file=sys.stderr)
        return 0

    # --- validation (mirrors main.cpp:575-689) ---
    if ((not args.input0 or not args.input1) and not args.inputpath) or not args.outputpath:
        print(__doc__, file=sys.stderr)
        return 255
    if not args.inputpath and not (0.0 < args.timestep < 1.0):
        print("invalid timestep argument, must be 0~1", file=sys.stderr)
        return 255
    if args.inputpath and args.numframe < 0:
        print("invalid numframe argument, must not be negative", file=sys.stderr)
        return 255
    try:
        jobs_load, jobs_proc, jobs_save = parse_jobs(args.jobs)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 255
    if jobs_load < 1 or jobs_save < 1 or any(j < 1 for j in jobs_proc):
        print("invalid thread count argument", file=sys.stderr)
        return 255

    from .models.zoo import sniff_family  # deferred: fast help/validation
    try:
        family = sniff_family(args.model)
    except ValueError:
        print("unknown model dir type", file=sys.stderr)
        return 255
    if family != "v4" and (args.numframe != 0 or args.timestep != 0.5):
        print("only rife-v4 model support custom numframe and timestep",
              file=sys.stderr)
        return 255

    try:
        pattern, fmt = guess_format(args.outputpath, args.pattern_format)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 255

    # --- job list ---
    if args.inputpath and Path(args.inputpath).is_dir() and Path(args.outputpath).is_dir():
        jobs = plan_directory_jobs(
            args.inputpath, args.outputpath, args.numframe, pattern, fmt
        )
    elif (not args.inputpath and args.input0 and args.input1
          and Path(args.outputpath).is_dir() and args.numframe > 0):
        # extension beyond the reference CLI: N intermediate frames from one
        # pair at evenly spaced timesteps (v4-only, enforced above)
        jobs = [
            (args.input0, args.input1,
             str(Path(args.outputpath) / ((pattern % (i + 1)) + "." + fmt)),
             (i + 1) / (args.numframe + 1))
            for i in range(args.numframe)
        ]
    elif (not args.inputpath and not Path(args.input0).is_dir()
          and not Path(args.input1).is_dir() and not Path(args.outputpath).is_dir()):
        jobs = [(args.input0, args.input1, args.outputpath, args.timestep)]
    else:
        print("input0path, input1path and outputpath must be file at the same time\n"
              "inputpath and outputpath must be directory at the same time",
              file=sys.stderr)
        return 255

    # --- devices & sessions ---
    import torch

    from .engine.session import RIFE
    from .io.runner import PipelineRunner, Task

    mesh_mode = args.deviceids.strip().lower() == "all"
    try:
        device_ids = (
            [] if mesh_mode else
            parse_int_list(args.deviceids) if args.deviceids else [0]
        )
    except ValueError:
        print("invalid device", file=sys.stderr)
        return 255
    n_sessions = 1 if mesh_mode else len(device_ids)
    if len(jobs_proc) not in (0, 1, n_sessions):
        print("invalid jobs_proc thread count argument", file=sys.stderr)
        return 255
    if len(jobs_proc) == 1 and not mesh_mode:
        jobs_proc = jobs_proc * len(device_ids)

    if (mesh_mode or any(did != -1 for did in device_ids)) and \
            not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False; pass "
              "-g -1 to run on the CPU", file=sys.stderr)
        return 255
    devices = []
    for did in device_ids:
        if did == -1:
            devices.append(torch.device("cpu"))
        elif 0 <= did < torch.cuda.device_count():
            devices.append(torch.device("cuda", did))
        else:
            print("invalid device", file=sys.stderr)
            return 255

    def make_session(device):
        # the session's default dtype: bf16 on the card, f32 on the CPU
        return RIFE(args.model, device=device, tta_mode=args.tta_mode,
                    tta_temporal_mode=args.tta_temporal,
                    uhd_mode=args.uhd_mode)

    t0 = time.perf_counter()
    if mesh_mode:
        # one session, the frame-pair batch sharded over every card
        from .parallel.sharding import ShardedRIFE, make_mesh

        mesh = make_mesh(mesh_devices())
        sessions = [ShardedRIFE(make_session(mesh.devices[0][0]), mesh)]
        jobs_proc = [mesh_batch(jobs_proc, len(mesh.devices))]
    else:
        sessions = [make_session(device) for device in devices]
    if args.verbose:
        print(f"sessions: {len(sessions)} built in "
              f"{time.perf_counter() - t0:.2f}s")

    if any(s.model.any_synthetic for s in sessions):
        print(
            f"note: model {args.model!r} has missing .bin weight files in this "
            "mount; using deterministic synthetic weights",
            file=sys.stderr,
        )

    tasks = [
        Task(id=i, in0_path=a, in1_path=b, out_path=o, timestep=t)
        for i, (a, b, o, t) in enumerate(jobs)
    ]

    # multi-host directory mode: static task partitioning over hosts
    # (SURVEY.md §5 — outputs are independently named files, so hosts never
    # communicate; each rank writes a disjoint subset of the output set).
    # Enabled via RIFE_TORCH_RANK / RIFE_TORCH_WORLD, e.g. under mpirun/slurm.
    try:
        rank = int(os.environ.get("RIFE_TORCH_RANK", "0"))
        world = int(os.environ.get("RIFE_TORCH_WORLD", "1"))
    except ValueError:
        print("invalid RIFE_TORCH_RANK/RIFE_TORCH_WORLD", file=sys.stderr)
        return 255
    if world > 1:
        if not (0 <= rank < world):
            print("RIFE_TORCH_RANK must be in [0, RIFE_TORCH_WORLD)",
                  file=sys.stderr)
            return 255
        from .parallel.sharding import partition_tasks

        tasks = partition_tasks(tasks, rank, world)
        if args.verbose:
            print(f"rank {rank}/{world}: {len(tasks)} of {len(jobs)} tasks",
                  file=sys.stderr)
    runner = PipelineRunner(
        [s.process_batch for s in sessions],
        jobs_load=jobs_load,
        jobs_save=jobs_save,
        # -j proc counts become per-device batch sizes (main.cpp:548-551)
        batch_size=jobs_proc if jobs_proc else [2] * len(sessions),
        verbose=args.verbose,
        # sessions on the card take the pinned, side-stream path; a CPU
        # session the sync path
        device_fns=[s.process_batch_device if s.device.type == "cuda"
                    else None for s in sessions],
        devices=[s.device for s in sessions],
    )
    errors = runner.run(tasks)
    for e in errors:
        print(e, file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
