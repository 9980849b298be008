"""Build + load the CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` is compiled on first use by its own ``nvcc -c``, all of
them started together, into ``rife_tpu_torch/_build/obj/``; the objects are
linked into ``rife_tpu_torch/_build/librife_kernels.so`` (rebuilt when a
source is newer) and loaded with ctypes.  The C functions take ``c_void_p``
pointers and stream and return ``cudaGetLastError()``.  The build uses only
the sources in this package.  A failed build raises; nothing falls back to
the plain PyTorch twins.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
OBJ_DIR = BUILD_DIR / "obj"
LIB_PATH = BUILD_DIR / "librife_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class BuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise BuildError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _run_all(cmds):
    """Run the commands in parallel; returns their (returncode, stderr)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    results = []
    for proc in procs:
        _, err = proc.communicate()
        results.append((proc.returncode, err))
    return results


def compile_library() -> str:
    """Compile every ``csrc/*.cu`` (one ``nvcc -c`` each, in parallel) and
    link ``LIB_PATH``; returns the compiler's diagnostics (``-Xptxas -v``:
    registers, shared memory, spills)."""
    nvcc = _nvcc()
    OBJ_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    sources = _sources()
    objs = [OBJ_DIR / f"{src.stem}.{tag}.o" for src in sources]
    cmds = [[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    log = []
    try:
        for cmd, (rc, err) in zip(cmds, _run_all(cmds)):
            if rc != 0:
                raise BuildError(f"nvcc failed ({' '.join(cmd)}):\n{err}")
            log.append(err)
        tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"nvcc link failed ({' '.join(cmd)}):\n"
                             f"{proc.stderr}")
        tmp.replace(LIB_PATH)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(log)


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built
               for s in [*_sources(), *SRC_DIR.glob("*.h")])


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name in ("rife_warp_pair", "rife_warp_render"):
        fn = getattr(lib, name)
        # 6 tensor pointers, batch, height, width, bf16 flag, tile width and
        # height, stream
        fn.argtypes = [vp] * 6 + [i] * 6 + [vp]
        fn.restype = i
    # 6 tensor pointers, batch, height, width, bf16 flag, stream
    lib.rife_warp_ds4_pair.argtypes = [vp] * 6 + [i] * 4 + [vp]
    lib.rife_warp_ds4_pair.restype = i
    # image, flow, out; batch, height, width, bf16 flag, stream
    lib.rife_warp_ds2.argtypes = [vp] * 3 + [i, i, i, i, vp]
    lib.rife_warp_ds2.restype = i
    # image, flow/positions, out; batch, C, H, W, Ho, Wo, abs_pos, u8, bf16,
    # tile width and height, channel group, stream
    lib.rife_warp_single.argtypes = [vp] * 3 + [i] * 12 + [vp]
    lib.rife_warp_single.restype = i
    # whole source, the shard's flow rows, out; batch, C, H, W, rows, row0,
    # u8, ds4, bf16, channel group, stream
    lib.rife_warp_spatial.argtypes = [vp] * 3 + [i] * 10 + [vp]
    lib.rife_warp_spatial.restype = i
    # f32: 4 part pointers, 4 channel counts, packed weight, its padded
    # Cin, bias, slope, out; batch, H, W, Cout, stride, activation, alpha,
    # deconv flag, stream
    lib.rife_conv3x3.argtypes = ([vp] * 4 + [i] * 4 + [vp, i] + [vp] * 3
                                 + [i] * 6 + [ctypes.c_float, i, vp])
    lib.rife_conv3x3.restype = i
    # bf16: 4 part pointers, 4 channel counts, packed weight, its padded
    # Cin, bias, slope, out; batch, H, W, Cout, stride, activation, alpha,
    # stream
    lib.rife_conv3x3_tc.argtypes = ([vp] * 4 + [i] * 4 + [vp, i] + [vp] * 3
                                    + [i] * 6 + [ctypes.c_float, vp])
    lib.rife_conv3x3_tc.restype = i
    # B4's conv form: x, Cin, packed weight, its padded Cin, bias, slope,
    # out; batch, H, W, Cout, stride, activation, alpha, tile rows, stages,
    # TMA input and output flags, stream
    lib.rife_conv3x3_ps.argtypes = ([vp, i, vp, i] + [vp] * 3 + [i] * 6
                                    + [ctypes.c_float] + [i] * 4 + [vp])
    lib.rife_conv3x3_ps.restype = i
    # x, Cin, packed 4-tap weight, its padded Cin, bias, slope, out; batch,
    # H, W, Cout, activation, alpha, PixelShuffle factor, XLA order, stream
    lib.rife_deconv4x4.argtypes = ([vp, i, vp, i] + [vp] * 3 + [i] * 5
                                   + [ctypes.c_float, i, i, vp])
    lib.rife_deconv4x4.restype = i
    # y (in place), bf16 flag, bias, slope; planes, channels, plane size,
    # activation, alpha, stream
    lib.rife_bias_act.argtypes = [vp, i, vp, vp, i, i, ctypes.c_longlong, i,
                                  ctypes.c_float, vp]
    lib.rife_bias_act.restype = i
    lib.rife_error_string.argtypes = [i]
    lib.rife_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """Build (once per source change) and return the bound library."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                compile_library()
            _lib = _bind(ctypes.CDLL(str(LIB_PATH)))
        return _lib


def error_string(code: int) -> str:
    return load().rife_error_string(code).decode()
