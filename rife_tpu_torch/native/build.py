"""Build + load the CUDA warp kernels (nvcc -> shared library -> ctypes).

``csrc/*.cu`` is compiled on first use into
``rife_tpu_torch/_build/librife_warp.so`` (rebuilt when a source is newer)
and loaded with ctypes; the C functions take ``c_void_p`` pointers and
stream and return ``cudaGetLastError()``.  The build uses only the sources
in this package.  A failed build raises; nothing falls back to the plain
PyTorch twins.
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
LIB_PATH = BUILD_DIR / "librife_warp.so"
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


def compile_library() -> str:
    """Compile ``csrc/*.cu`` into ``LIB_PATH``; returns the compiler's
    diagnostics (``-Xptxas -v``: registers, shared memory, spills)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    tmp.replace(LIB_PATH)
    return proc.stderr


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _sources())


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name in ("rife_warp_pair", "rife_warp_render", "rife_warp_ds4_pair"):
        fn = getattr(lib, name)
        # 6 tensor pointers, batch, height, width, bf16 flag, stream
        fn.argtypes = [vp] * 6 + [i, i, i, i, vp]
        fn.restype = i
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
