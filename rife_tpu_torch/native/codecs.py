"""Build + load the native image codec library (g++ -> ctypes).

A copy of ``rife_tpu/native/build.py`` (the port imports nothing of
``rife_tpu``): ``rife_io.cpp`` over the system libpng, libjpeg and libwebp,
compiled on first use into ``rife_tpu_torch/_build/librife_io.so`` and
cached.  Callers catch ``NativeUnavailable`` when the compiler or the codec
headers are missing (``io/image.py`` then decodes and encodes with PIL).

This build is apart from ``native/build.py``, the CUDA kernels' build: its
own source, library file and lock, so a failed codec build never touches
the kernel library, nor the reverse.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "rife_io.cpp"
_BUILD_DIR = _HERE.parent / "_build"
_LIB = _BUILD_DIR / "librife_io.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed: Optional[str] = None


class NativeUnavailable(RuntimeError):
    pass


def _compile() -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the library, then rename: processes that build at once
    # never load a half-written file
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O2", "-fPIC", "-shared", "-std=c++17",
        str(_SRC), "-o", str(tmp),
        "-lpng", "-ljpeg", "-lwebp",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++
        raise NativeUnavailable(f"native build failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"native build failed:\n{proc.stderr}")
    tmp.replace(_LIB)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    u8pp = ctypes.POINTER(u8p)
    intp = ctypes.POINTER(ctypes.c_int)
    szp = ctypes.POINTER(ctypes.c_size_t)
    for name in ("rife_decode_png", "rife_decode_jpeg", "rife_decode_webp"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, ctypes.c_size_t, u8pp, intp, intp]
        fn.restype = ctypes.c_int
    lib.rife_encode_png.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8pp, szp]
    lib.rife_encode_png.restype = ctypes.c_int
    lib.rife_encode_jpeg.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8pp, szp
    ]
    lib.rife_encode_jpeg.restype = ctypes.c_int
    lib.rife_encode_webp.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8pp, szp]
    lib.rife_encode_webp.restype = ctypes.c_int
    lib.rife_free.argtypes = [ctypes.c_void_p]
    lib.rife_free.restype = None
    return lib


def load() -> ctypes.CDLL:
    """Build (once) and return the bound library; raises NativeUnavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None:
            return _lib
        if _failed is not None:
            raise NativeUnavailable(_failed)
        try:
            if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
                _compile()
            _lib = _bind(ctypes.CDLL(str(_LIB)))
            return _lib
        except (OSError, NativeUnavailable) as e:
            _failed = str(e)
            raise NativeUnavailable(_failed) from e
