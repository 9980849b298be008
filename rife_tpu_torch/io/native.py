"""numpy-facing wrappers over the native codec library (a copy of
``rife_tpu/io/native.py``; the library is built by ``native/codecs.py``).

Decode order matches the reference (webp probe first, then png/jpeg —
the reference's src/main.cpp:156-170, here by extension+magic); all paths
release the GIL inside the C calls so the load/save thread pools actually
overlap with device compute.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Union

import numpy as np

from ..native.codecs import NativeUnavailable, load

_MAGIC_PNG = b"\x89PNG"
_MAGIC_JPEG = b"\xff\xd8"
_MAGIC_WEBP_RIFF = b"RIFF"


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def _as_u8p(data: bytes):
    return ctypes.cast(
        ctypes.create_string_buffer(data, len(data)),
        ctypes.POINTER(ctypes.c_ubyte),
    )


def decode_image(path: Union[str, Path]) -> np.ndarray:
    lib = load()
    data = Path(path).read_bytes()
    out = ctypes.POINTER(ctypes.c_ubyte)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if data[:4] == _MAGIC_WEBP_RIFF and data[8:12] == b"WEBP":
        fn = lib.rife_decode_webp
    elif data[:4] == _MAGIC_PNG:
        fn = lib.rife_decode_png
    elif data[:2] == _MAGIC_JPEG:
        fn = lib.rife_decode_jpeg
    else:
        raise ValueError(f"{path}: unrecognised image format")
    rc = fn(_as_u8p(data), len(data), ctypes.byref(out), ctypes.byref(w),
            ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"{path}: native decode failed ({rc})")
    try:
        n = w.value * h.value * 3
        arr = np.ctypeslib.as_array(out, shape=(n,)).reshape(h.value, w.value, 3)
        return arr.copy()
    finally:
        lib.rife_free(out)


def encode_image(path: Union[str, Path], rgb: np.ndarray) -> None:
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H,W,3) uint8, got {rgb.shape} {rgb.dtype}")
    lib = load()
    rgb = np.ascontiguousarray(rgb)
    h, w = rgb.shape[:2]
    src = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
    out = ctypes.POINTER(ctypes.c_ubyte)()
    size = ctypes.c_size_t()
    ext = Path(path).suffix.lower()
    if ext == ".png":
        rc = lib.rife_encode_png(src, w, h, ctypes.byref(out), ctypes.byref(size))
    elif ext == ".webp":
        rc = lib.rife_encode_webp(src, w, h, ctypes.byref(out), ctypes.byref(size))
    elif ext in (".jpg", ".jpeg"):
        rc = lib.rife_encode_jpeg(
            src, w, h, 100, ctypes.byref(out), ctypes.byref(size)
        )
    else:
        raise ValueError(f"unsupported output extension {ext!r}")
    if rc != 0:
        raise ValueError(f"{path}: native encode failed ({rc})")
    try:
        data = ctypes.string_at(out, size.value)
    finally:
        lib.rife_free(out)
    Path(path).write_bytes(data)
