"""Image decode/encode for the pipeline runtime (a copy of
``rife_tpu/io/image.py``).

Replaces the reference's vendored stb_image/stb_image_write/libwebp wrappers
(the reference's src/main.cpp:123-229).  Decoding always yields 3-channel
RGB u8 (the reference forces 3 channels, main.cpp:167-168); encoding matches
the reference's choices: PNG default, WebP lossless (webp_image.h:63-78),
JPEG quality 100 (main.cpp:215).

Codec order as in ``rife_tpu``: the native library (``io/native.py``, built
by ``native/codecs.py``) first, then PIL.  PIL is imported where it is used,
so the module imports on a host that has only the native codecs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

SUPPORTED_EXTS = (".png", ".jpg", ".jpeg", ".webp")

_native = None


def _native_lib():
    """The C codec library (built on first use); None if unavailable."""
    global _native
    if _native is None:
        try:
            from . import native as native_mod

            _native = native_mod if native_mod.available() else False
        except Exception:  # noqa: BLE001 - toolchain may be absent
            _native = False
    return _native or None


def codec_name() -> str:
    """The codec ``decode_image``/``encode_image`` use first: "native"
    (libpng/libjpeg/libwebp), else "PIL", else "none"."""
    if _native_lib() is not None:
        return "native"
    try:
        import PIL  # noqa: F401
    except ImportError:
        return "none"
    return "PIL"


def _decode_pil(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _encode_pil(path, rgb: np.ndarray, ext: str) -> None:
    from PIL import Image

    im = Image.fromarray(rgb, mode="RGB")
    if ext == ".png":
        im.save(path, format="PNG")
    elif ext == ".webp":
        im.save(path, format="WEBP", lossless=True)  # reference uses lossless
    else:
        im.save(path, format="JPEG", quality=100)    # reference uses q100


def decode_image(path: Union[str, Path]) -> np.ndarray:
    """Decode to (H,W,3) uint8 RGB (native codecs, PIL fallback)."""
    lib = _native_lib()
    if lib is not None:
        try:
            return lib.decode_image(path)
        except ValueError:
            pass  # unknown container magic etc. -> PIL
    return _decode_pil(path)


def encode_image(path: Union[str, Path], rgb: np.ndarray) -> None:
    """Encode (H,W,3) uint8 RGB by file extension (png/webp/jpg)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H,W,3) uint8, got {rgb.shape} {rgb.dtype}")
    ext = Path(path).suffix.lower()
    if ext not in SUPPORTED_EXTS:
        raise ValueError(f"unsupported output extension {ext!r}")
    lib = _native_lib()
    if lib is not None:
        lib.encode_image(path, rgb)
        return
    _encode_pil(path, rgb, ext)
