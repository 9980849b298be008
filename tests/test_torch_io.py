"""The port's image I/O (``rife_tpu_torch/io``, ``native/codecs.py``): the
native codecs (a copy of ``rife_tpu``'s ``rife_io.cpp``, built apart from the
CUDA kernels), the PIL fallback, and decode against ``rife_tpu``'s on the
same files.  Cases that need the native build or PIL skip where it is absent
(decided inside the fixtures)."""

import numpy as np
import pytest

from rife_tpu_torch.io import image
from rife_tpu_torch.io import native
from rife_tpu_torch.native import build, codecs

RNG = np.random.default_rng(5)


@pytest.fixture
def rgb():
    return RNG.integers(0, 256, (21, 33, 3)).astype(np.uint8)


@pytest.fixture
def smooth():
    gy, gx = np.mgrid[0:32, 0:48]
    return np.stack(
        [(gy * 3) % 256, (gx * 2) % 256, ((gy + gx) * 2) % 256], -1
    ).astype(np.uint8)


@pytest.fixture
def native_codecs():
    if not native.available():
        pytest.skip("native codec toolchain unavailable (g++ or the "
                    "libpng/libjpeg/libwebp headers)")
    return native


@pytest.fixture
def pil_only(monkeypatch):
    """``io/image.py`` with the native library marked unavailable: PIL."""
    pytest.importorskip("PIL")
    monkeypatch.setattr(image, "_native", False)
    return image


@pytest.mark.parametrize("ext", ["png", "webp"])
def test_native_lossless_roundtrip(tmp_path, rgb, ext, native_codecs):
    p = tmp_path / f"x.{ext}"
    native_codecs.encode_image(p, rgb)
    np.testing.assert_array_equal(native_codecs.decode_image(p), rgb)


@pytest.mark.parametrize("ext", ["png", "webp"])
def test_pil_lossless_roundtrip(tmp_path, rgb, ext, pil_only):
    p = tmp_path / f"x.{ext}"
    pil_only.encode_image(p, rgb)
    np.testing.assert_array_equal(pil_only.decode_image(p), rgb)


def test_native_jpeg_q100_close(tmp_path, smooth, native_codecs):
    p = tmp_path / "x.jpg"
    native_codecs.encode_image(p, smooth)
    back = native_codecs.decode_image(p)
    assert back.shape == smooth.shape
    assert np.abs(back.astype(int) - smooth.astype(int)).mean() < 8


def test_pil_jpeg_q100_close(tmp_path, smooth, pil_only):
    p = tmp_path / "x.jpeg"
    pil_only.encode_image(p, smooth)
    back = pil_only.decode_image(p)
    assert back.shape == smooth.shape
    assert np.abs(back.astype(int) - smooth.astype(int)).mean() < 8


def test_native_decode_magic_probing(tmp_path, rgb, native_codecs):
    """Decode dispatches on container magic, not extension."""
    native_codecs.encode_image(tmp_path / "real.webp", rgb)
    p = tmp_path / "lying_extension.png"
    p.write_bytes((tmp_path / "real.webp").read_bytes())
    np.testing.assert_array_equal(native_codecs.decode_image(p), rgb)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image at all")
    with pytest.raises(ValueError, match="unrecognised"):
        native_codecs.decode_image(bad)


def test_native_png_read_by_pil(tmp_path, rgb, native_codecs):
    from PIL import Image

    p = tmp_path / "x.png"
    native_codecs.encode_image(p, rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")),
                                  rgb)


@pytest.mark.parametrize("ext,mode", [
    ("png", "RGB"), ("png", "RGBA"), ("png", "L"), ("png", "P"),
    ("webp", "RGB"), ("webp", "RGBA"), ("jpg", "RGB"), ("jpg", "L")])
def test_decode_matches_rife_tpu(tmp_path, rgb, ext, mode):
    """The port's ``decode_image`` equals ``rife_tpu.io.image.decode_image``
    on the same file, for every codec the two share, on inputs that are not
    RGB (decoding always gives 3 channels)."""
    from PIL import Image

    from rife_tpu.io.image import decode_image as jax_decode

    p = tmp_path / f"x.{ext}"
    Image.fromarray(rgb).convert(mode).save(p)
    got = image.decode_image(p)
    assert got.dtype == np.uint8 and got.shape == rgb.shape
    np.testing.assert_array_equal(got, jax_decode(p))


def test_encode_rejects_bad_input(tmp_path, rgb):
    with pytest.raises(ValueError, match="H,W,3"):
        image.encode_image(tmp_path / "x.png", rgb[..., :2])
    with pytest.raises(ValueError, match="unsupported"):
        image.encode_image(tmp_path / "x.tiff", rgb)


def test_codec_name(pil_only):
    assert image.codec_name() == "PIL"


def test_codec_build_apart_from_the_kernel_build(monkeypatch, tmp_path):
    """The codec library and the CUDA kernel library are separate files
    with separate locks; a failed codec build raises NativeUnavailable and
    leaves the kernel build's state alone."""
    assert codecs._LIB != build.LIB_PATH
    assert codecs._LIB.parent == build.BUILD_DIR
    assert codecs._lock is not build._lock
    monkeypatch.setattr(codecs, "_lib", None)
    monkeypatch.setattr(codecs, "_failed", None)
    monkeypatch.setattr(codecs, "_LIB", tmp_path / "librife_io.so")
    monkeypatch.setattr(codecs, "_SRC", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    kernel_lib = build._lib
    with pytest.raises(codecs.NativeUnavailable, match="native build failed"):
        codecs.load()
    with pytest.raises(codecs.NativeUnavailable):  # the failure is kept
        codecs.load()
    assert build._lib is kernel_lib
    assert not list(tmp_path.glob("*.tmp"))


def test_image_module_imports_without_pil(tmp_path):
    """PIL is imported where it is used: with PIL unimportable the module
    loads, names its codec, and the native codecs (where they build) round
    trip a PNG."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from rife_tpu_torch.io import image\n"
        "name = image.codec_name()\n"
        "assert name in ('native', 'none'), name\n"
        "if name == 'native':\n"
        "    x = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)\n"
        "    image.encode_image(sys.argv[1], x)\n"
        "    assert (image.decode_image(sys.argv[1]) == x).all()\n"
        "print(name)\n")
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "x.png")],
                          capture_output=True, text=True, cwd=repo,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ("native" if native.available() else "none")
