"""The port's bf16 CPU session against rife_tpu's bf16 session on the
v1-architecture graphs (mini widths), with rife_tpu's Pallas warps in
interpret mode (``use_pallas_warp`` on each executor's ctx, as
tests/test_torch_bf16_session.py does; nothing in ``rife_tpu`` changes).

Bars, as measured:

* plain ``rife`` at a 32-aligned and an unaligned size and plain
  ``rife-anime``: u8 **bit-exact**, with the conv gates as shipped and
  lowered to 0 (every admissible site, the ConvPS head included, on the
  twins of ``conv3x3`` / B4).  The SE gates' ``Pooling`` (an f32 sum, then
  one rounding, as ``jnp.mean``) and ``InnerProduct`` (an f32 product,
  rounded, then the bf16 bias) hold bit for bit in these runs.
* ``rife -x -z`` (64x96) and ``rife -u`` (50x70): bit-exact once the
  convs that stay off the planar kernel are computed as XLA computes them
  on the CPU (f32 sums, one rounding to bf16, then the bf16 bias).  With
  torch's own CPU bf16 convolution (oneDNN) they are not: it rounds
  otherwise on a few values of some views and sizes, and an SE gate
  spreads one ulp of one conv value over its whole channel (a global mean
  scales every pixel), so the gap is wide but shallow: measured max |d|
  1 LSB with 96.60% exact (``-x -z``), 4 LSB with 99.94% exact (``-u``).
  The test holds both facts.  On the card the cuDNN sites run cuDNN, and
  ``chip_smoke.py`` holds the card's bf16 to the CPU's (its PSNR against
  f32 within 3 dB of the CPU bf16 session's).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from rife_tpu_torch import RIFE
from rife_tpu_torch.models.v1_arch import write_v1_params
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import torch_ops

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_bf16_session import HALF, smooth_frames  # noqa: E402

MINI = (8, 8, 8, 4)
MODES = {"plain": {}, "-x -z": {"tta_mode": True, "tta_temporal_mode": True},
         "-u": {"uhd_mode": True}}
# (variant, mode, size): the gap with torch's CPU bf16 conv, measured 1 LSB
# at 96.60% exact and 4 LSB at 99.94%; held with room (oneDNN's kernels
# vary with the CPU) so that a new divergence shows
GAPPED = {("rife", "-x -z", (64, 96)): (2, 0.95),
          ("rife", "-u", (50, 70)): (6, 0.999)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("v1bf16")
    return {v: write_v1_params(root, MINI, v) for v in ("rife", "rife-anime")}


@pytest.fixture(scope="module")
def jax_reference(model_dirs):
    """rife_tpu bf16 outputs with the Pallas warps (interpret mode), each
    computed once (an XLA compile of a v1 step takes tens of seconds on the
    CPU)."""
    from rife_tpu.engine.session import RIFE as JaxRIFE

    cache = {}

    def get(variant, mode, size):
        key = (variant, mode, size)
        if key not in cache:
            sess = JaxRIFE(str(model_dirs[variant]), dtype="bfloat16",
                           **MODES[mode])
            for ex in sess.executors.values():
                ex.ctx["use_pallas_warp"] = True
            with pltpu.force_tpu_interpret_mode():
                cache[key] = sess.process_batch(*smooth_frames(*size), HALF)
        return cache[key]
    return get


def port(model_dir, mode, size):
    sess = RIFE(str(model_dir), device="cpu", dtype=torch.bfloat16,
                **MODES[mode])
    return sess.process_batch(*smooth_frames(*size), HALF)


def u8_gap(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(diff.max()), float((diff == 0).mean())


class _XlaConvs:
    """``torch.nn.functional`` with the bf16 convolutions computed as XLA
    computes them on the CPU: f32 sums of the bf16 operands, one rounding,
    then the bias in bf16."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def _bf16(fn, x, w, b, **kw):
        if x.dtype != torch.bfloat16:
            return fn(x, w, b, **kw)
        y = fn(x.float(), w.float(), None, **kw).to(torch.bfloat16)
        return y if b is None else y + b.reshape(1, -1, 1, 1)

    def conv2d(self, x, w, b=None, **kw):
        return self._bf16(F.conv2d, x, w, b, **kw)

    def conv_transpose2d(self, x, w, b=None, **kw):
        return self._bf16(F.conv_transpose2d, x, w, b, **kw)


@pytest.mark.parametrize("sites", ["gated", "all"])
@pytest.mark.parametrize("variant,size", [("rife", (64, 96)),
                                          ("rife", (50, 70)),
                                          ("rife-anime", (50, 70))])
def test_plain_bit_exact_with_pallas_forms(model_dirs, jax_reference,
                                           variant, size, sites,
                                           monkeypatch):
    if sites == "all":
        monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
        monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    got = port(model_dirs[variant], "plain", size)
    assert u8_gap(got, jax_reference(variant, "plain", size)) == (0, 1.0)


@pytest.mark.parametrize("variant,mode,size", list(GAPPED))
def test_tta_and_uhd_bit_exact_with_xla_convs(model_dirs, jax_reference,
                                              variant, mode, size,
                                              monkeypatch):
    want = jax_reference(variant, mode, size)
    worst, exact = u8_gap(port(model_dirs[variant], mode, size), want)
    print(f"v1 {variant} {mode} {size} bf16, torch's CPU convs: max |d| "
          f"{worst}, exact {exact:.4f}")
    max_d, min_exact = GAPPED[variant, mode, size]
    assert worst <= max_d and exact >= min_exact
    monkeypatch.setattr(torch_ops, "F", _XlaConvs())
    assert u8_gap(port(model_dirs[variant], mode, size), want) == (0, 1.0)
