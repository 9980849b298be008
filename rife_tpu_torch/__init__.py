"""rife_tpu_torch — the PyTorch/CUDA port of rife_tpu for one NVIDIA H100.

The JAX package ``rife_tpu`` stays the reference.  This package imports
nothing of it and never imports jax: it keeps its own copies of the JAX
package's framework-free layers (``graph/``: ir, param, weights, rewrite,
``Executor``; ``models/zoo.py``; ``ops/common.py``), the ops are PyTorch,
and the warp and planar conv kernels that ``rife_tpu`` wrote in Pallas are
hand-written CUDA (``csrc/warp.cu``, ``csrc/conv.cu``).  Only the tests
import both, to hold the port against the reference.

Device and dtype policy: sessions run on the card ("cuda") unless the caller
asks for the CPU.  Activations are
bf16 on CUDA (f32 accumulation inside convs and kernels) and f32 on the CPU,
as ``rife_tpu/cli.py`` chooses for a TPU and the CPU.  Nothing moves to the
CPU on its own: asking for CUDA without a card raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and no
    card is present (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on CUDA, f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


from .engine.session import RIFE  # noqa: E402  (needs the helpers above)
