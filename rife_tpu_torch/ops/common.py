"""Backend-independent ncnn layer helpers (copy of
``rife_tpu/ops/common.py``, trimmed to what the port runs): op-type and
activation codes, conv hyperparameters, Interp sizes, Eltwise coefficients
and Slice sizes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..graph.ir import LayerNode

# ncnn BinaryOp op_type (the ones the ported graphs use)
BINARY_ADD = 0
BINARY_SUB = 1
BINARY_MUL = 2
BINARY_RSUB = 7

# ncnn fused activation_type on Convolution/Deconvolution (the ported ones)
ACT_NONE, ACT_RELU, ACT_LEAKY = 0, 1, 2
# private extension (graph/rewrite.py fuse_prelu_activations): per-channel
# PReLU folded into the conv; the slope rides the conv's LayerWeights.
ACT_PRELU_CH = 100


def conv_hyperparams(node: LayerNode) -> Tuple[int, int, int, int, int, bool]:
    """(out_ch, kernel, dilation, stride, pad, has_bias)."""
    return (
        int(node.p(0)),
        int(node.p(1)),
        int(node.p(2, 1)),
        int(node.p(3, 1)),
        int(node.p(4, 0)),
        int(node.p(5, 0)) == 1,
    )


def activation_of(node: LayerNode) -> Tuple[int, List[float]]:
    act = int(node.p(9, 0))
    params = node.p(-23310, [])
    if not isinstance(params, list):
        params = [params]
    return act, [float(v) for v in params]


def interp_out_size(h: int, w: int, node: LayerNode) -> Tuple[int, int, int]:
    """(resize_type, out_h, out_w) for an Interp layer."""
    resize_type = int(node.p(0, 0))
    hs = float(node.p(1, 1.0))
    ws = float(node.p(2, 1.0))
    return resize_type, int(round(h * hs)), int(round(w * ws))


def eltwise_coeffs(node: LayerNode, n: int) -> List[float]:
    coeffs = node.p(-23301, [])
    if not coeffs:
        return [1.0] * n
    return [float(c) for c in coeffs]


def slice_sizes(node: LayerNode, total: int, n_out: int) -> Sequence[int]:
    """Decode ncnn Slice sizes; -233 entries share the remainder equally."""
    sizes = list(node.p(-23300, [-233] * n_out))
    fixed = sum(s for s in sizes if s != -233)
    n_auto = sizes.count(-233)
    if n_auto:
        share = (total - fixed) // n_auto
        sizes = [share if s == -233 else s for s in sizes]
    return sizes
