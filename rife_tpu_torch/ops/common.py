"""Backend-independent ncnn layer helpers (copy of
``rife_tpu/ops/common.py``, trimmed to what the port runs): op-type and
activation codes, conv hyperparameters, Interp sizes, Eltwise coefficients
and Slice sizes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..graph.ir import LayerNode

# ncnn BinaryOp op_type
BINARY_ADD = 0
BINARY_SUB = 1
BINARY_MUL = 2
BINARY_DIV = 3
BINARY_MAX = 4
BINARY_MIN = 5
BINARY_POW = 6
BINARY_RSUB = 7
BINARY_RDIV = 8

# ncnn UnaryOp op_type (the v1 graphs use NEG)
UNARY_ABS, UNARY_NEG, UNARY_FLOOR, UNARY_CEIL = 0, 1, 2, 3
UNARY_SQUARE, UNARY_SQRT, UNARY_RSQRT, UNARY_EXP = 4, 5, 6, 7
UNARY_LOG, UNARY_SIN, UNARY_COS, UNARY_TAN = 8, 9, 10, 11

# ncnn fused activation_type on Convolution/Deconvolution/InnerProduct
ACT_NONE, ACT_RELU, ACT_LEAKY, ACT_CLIP, ACT_SIGMOID = 0, 1, 2, 3, 4
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
