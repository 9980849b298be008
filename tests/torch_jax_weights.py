"""The JAX package's prepared weights in the port's form, for the tests
that hold the two against each other."""

import numpy as np
import torch

from rife_tpu_torch.ops import torch_ops as T


def weights_from_jax(graph, tree, dtype=torch.float32, device="cpu"):
    """The JAX package's prepared weights (``jax_ops.prepare_weights``, as
    numpy arrays) -> ``torch_ops.prepare_weights``'s: HWIO convs become
    OIHW, the spatially flipped HWIO deconvs become ncnn's (I,O,kh,kw), an
    InnerProduct's (in, out) ``dense`` becomes (out, in)."""
    out = {}
    for node in graph.nodes:
        e = tree.get(node.name)
        if e is None:
            continue
        if node.type == "PReLU":
            out[node.name] = {"slope": T._tensor(e["slope"], dtype, device)}
            continue
        if node.type == "InnerProduct":
            out[node.name] = {
                "weight": T._tensor(np.asarray(e["dense"], np.float32).T,
                                    dtype, device),
                "bias": T._tensor(e["bias"], dtype, device)}
            continue
        if node.type not in T._CONV_KINDS + T._DECONV_KINDS:
            continue
        hwio = np.asarray(e["hwio"], np.float32)
        if node.type in T._CONV_KINDS:
            weight = hwio.transpose(3, 2, 0, 1)
        else:
            weight = hwio[::-1, ::-1].transpose(2, 3, 0, 1)
        out[node.name] = T._entry(node, weight, e["bias"], e.get("slope"),
                                  dtype, device)
    return out
