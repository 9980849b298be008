"""A step's scalar operands take no host-to-device copy, and keep the bits
they had as 0-dim tensors on the step's device.

``torch.tensor(v, device="cuda")`` copies from pageable memory and then
waits for the stream: every op queued before it finishes first, and the card
then idles while the host dispatches the next op.  The ops pass a constant
as a Python float rounded to the storage dtype (``torch_ops.scalar``), or,
where a host scalar changes the kernel's arithmetic (DIV, RDIV, POW, MAX,
MIN), as a 0-dim device tensor made once (``torch_ops.device_const``).

The bit tests take every finite bf16 value and run on the CPU and, marked
``cuda``, on the card, whose true division by a host scalar multiplies by
its reciprocal.  The file imports no jax, so on the card:
``python -m pytest --noconftest tests/test_torch_no_sync.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from rife_tpu_torch.graph.ir import LayerNode
from rife_tpu_torch.ops import common as C
from rife_tpu_torch.ops import frame
from rife_tpu_torch.ops import torch_ops as T

CONSTS = (0.2, 1.0 / 3.0, 0.5, 2.0, -0.75, 1.0)
DTYPES = [torch.bfloat16, torch.float32]
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
KINDS = {"add": C.BINARY_ADD, "sub": C.BINARY_SUB, "mul": C.BINARY_MUL,
         "div": C.BINARY_DIV, "max": C.BINARY_MAX, "min": C.BINARY_MIN,
         "pow": C.BINARY_POW, "rsub": C.BINARY_RSUB, "rdiv": C.BINARY_RDIV}


def on(device: str) -> torch.device:
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(device)


def every_bf16(dtype, device) -> torch.Tensor:
    """All finite bf16 values, in ``dtype`` on ``device``."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    vals = bits.view(np.float32)
    vals = vals[np.isfinite(vals)]
    return torch.from_numpy(vals).to(torch.bfloat16).to(device=device,
                                                        dtype=dtype)


def tensor_const(v, x):
    """The constant as the step made it before: a 0-dim tensor of the
    operand's dtype on its device."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit, NaNs included (``torch.equal`` fails on NaN)."""
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.view(ints[got.dtype]),
                            want.view(ints[want.dtype])))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_scalar_binaryop_keeps_its_bits(kind, dtype, device):
    x = every_bf16(dtype, on(device))
    for v in CONSTS:
        node = LayerNode("BinaryOp", "op", ["x"], ["y"],
                         {0: KINDS[kind], 1: 1, 2: v})
        got = T._op_binaryop(node, [x], None, {})[0]
        want = T._BINARY[KINDS[kind]](x, tensor_const(v, x))
        assert same_bits(got, want), (kind, v)


def _upsample_with_tensors(x, n, dim):
    """``_upsample_axis`` with 0-dim tensor factors, as the step ran it."""
    size = x.shape[dim]
    ar = torch.arange(size, device=x.device)
    phases = []
    for p in range(n):
        src = (p + 0.5) / n - 0.5
        d = int(np.floor(src))
        f = src - d
        a = x.index_select(dim, (ar + d).clamp(0, size - 1))
        b = x.index_select(dim, (ar + d + 1).clamp(0, size - 1))
        phases.append(a * tensor_const(1.0 - f, x)
                      + b * tensor_const(f, x))
    shape = list(x.shape)
    shape[dim] = size * n
    return torch.stack(phases, dim=dim + 1).reshape(shape)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["eltwise", "leaky", "relu", "lerp",
                                  "downsample", "preprocess"])
def test_scalar_forms_keep_their_bits(form, dtype, device):
    """The Eltwise coefficients, the fused leaky slope and ReLU's, the
    resize's lerp factors and halves, and the frames' 1/255."""
    x = every_bf16(dtype, on(device))
    if form == "eltwise":
        y = x.flip(0)
        for c, d in zip(CONSTS, CONSTS[::-1]):
            node = LayerNode("Eltwise", "e", ["x", "y"], ["z"],
                             {0: 1, -23301: [c, d]})
            got = T._op_eltwise(node, [x, y], None, {})[0]
            want = x * tensor_const(c, x) + y * tensor_const(d, y)
            assert same_bits(got, want), (c, d)
    elif form in ("leaky", "relu"):
        for s in CONSTS:
            if form == "leaky":
                got = T.apply_activation(x, C.ACT_LEAKY, [s])
            else:
                node = LayerNode("ReLU", "r", ["x"], ["y"], {0: s})
                got = T._op_relu(node, [x], None, {})[0]
            want = torch.where(x >= 0, x, x * tensor_const(s, x))
            assert same_bits(got, want), s
    elif form == "lerp":
        x4 = x.reshape(1, 1, 1, -1)
        for n in (2, 4, 8):
            got = T.resize2d(x4, 1, x4.shape[3] * n)
            assert same_bits(got, _upsample_with_tensors(x4, n, 3)), n
    elif form == "downsample":
        x4 = x[: x.numel() // 8 * 8].reshape(1, 1, 1, -1)
        for n in (2, 4, 8):
            half = tensor_const(0.5, x4)
            want = (x4[..., n // 2 - 1::n] * half + x4[..., n // 2::n] * half)
            got = T.resize2d(x4, 1, x4.shape[3] // n)
            assert same_bits(got, want), n
    else:
        u8 = torch.arange(256, dtype=torch.uint8, device=x.device)
        img = u8.reshape(1, 4, 64, 1).expand(1, 4, 64, 3)
        got = frame.preprocess(img, 4, 64, dtype)
        want = (img.permute(0, 3, 1, 2).to(dtype)
                * tensor_const(1.0 / 255.0, x))
        assert same_bits(got, want)


def test_rounded_scalar_keeps_the_sign_of_zero():
    assert str(T.scalar(-0.0, torch.bfloat16)) == "-0.0"
    assert str(T.scalar(0.0, torch.bfloat16)) == "0.0"
    assert T.scalar(0.2, torch.bfloat16) == float(
        torch.tensor(0.2, dtype=torch.bfloat16))
    assert T.scalar(0.2, torch.float32) == float(np.float32(0.2))


def _model_dir(tmp_path, model):
    if model == "v4.6":
        from rife_tpu_torch.models.v46_arch import write_flownet_param

        return write_flownet_param(tmp_path, (16, 16, 16, 16))
    if model == "v2.3":
        from rife_tpu_torch.models.v23_arch import write_v23_params

        return write_v23_params(tmp_path, (8, 8, 8, 8, 4))
    from rife_tpu_torch.models.v1_arch import write_v1_params

    return write_v1_params(tmp_path, (8, 8, 8, 4))


def _frames(h, w, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (2, h, w, 3), np.uint8)).to(
        device) for _ in range(2)]


@pytest.mark.parametrize("model", ["v4.6", "v2.3"])
def test_warm_step_makes_no_device_tensor(tmp_path, monkeypatch, model):
    """Every ``torch.tensor`` call that names a device during a warm bf16
    step: the step once built 135 (v4.6) and 123 (v2.3) 0-dim constants
    this way, one upload each."""
    from rife_tpu_torch import RIFE

    sess = RIFE(str(_model_dir(tmp_path, model)), device="cpu",
                dtype=torch.bfloat16)
    a, b = _frames(64, 96, "cpu")
    ts = np.full(2, 0.5, np.float32)
    first = sess.process_batch(a, b, ts)
    calls = []
    make = torch.tensor

    def counting(*args, **kw):
        if kw.get("device") is not None:
            calls.append(kw["device"])
        return make(*args, **kw)

    monkeypatch.setattr(torch, "tensor", counting)
    again = sess.process_batch(a, b, ts)
    assert not calls, f"{len(calls)} device tensors made in a warm step"
    assert np.array_equal(again, first)


CARD_CASES = {
    "v4.6": ("v4.6", (64, 96), {}),
    "v4.6-x": ("v4.6", (64, 96), {"tta_mode": True}),
    "v2.3": ("v2.3", (64, 96), {}),
    "v2.3-u": ("v2.3", (64, 128), {"uhd_mode": True}),
    "v1": ("v1", (64, 96), {}),
    "v4.6-height-sharded": ("v4.6", (128, 96), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_warm_step_does_not_sync(tmp_path, case):
    """A warm bf16 ``process_batch_device`` step on frames already on the
    card, under ``torch.cuda.set_sync_debug_mode("error")``: any copy or
    call that waits for the stream raises.  The height-sharded case runs
    four shards of cuda:0."""
    from rife_tpu_torch import RIFE

    dev = on("cuda")
    model, (h, w), kw = CARD_CASES[case]
    sess = RIFE(str(_model_dir(tmp_path, model)), device=dev,
                dtype=torch.bfloat16, **kw)
    if case.endswith("height-sharded"):
        from rife_tpu_torch.parallel.sharding import ShardedRIFE, make_mesh_2d

        sess = ShardedRIFE(sess, make_mesh_2d(1, 4, [dev] * 4),
                           height_axis="spatial")
    a, b = _frames(h, w, dev)
    ts = np.full(2, 0.5, np.float32)
    first = sess.process_batch_device(a, b, ts)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = sess.process_batch_device(a, b, ts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    assert torch.equal(again, first)
