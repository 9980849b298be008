"""The library conv sites' epilogue (``ops/conv.py`` ``bias_act``): one pass
for the bias and the activation where ``F.conv2d`` / ``F.conv_transpose2d``
runs the conv.

On the CPU: the twin equals what the sites computed before it, the bias in
the storage dtype and then ``torch_ops.apply_activation``, bit for bit, over
every finite bf16 value (in bf16 and in f32), for the leaky slopes of the zoo
and others, a per-channel PReLU slope vector, ReLU and no activation, with
and without a bias; ``_op_convolution`` on the CPU keeps the library's bias
and the eager activation; ``plan.kernel_sites`` counts one ``bias_act`` a
library site that has a bias or an activation, routed as on the card, and
equals what one step hands the wrapper.

Marked ``cuda``: the kernel equals its twin on the card, and the eager ops
it replaces, bit for bit, at the same values, at the steps' site shapes, on
the scalar path (an odd plane, a misaligned view); it raises on what it does
not take; a warm step launches it as often as the plan says.  The file
imports no jax, so on the card:
``python -m pytest --noconftest tests/test_torch_bias_act.py -m cuda``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rife_tpu_torch import RIFE
from rife_tpu_torch.engine import plan
from rife_tpu_torch.graph.ir import LayerNode
from rife_tpu_torch.ops import common as C
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import torch_ops as T

DTYPES = [torch.bfloat16, torch.float32]
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
# (activation, its ncnn params): none, ReLU, leaky at the zoo's 0.2 and at
# other slopes, per-channel PReLU
ACTS = {"none": (C.ACT_NONE, []), "relu": (C.ACT_RELU, []),
        "leaky0.2": (C.ACT_LEAKY, [0.2]), "leaky0.1": (C.ACT_LEAKY, [0.1]),
        "leaky0.01": (C.ACT_LEAKY, [0.01]),
        "leaky1/3": (C.ACT_LEAKY, [1.0 / 3.0]),
        "prelu": (C.ACT_PRELU_CH, [])}
CHANNELS = 4
BIAS = (0.0, -0.0, 0.7109375, -3.140625)   # bf16 values, both zeros
SLOPE = (0.25, 0.1, 0.01, 1.0 / 3.0)
INTS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def on(device: str) -> torch.device:
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(device)


def every_bf16(dtype, device) -> torch.Tensor:
    """Every finite bf16 value in each of ``CHANNELS`` channels, as (1, C,
    1, n) with n a multiple of 8, the kernel's vector (the tail repeats
    values)."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    vals = bits.view(np.float32)
    vals = vals[np.isfinite(vals)]
    vals = np.concatenate([vals, vals[:(-len(vals)) % 8]])
    planes = np.stack([np.roll(vals, 997 * c) for c in range(CHANNELS)])
    return torch.from_numpy(planes[None, :, None, :].copy()).to(
        torch.bfloat16).to(device=device, dtype=dtype)


def site_operands(act, dtype, device, with_bias=True):
    """(bias_q, slope_q) as ``torch_ops._entry`` keeps them: (C,) float32 of
    the storage dtype's values; and (bias, slope) as the library path reads
    them: the bias in the storage dtype, the slope (1,C,1,1) in it."""
    bias = torch.tensor(BIAS).to(dtype) if with_bias else None
    slope = (torch.tensor(SLOPE).to(dtype).reshape(1, -1, 1, 1)
             if act == C.ACT_PRELU_CH else None)
    q = (lambda t: None if t is None  # noqa: E731
         else t.reshape(-1).float().to(device))
    d = (lambda t: None if t is None else t.to(device))  # noqa: E731
    return q(bias), q(slope), d(bias), d(slope)


def eager(y, act, params, bias, slope):
    """What a library site computed on the card without the kernel: the
    bias added in place in the storage dtype (``output.add_`` after the
    library conv), then ``apply_activation``."""
    y = y.clone()
    if bias is not None:
        y.add_(bias.reshape(1, -1, 1, 1))
    return T.apply_activation(y, act, params, slope)


def same_bits(got, want) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.view(INTS[got.dtype]),
                            want.view(INTS[want.dtype])))


def kernel_args(act, params):
    kact, alpha = CV.ACT_MAP[act], params[0] if params else 0.2
    return kact, alpha


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(ACTS))
def test_epilogue_keeps_the_eager_bits(case, dtype, device):
    """On the CPU the twin, on the card the kernel (and the twin), against
    the bias add and ``apply_activation``, over every finite bf16 value in
    each channel."""
    dev = on(device)
    act, params = ACTS[case]
    y = every_bf16(dtype, dev)
    for with_bias in (True, False) if act != C.ACT_NONE else (True,):
        bias_q, slope_q, bias, slope = site_operands(act, dtype, dev,
                                                     with_bias)
        want = eager(y, act, params, bias, slope)
        kact, alpha = kernel_args(act, params)
        got = CV.bias_act(y.clone(), bias_q, slope_q, kact, alpha)
        assert same_bits(got, want), (case, with_bias)
        twin = CV.bias_act_ref(y, bias_q, slope_q, kact, alpha)
        assert same_bits(twin, want), (case, with_bias)


def conv_node(act, params, cout):
    p = {0: cout, 1: 3, 2: 1, 3: 1, 4: 1, 5: 1, 9: act}
    if params:
        p[-23310] = params
    return LayerNode("Convolution", "c", ["x"], ["y"], p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["leaky0.2", "prelu", "relu", "none"])
def test_cpu_convolution_keeps_the_library_bias(case, dtype):
    """``_op_convolution`` on the CPU: ``F.conv2d`` with the bias (oneDNN
    adds it inside the conv), then the eager activation, as before."""
    act, params = ACTS[case]
    rng = np.random.default_rng(5)
    cin, cout = 3, CHANNELS
    weight = rng.normal(size=(cout, cin, 3, 3)).astype(np.float32) * 0.3
    bias = rng.normal(size=cout).astype(np.float32)
    slope = np.array(SLOPE, np.float32) if act == C.ACT_PRELU_CH else None
    node = conv_node(act, params, cout)
    p = T._entry(node, weight, bias, slope, dtype, "cpu")
    x = torch.from_numpy(rng.normal(size=(2, cin, 9, 11)).astype(
        np.float32)).to(dtype)
    got = T._op_convolution(node, [x], None, {"w": {"c": p}})[0]
    want = T.apply_activation(
        F.conv2d(x, p["weight"], p["bias"], padding=1), act, params,
        p.get("slope"))
    assert same_bits(got, want)


@pytest.fixture(scope="module")
def mini_dirs(tmp_path_factory):
    from rife_tpu_torch.models.v1_arch import write_v1_params
    from rife_tpu_torch.models.v23_arch import write_v23_params
    from rife_tpu_torch.models.v46_arch import write_flownet_param

    root = tmp_path_factory.mktemp("bias_act")
    return {"v4.6": str(write_flownet_param(root, (16, 16, 16, 16))),
            "v2.3": str(write_v23_params(root, (8, 8, 8, 8, 4))),
            "v1": str(write_v1_params(root, (8, 8, 8, 4), "rife"))}


def as_on_card(monkeypatch):
    """Route the library sites and the deconv sites of a CPU session as a
    session on the card routes them (the wrappers then run their twins)."""
    real = CV.epilogue_on_kernel
    monkeypatch.setattr(CV, "epilogue_on_kernel",
                        lambda device, act, has_bias: real("cuda", act,
                                                           has_bias))
    monkeypatch.setattr(CV, "deconv_on_kernel",
                        lambda device, dtype: dtype == torch.bfloat16)


# the step's kernels at 1080p on the card: one ``bias_act`` a library conv
# site that has a bias or an activation (v1 has 64 library sites, 7 of them
# with neither); -u at 2160x3840; 1x4: one data shard height-sharded over
# four shards, each running every net
FULL_SITES = {
    "v4.6": ({}, 1, 40), "v4.6 -x -z": ({"tta_mode": True,
                                          "tta_temporal_mode": True}, 1, 160),
    "v2.3": ({}, 1, 44), "v2.3 -u": ({"uhd_mode": True}, 1, 41),
    "v1": ({}, 1, 57), "v4.6 1x4": ({}, 4, 160),
}


@pytest.fixture(scope="module")
def full_dirs(tmp_path_factory):
    from rife_tpu_torch.models.v1_arch import write_v1_params
    from rife_tpu_torch.models.v23_arch import write_v23_params
    from rife_tpu_torch.models.v46_arch import write_flownet_param

    root = tmp_path_factory.mktemp("bias_act_full")
    return {"v4.6": str(write_flownet_param(root)),
            "v2.3": str(write_v23_params(root)),
            "v1": str(write_v1_params(root))}


@pytest.mark.parametrize("case", list(FULL_SITES))
def test_plan_counts_one_epilogue_a_library_site(full_dirs, monkeypatch,
                                                 case):
    from rife_tpu_torch.parallel.sharding import ShardedRIFE, make_mesh_2d

    modes, n_sp, want = FULL_SITES[case]
    as_on_card(monkeypatch)
    sess = RIFE(full_dirs[case.split()[0]], device="cpu",
                dtype=torch.bfloat16, **modes)
    hw = (2160, 3840) if modes.get("uhd_mode") else (1080, 1920)
    if n_sp > 1:
        cpu = torch.device("cpu")
        sites = ShardedRIFE(sess, make_mesh_2d(1, n_sp, [cpu] * n_sp),
                            height_axis="spatial").kernel_sites(*hw)
    else:
        sites = plan.kernel_sites(sess, *hw)
    assert sites["bias_act"] == want
    monkeypatch.setattr(CV, "epilogue_on_kernel", lambda *args: False)
    assert "bias_act" not in plan.kernel_sites(sess, *hw)


@pytest.mark.parametrize("model", ["v4.6", "v2.3", "v1"])
def test_plan_equals_dispatch_as_on_the_card(mini_dirs, monkeypatch, model):
    """Every call of the wrapper in one bf16 step routed as on the card, at
    64x96, against ``plan.kernel_sites``; the CPU's own route calls it
    never."""
    sess = RIFE(mini_dirs[model], device="cpu", dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    a, b = (rng.integers(0, 256, (1, 64, 96, 3), np.uint8) for _ in range(2))
    ts = np.full(1, 0.5, np.float32)
    calls = []
    real = CV.bias_act

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(CV, "bias_act", spy)
    sess.process_batch(a, b, ts)
    assert not calls
    as_on_card(monkeypatch)
    sess.process_batch(a, b, ts)
    assert len(calls) == plan.kernel_sites(sess, 64, 96)["bias_act"] > 0


# --- the kernel on the card -------------------------------------------------

# (B, C, H, W, activation): the 1080p B=8 steps' library sites, v4.6's res0
# and res3 bodies (leaky 0.2), v2.3's block3 body and down3 (PReLU)
SITE_SHAPES = [(8, 192, 34, 60, "leaky0.2"), (8, 64, 272, 480, "leaky0.2"),
               (8, 96, 272, 480, "prelu"), (8, 512, 34, 60, "prelu")]


def random_site(shape, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = (torch.randn(shape, generator=gen, device=dev) * 2).to(
        torch.bfloat16).to(dtype)
    c = shape[1]
    bias = (torch.randn(c, generator=gen, device=dev).to(
        torch.bfloat16).float())
    slope = (torch.rand(c, generator=gen, device=dev) * 0.5).to(
        torch.bfloat16).float()
    return y, bias, slope


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("site", range(len(SITE_SHAPES)))
def test_kernel_at_the_steps_sites(dtype, site):
    dev = on("cuda")
    *shape, case = SITE_SHAPES[site]
    act, params = ACTS[case]
    y, bias, slope = random_site(tuple(shape), dtype, dev, site)
    kact, alpha = kernel_args(act, params)
    CV.reset_launches()
    got = CV.bias_act(y.clone(), bias, slope, kact, alpha)
    want = eager(y, act, params, bias.to(dtype), slope.to(dtype).reshape(
        1, -1, 1, 1))
    torch.cuda.synchronize()
    assert CV.LAUNCHES["bias_act"] == 1
    assert same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["odd plane", "misaligned view"])
def test_kernel_scalar_path(dtype, form):
    """A plane whose size is no multiple of the vector, and a contiguous
    tensor whose data starts off the 16-byte grid."""
    dev = on("cuda")
    act, params = ACTS["prelu"]
    shape = (3, CHANNELS, 7, 13) if form == "odd plane" else (3, CHANNELS,
                                                              8, 16)
    y, bias, slope = random_site(shape, dtype, dev, 11)
    if form == "misaligned view":
        flat = torch.empty(y.numel() + 1, dtype=dtype, device=dev)
        flat[1:] = y.reshape(-1)
        y = flat[1:].view(shape)
        assert y.is_contiguous() and y.data_ptr() % 16
    kact, alpha = kernel_args(act, params)
    want = eager(y, act, params, bias.to(dtype), slope.to(dtype).reshape(
        1, -1, 1, 1))
    got = CV.bias_act(y, bias, slope, kact, alpha)
    torch.cuda.synchronize()
    assert got.data_ptr() == y.data_ptr() and same_bits(got, want)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    dev = on("cuda")
    y, bias, slope = random_site((2, CHANNELS, 8, 8), torch.bfloat16, dev, 3)
    CV.reset_launches()
    with pytest.raises(ValueError, match="contiguous"):
        CV.bias_act(y.transpose(2, 3), bias, None, CV.ACT_LEAKY)
    with pytest.raises(ValueError, match="bias"):
        CV.bias_act(y, bias.to(torch.bfloat16), None, CV.ACT_LEAKY)
    with pytest.raises(ValueError, match="slope"):
        CV.bias_act(y, bias, None, CV.ACT_PRELU)
    with pytest.raises(TypeError):
        CV.bias_act(y.half(), bias, None, CV.ACT_LEAKY)
    with pytest.raises(ValueError, match="activation"):
        CV.bias_act(y, bias, None, 7)
    assert CV.LAUNCHES["bias_act"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["v4.6", "v2.3", "v1"])
def test_warm_step_launches_as_the_plan_says(mini_dirs, model):
    dev = on("cuda")
    sess = RIFE(mini_dirs[model], device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.integers(0, 256, (2, 64, 96, 3),
                                          np.uint8)).to(dev)
            for _ in range(2))
    ts = np.full(2, 0.5, np.float32)
    sess.process_batch_device(a, b, ts)
    CV.reset_launches()
    sess.process_batch_device(a, b, ts)
    torch.cuda.synchronize()
    assert CV.LAUNCHES["bias_act"] == plan.kernel_sites(sess, 64, 96)[
        "bias_act"] > 0
