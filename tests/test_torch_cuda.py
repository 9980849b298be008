"""The port on the card: each CUDA kernel against its plain PyTorch twin, and
the v4.6 and v2.3 slices on CUDA (plain, ``-x -z`` with ``fuse_ds2``, and
v2.3 ``-u``) against the same sessions on the CPU.

Every test here is marked ``cuda`` and skips without a GPU (a CUDA kernel has
no CPU mode).  The file imports no jax, so it also runs where jax is absent:
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.
Tolerances: those of tests/test_torch_warp.py for the warp kernels (f32 max
|d| <= 2e-6; bf16 <= 1 ulp and exact on >= 99%), of tests/test_torch_conv.py
for conv3x3 (f32 max |d| <= 1e-5 of the largest output; bf16 as the warps,
the ulp taken of an output no smaller than 2^-14 of the sum of its absolute
products: the tensor-core kernel sums in another order than the twin);
for the slices, u8 max |d| <= 1 and exact on >= 99.9% of pixels (cuDNN sums
in another order than the CPU).
"""

import os

import numpy as np
import pytest
import torch

from rife_tpu_torch.ops import warp as W

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def inputs(seed, b, h, w, dtype, device):
    """NCHW u8-valued images, flows leaving the frame, a (B,H,W) mask."""
    rng = np.random.default_rng(seed)
    img = lambda: rng.integers(0, 256, (b, 3, h, w)) / 255.0  # noqa: E731
    fa = rng.normal(size=(b, 2, h, w)) * 6
    fa[:, :, : h // 8] += 30.0
    fb = rng.normal(size=(b, 2, h, w)) * 6
    fb[:, 0, :, : w // 10] -= 40.0
    mask = rng.uniform(0, 1, (b, h, w))
    return [torch.from_numpy(x.astype(np.float32)).to(device=device,
                                                       dtype=dtype)
            for x in (img(), fa, img(), fb, mask)]


def launched():
    """The warp kernels launched since the last reset."""
    return {k: v for k, v in W.LAUNCHES.items() if v}


def check(got, want, f32_rel=None, scale=None):
    """``scale`` (conv3x3): the sum of the absolute products of each output;
    bf16 ulps are then taken of max(|want|, 2^-14 scale), since two f32 sums
    in different orders differ by up to ~2^-23 scale, more than one ulp of
    an output that cancels to near zero."""
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs().cpu()
    if want.dtype == torch.float32:
        bound = 2e-6 if f32_rel is None else f32_rel * float(
            want.abs().max())
        assert float(diff.max()) <= bound
    else:
        r = want.float().abs().cpu()
        if scale is not None:
            r = torch.maximum(r, scale.float().cpu() * 2.0 ** -14)
        r = r.clamp_min(2.0 ** -126)
        assert bool((diff <= torch.pow(2.0, torch.floor(torch.log2(r)) - 7)).all())
        assert float((diff == 0).float().mean()) >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 68, 260), (1, 1088, 1920)])
def test_kernels_match_twins(cuda_device, shape, dtype):
    ia, fa, ib, fb, m = inputs(6, *shape, dtype, cuda_device)
    W.reset_launches()
    got = [*W.warp_pair(ia, fa, ib, fb), W.warp_render(ia, fa, ib, fb, m),
           *W.warp_ds4_pair(ia, fa, ib, fb)]
    want = [*W.warp_pair_ref(ia, fa, ib, fb),
            W.warp_render_ref(ia, fa, ib, fb, m),
            *W.warp_ds4_pair_ref(ia, fa, ib, fb)]
    torch.cuda.synchronize()
    assert launched() == {"warp_pair": 1, "warp_render": 1, "warp_ds4_pair": 1}
    for g, r in zip(got, want):
        check(g, r)


def test_wrappers_reject_bad_operands(cuda_device):
    ia, fa, ib, fb, _ = inputs(7, 1, 16, 24, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        W.warp_pair(ia, fa.transpose(2, 3).contiguous().transpose(2, 3),
                    ib, fb)
    with pytest.raises(ValueError, match="flow"):
        W.warp_pair(ia, fa[:, :1].contiguous(), ib, fb)
    with pytest.raises(TypeError):
        W.warp_pair(ia.half(), fa.half(), ib.half(), fb.half())
    with pytest.raises(ValueError, match="divisible by 4"):
        W.warp_ds4_pair(*[t[..., :22].contiguous() for t in (ia, fa, ib, fb)])


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from rife_tpu_torch.models.v46_arch import write_flownet_param

    return write_flownet_param(tmp_path_factory.mktemp("cuda"), (16, 16, 16, 16))


def frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, h, w, 3), np.uint8),
            rng.integers(0, 256, (2, h, w, 3), np.uint8))


def test_slice_f32_matches_cpu(cuda_device, model_dir, monkeypatch):
    from rife_tpu_torch import RIFE

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    a, b = frames(64, 96)
    ts = np.full(2, 0.5, np.float32)
    want = RIFE(str(model_dir), device="cpu").process_batch(a, b, ts)
    got = RIFE(str(model_dir), device=cuda_device,
               dtype=torch.float32).process_batch(a, b, ts)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_slice_launches_each_kernel_per_step(cuda_device, model_dir):
    from rife_tpu_torch import RIFE

    sess = RIFE(str(model_dir), device=cuda_device)
    assert sess.dtype == torch.bfloat16
    a, b = frames(64, 96)
    W.reset_launches()
    out = sess.process_batch_device(a, b, np.full(2, 0.5, np.float32))
    torch.cuda.synchronize()
    assert out.shape == (2, 64, 96, 3) and out.device.type == "cuda"
    assert launched() == {"warp_pair": 2, "warp_render": 1, "warp_ds4_pair": 1}


def test_unfused_warps_take_single_kernel_on_cuda(cuda_device, model_dir,
                                                  monkeypatch):
    """Without the rewrites the graph runs unpaired warps: on the card each
    launches the single-warp kernel's u8 mode (K4), and the result stays
    within the slice tolerance of the fused graph."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine import session

    a, b = frames(32, 32)
    ts = np.full(2, 0.5, np.float32)
    fused = RIFE(str(model_dir), device=cuda_device).process_batch(a, b, ts)
    monkeypatch.setattr(session, "rewrite_flownet",
                        lambda graph, weights, **_: (graph, weights))
    sess = RIFE(str(model_dir), device=cuda_device)
    W.reset_launches()
    got = sess.process_batch(a, b, ts)
    assert W.LAUNCHES["warp_u8"] == 8 and W.LAUNCHES["warp_pair"] == 0
    diff = np.abs(got.astype(np.int16) - fused.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def feat_inputs(seed, b, c, h, w, dtype, device):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, c, h, w)) * 2
    flow = rng.normal(size=(b, 2, h, w)) * 5
    flow[:, :, : h // 6] += 20.0
    return [torch.from_numpy(x.astype(np.float32)).to(device=device,
                                                       dtype=dtype)
            for x in (img, flow)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w", [(16, 32, 272, 480), (2, 7, 33, 61),
                                     (2, 256, 34, 60)])
def test_single_warp_kernel_matches_twins(cuda_device, b, c, h, w, dtype):
    img, flow = feat_inputs(8, b, c, h, w, dtype, cuda_device)
    pos = W.ds4_positions(flow)
    u8 = (img[:, :3].float().sigmoid() * 255).round().div(255).to(dtype)
    W.reset_launches()
    got = [W.warp_feat(img, flow), W.warp_feat(img, pos, abs_pos=True),
           W.warp_u8(u8.contiguous(), flow), W.warp_u8(u8.contiguous(), pos,
                                                       abs_pos=True)]
    want = [W.warp_feat_ref(img, flow),
            W.warp_feat_ref(img, pos, abs_pos=True),
            W.warp_u8_ref(u8, flow), W.warp_u8_ref(u8, pos, abs_pos=True)]
    torch.cuda.synchronize()
    assert W.LAUNCHES["warp_feat"] == 2 and W.LAUNCHES["warp_u8"] == 2
    for g, r in zip(got, want):
        check(g, r)


TILINGS = {  # ops/warp.py settings: the defaults, other tile shapes (flat
    # and wide, tall and narrow), and one channel group in float mode
    "default": {},
    "flat": {"TILE_W": 128, "TILE_H": 2, "FEAT_TILE_W": 32, "FEAT_TILE_H": 8},
    "tall": {"TILE_W": 16, "TILE_H": 16, "FEAT_TILE_W": 8, "FEAT_TILE_H": 32},
    "one_group": {"FEAT_THREADS": 0}}


def set_tiling(monkeypatch, tiling):
    for name, value in TILINGS[tiling].items():
        monkeypatch.setattr(W, name, value)


@pytest.mark.parametrize("tiling", list(TILINGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w", [(16, 256, 34, 60), (16, 32, 272, 480),
                                     (2, 7, 33, 61)])
def test_tiled_feat_warp_matches_twin(cuda_device, monkeypatch, tiling, b,
                                      c, h, w, dtype):
    """K1/K2 (the float mode of the tiled kernel), raw flow and absolute
    positions, on the default tiles and channel groups and on others."""
    set_tiling(monkeypatch, tiling)
    img, flow = feat_inputs(13, b, c, h, w, dtype, cuda_device)
    pos = W.ds4_positions(flow)
    W.reset_launches()
    got = [W.warp_feat(img, flow), W.warp_feat(img, pos, abs_pos=True)]
    want = [W.warp_feat_ref(img, flow),
            W.warp_feat_ref(img, pos, abs_pos=True)]
    torch.cuda.synchronize()
    assert launched() == {"warp_feat": 2}
    for g, r in zip(got, want):
        print(f"warp_feat {tiling} {(b, c, h, w)} max|d| "
              f"{float((g.float() - r.float()).abs().max())}")
        check(g, r)


def iid_inputs(seed, b, h, w, dtype, device, scale):
    """u8-valued images and spatially white flows of the given scale."""
    rng = np.random.default_rng(seed)
    arrs = [rng.integers(0, 256, (b, 3, h, w)) / 255.0,
            rng.normal(size=(b, 2, h, w)) * scale,
            rng.integers(0, 256, (b, 3, h, w)) / 255.0,
            rng.normal(size=(b, 2, h, w)) * scale]
    return [torch.from_numpy(x.astype(np.float32)).to(device=device,
                                                      dtype=dtype)
            for x in arrs]


@pytest.mark.parametrize("tiling", list(TILINGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,flows", [
    ((8, 1088, 1920), "smooth"), ((2, 52, 196), "iid"),
    ((2, 52, 196), "iid_small"), ((2, 33, 61), "smooth")])
def test_tiled_u8_warps_match_twins(cuda_device, monkeypatch, tiling, shape,
                                    flows, dtype):
    """K5 (``warp_pair``) and K4 (``warp_u8``, raw flow and absolute
    positions) on the default tiles and on others; smooth flows that leave
    the frame, and spatially white ones, large and small."""
    set_tiling(monkeypatch, tiling)
    if flows == "smooth":
        ia, fa, ib, fb, _ = inputs(14, *shape, dtype, cuda_device)
    else:
        ia, fa, ib, fb = iid_inputs(15, *shape, dtype, cuda_device,
                                    20.0 if flows == "iid" else 1.5)
    pos = W.ds4_positions(fa)
    W.reset_launches()
    got = [*W.warp_pair(ia, fa, ib, fb), W.warp_u8(ia, fa),
           W.warp_u8(ia, pos, abs_pos=True)]
    want = [*W.warp_pair_ref(ia, fa, ib, fb), W.warp_u8_ref(ia, fa),
            W.warp_u8_ref(ia, pos, abs_pos=True)]
    torch.cuda.synchronize()
    assert launched() == {"warp_pair": 1, "warp_u8": 2}
    for g, r in zip(got, want):
        print(f"u8 warps {tiling} {shape} {flows} max|d| "
              f"{float((g.float() - r.float()).abs().max())}")
        check(g, r)


def test_tiled_warps_reject_bad_tiles(cuda_device, monkeypatch):
    """A tile the kernels cannot take (threads not whole warps, or more than
    256 of them) raises; nothing falls back to a twin."""
    ia, fa, ib, fb, _ = inputs(16, 1, 16, 24, torch.float32, cuda_device)
    W.reset_launches()
    monkeypatch.setattr(W, "TILE_W", 10)
    with pytest.raises(RuntimeError, match="CUDA error"):
        W.warp_pair(ia, fa, ib, fb)
    monkeypatch.setattr(W, "TILE_W", 64)
    monkeypatch.setattr(W, "TILE_H", 16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        W.warp_u8(ia, fa)
    monkeypatch.setattr(W, "FEAT_TILE_W", 24)
    with pytest.raises(RuntimeError, match="CUDA error"):
        W.warp_feat(ia, fa)
    assert W.LAUNCHES == {k: 0 for k in W.LAUNCHES}


RENDER_TILINGS = {  # ops/warp.py's K6 tile (the u8 tile): the default, a
    # small one and a flat wide one; K7 keeps its fixed block
    "default": {},
    "small": {"TILE_W": 16, "TILE_H": 4},
    "wide": {"TILE_W": 128, "TILE_H": 2}}


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past an
    aligned address: the kernels then take their scalar paths."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("tiling", list(RENDER_TILINGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,flows", [
    ((8, 1088, 1920), "smooth"), ((2, 52, 196), "iid"),
    ((2, 52, 196), "iid_small"), ((2, 52, 196), "misaligned"),
    ((2, 33, 61), "smooth")])
def test_render_and_ds4_kernels_bit_exact(cuda_device, monkeypatch, tiling,
                                          shape, flows, dtype):
    """K6 (``warp_render``) and, where H and W divide by 4, K7
    (``warp_ds4_pair``) equal their twins bit for bit (max |d| 0): smooth
    flows that leave the frame, spatially white ones, large and small, and
    operands off K6's vector alignment; W = 196 gives K7 an odd W/4."""
    for name, value in RENDER_TILINGS[tiling].items():
        monkeypatch.setattr(W, name, value)
    if flows in ("smooth", "misaligned"):
        ia, fa, ib, fb, m = inputs(17, *shape, dtype, cuda_device)
    else:
        ia, fa, ib, fb = iid_inputs(18, *shape, dtype, cuda_device,
                                    20.0 if flows == "iid" else 1.5)
        m = inputs(19, *shape, dtype, cuda_device)[4]
    if flows == "misaligned":
        fa, fb, m = misaligned(fa), misaligned(fb), misaligned(m)
    W.reset_launches()
    got = [W.warp_render(ia, fa, ib, fb, m)]
    want = [W.warp_render_ref(ia, fa, ib, fb, m)]
    ds4 = shape[1] % 4 == 0 and shape[2] % 4 == 0
    if ds4:
        got += W.warp_ds4_pair(ia, fa, ib, fb)
        want += W.warp_ds4_pair_ref(ia, fa, ib, fb)
    torch.cuda.synchronize()
    assert launched() == {"warp_render": 1, **({"warp_ds4_pair": 1} if ds4
                                               else {})}
    for g, r in zip(got, want):
        print(f"K6/K7 {tiling} {shape} {flows} max|d| "
              f"{float((g.float() - r.float()).abs().max())}")
        assert g.shape == r.shape and torch.equal(g, r)


def test_render_rejects_bad_tiles(cuda_device, monkeypatch):
    """K6 tiles that are not whole warps, or need more than 256 threads: the
    launch raises and counts nothing."""
    ia, fa, ib, fb, m = inputs(20, 1, 16, 24, torch.float32, cuda_device)
    W.reset_launches()
    monkeypatch.setattr(W, "TILE_W", 10)
    with pytest.raises(RuntimeError, match="CUDA error"):
        W.warp_render(ia, fa, ib, fb, m)
    monkeypatch.setattr(W, "TILE_W", 64)
    monkeypatch.setattr(W, "TILE_H", 16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        W.warp_render(ia, fa, ib, fb, m)
    assert W.LAUNCHES == {k: 0 for k in W.LAUNCHES}


def every_kernel(device):
    """One call of each wrapper on ``device``, from seeded inputs; returns
    the outputs on the CPU."""
    from rife_tpu_torch.ops import conv as CV

    outs = []
    for dtype in (torch.float32, torch.bfloat16):
        ia, fa, ib, fb, m = inputs(21, 2, 64, 96, dtype, device)
        img, flow = feat_inputs(22, 2, 16, 32, 48, dtype, device)
        outs += [*W.warp_pair(ia, fa, ib, fb), W.warp_render(ia, fa, ib, fb, m),
                 *W.warp_ds4_pair(ia, fa, ib, fb), W.warp_ds2(ia, fa),
                 W.warp_u8(ia, fa), W.warp_feat(img, flow),
                 W.warp_feat(img, W.ds4_positions(flow), abs_pos=True)]
        weight = (torch.randn(24, 16, 3, 3, generator=torch.Generator()
                              .manual_seed(23)) * 0.2).to(device, dtype)
        bias = torch.linspace(-1, 1, 24, device=device)
        outs.append(CV.conv3x3([img], weight, bias, stride=2,
                               act=CV.ACT_RELU,
                               weight_tc=CV.pack_weight_tc(weight)))
        raw = (torch.randn(16, 6, 4, 4, generator=torch.Generator()
                           .manual_seed(24)) * 0.2).to(device, dtype)
        outs.append(CV.deconv4x4(img, CV.deconv_phase_weights(raw), bias,
                                 act=CV.ACT_NONE,
                                 weight_t4=CV.pack_weight_t4(raw)))
        outs.append(W.warp_spatial(img, flow[:, :, 8:24].contiguous(), 8,
                                   u8=False, ds4=True))
        wps = (torch.randn(16, 16, 3, 3, generator=torch.Generator()
                           .manual_seed(25)) * 0.2).to(device, dtype)
        outs.append(CV.conv3x3([img], wps, bias[:16].contiguous(),
                               act=CV.ACT_LEAKY,
                               weight_tc=CV.pack_weight_tc(wps), ps=2))
        if dtype == torch.bfloat16:
            outs.append(CV.deconv4x4_xla(img, CV.pack_weight_t4(raw),
                                         bias[:6], act=CV.ACT_RELU))
    torch.cuda.synchronize(device)
    return [o.cpu() for o in outs]


def test_launches_follow_the_tensors_device(cuda_device):
    """A second card's tensors launch there while the thread's current
    device is the first: every wrapper's output equals the first card's, and
    the current device is left as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    torch.cuda.set_device(0)
    first = every_kernel(torch.device("cuda", 0))
    second = every_kernel(torch.device("cuda", 1))
    assert torch.cuda.current_device() == 0
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_kernels_from_several_host_threads(cuda_device):
    """Host threads launching at once (the per-device state of csrc/conv.cu
    is shared under a lock) get what one thread gets."""
    from concurrent.futures import ThreadPoolExecutor

    want = every_kernel(cuda_device)
    with ThreadPoolExecutor(4) as pool:
        runs = list(pool.map(lambda _: every_kernel(cuda_device), range(4)))
    for got in runs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts,cout,stride,act,h,w", [
    ((3,), 32, 2, 3, 1088, 1920),     # contextnet entry
    ((32,), 32, 1, 3, 272, 480),
    ((3, 3, 4), 48, 2, 3, 544, 960),  # flownet block entry (3 parts)
    ((96,), 16, 1, 0, 68, 120),       # deconv phases
    ((5,), 7, 1, 2, 33, 41),          # odd Cin, unaligned width
    ((17, 9), 20, 2, 1, 18, 26),
    ((192,), 16, 1, 3, 40, 64),       # the widest Cin of the v2.3 sites
    ((3,), 48, 1, 3, 30, 62),         # Cout 48, W % 4 != 0
    ((32,), 96, 2, 1, 64, 96),        # two channel groups
    ((7, 3), 128, 2, 2, 22, 36),      # the widest group the gates admit
])
def test_conv_kernel_matches_twin(cuda_device, parts, cout, stride, act, h,
                                  w, dtype):
    from rife_tpu_torch.ops import conv as CV

    rng = np.random.default_rng(9)
    t = lambda a, dt: torch.from_numpy(np.asarray(a, np.float32)).to(  # noqa: E731
        device=cuda_device, dtype=dt).contiguous()
    xs = [t(rng.normal(size=(2, c, h, w)), dtype) for c in parts]
    weight = t(rng.normal(size=(cout, sum(parts), 3, 3)) * 0.2, dtype)
    bias = t(rng.normal(size=cout), torch.float32)
    slope = t(rng.uniform(0, 0.5, cout), torch.float32)
    packed = CV.pack_weight_tc(weight)
    CV.reset_launches()
    got = CV.conv3x3(xs, weight, bias, slope, stride=stride, act=act,
                     weight_tc=packed)
    want = CV.conv3x3_ref(xs, weight, bias, slope, stride=stride, act=act)
    torch.cuda.synchronize()
    assert CV.LAUNCHES == {"conv3x3": 1, "conv3x3_ps": 0, "deconv4x4": 0,
                           "bias_act": 0}
    scale = CV.conv3x3_ref([x.float().abs() for x in xs],
                           weight.float().abs(), stride=stride)
    check(got, want, f32_rel=1e-5, scale=scale)


def deconv_case(seed, b, cin, co, h, w, dtype, device):
    rng = np.random.default_rng(seed)
    t = lambda a, dt: torch.from_numpy(np.asarray(a, np.float32)).to(  # noqa: E731
        device=device, dtype=dt).contiguous()
    x = t(rng.normal(size=(b, cin, h, w)), dtype)
    raw = t(rng.normal(size=(cin, co, 4, 4)) * (1.0 / (2.0 * cin ** 0.5)),
            dtype)
    bias = t(rng.normal(size=co) * 0.3, torch.float32)
    slope = t(rng.uniform(0, 0.5, co), torch.float32)
    return x, raw, bias, slope


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,co,h,w", [
    (32, 4, 68, 120),    # a v2.3 fusionnet deconv site, mini size
    (12, 24, 17, 30),    # W % 4 != 0
    (9, 32, 20, 44),
    (5, 3, 9, 13),
])
def test_deconv_kernel_matches_twin(cuda_device, cin, co, h, w, dtype):
    """A planar deconv site (``deconv4x4``): in bf16 one launch of the
    deconv kernel writes the interleaved phases, bit for bit what the phase
    conv (``conv3x3`` over the phase weights) gives interleaved; in
    f32 the phase conv on the CUDA cores."""
    from rife_tpu_torch.ops import conv as CV

    x, raw, bias, slope = deconv_case(12, 2, cin, co, h, w, dtype,
                                      cuda_device)
    w3 = CV.deconv_phase_weights(raw).contiguous()
    b4, s4 = bias.repeat(4), slope.repeat(4)
    CV.reset_launches()
    got = CV.deconv4x4(x, w3, b4, s4, act=CV.ACT_PRELU,
                       weight_t4=CV.pack_weight_t4(raw))
    want = CV.deconv4x4_ref(x, w3, b4, s4, act=CV.ACT_PRELU)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert {k: v for k, v in CV.LAUNCHES.items() if v} == (
        {"deconv4x4": 1} if bf16 else {"conv3x3": 1})
    check(got, want, f32_rel=1e-5,
          scale=CV.deconv4x4_ref(x.float().abs(), w3.float().abs()))
    if bf16:
        pr9 = CV.interleave_phases(CV.conv3x3(
            [x], w3, b4, s4, act=CV.ACT_PRELU,
            weight_tc=CV.pack_weight_tc(w3)))
        assert torch.equal(got, pr9)


# every 4x4 stride-2 deconv site of a bf16 step of the three families at
# 1080p (v2.3 -u at 4K), at B=2: (cin, O, ps, act, H, W, XLA order)
DECONV_SITES = [
    (192, 24, 2, 0, 34, 60, True), (128, 24, 2, 0, 68, 120, True),   # v4.6
    (96, 24, 2, 0, 136, 240, True), (64, 24, 2, 0, 272, 480, True),
    (384, 4, 1, 0, 34, 60, True), (256, 4, 1, 0, 68, 120, True),     # v2.3
    (192, 4, 1, 0, 136, 240, False), (96, 4, 1, 0, 272, 480, False),
    (1024, 256, 1, 3, 34, 60, True), (512, 128, 1, 3, 68, 120, True),
    (256, 64, 1, 3, 136, 240, True), (128, 32, 1, 3, 272, 480, True),
    (32, 4, 1, 0, 544, 960, False),
    (1024, 256, 1, 3, 68, 120, True), (512, 128, 1, 3, 136, 240, True),
    (256, 64, 1, 3, 272, 480, True), (128, 32, 1, 3, 544, 960, True),  # -u
    (32, 4, 1, 0, 1088, 1920, False),
    (512, 128, 1, 3, 68, 120, True), (256, 64, 1, 3, 136, 240, True),  # v1
    (128, 16, 1, 3, 272, 480, False),
]


def xla_epilogue(base, bias, slope, act, ps):
    """XLA's epilogue on the deconv kernel's own unshuffled sums rounded to
    bf16 (its XLA-order output without bias or activation): the bf16 bias,
    the activation in bf16 (leaky at bf16(0.2)), then the shuffle."""
    from rife_tpu_torch.ops import conv as CV

    F = torch.nn.functional
    y = base + bias.to(base.dtype).reshape(1, -1, 1, 1)
    y = CV.activate_storage(y, act, 0.2, slope)
    return F.pixel_shuffle(y, ps) if ps > 1 else y


@pytest.mark.parametrize("site", DECONV_SITES)
def test_deconv_kernel_at_every_site(cuda_device, site):
    """bf16, B=2: the deconv kernel against its plain version
    (``deconv_t4_ref``) at the conv bar; in XLA's order, which rounds
    twice, the sums (the kernel without bias or activation) are held to
    that bar and the output with them bit for bit to XLA's epilogue applied
    to those sums; in the planar order bit for bit with the phase conv
    interleaved (shuffled), wherever that conv's resident weights fit (Cin
    <= 128)."""
    from rife_tpu_torch.ops import conv as CV

    F = torch.nn.functional
    cin, co, ps, act, h, w, xla = site
    x, raw, bias, slope = deconv_case(cin + co, 2, cin, co, h, w,
                                      torch.bfloat16, cuda_device)
    packed = CV.pack_weight_t4(raw)
    if xla:
        bias, slope = (v.to(torch.bfloat16).float() for v in (bias, slope))
    CV.reset_launches()
    if xla:
        got = CV.deconv4x4_xla(x, packed, bias, slope, act=act, ps=ps)
    else:
        got = CV.deconv4x4(x, None, bias.repeat(4), slope.repeat(4), act=act,
                           weight_t4=packed, ps=ps)
    torch.cuda.synchronize()
    assert {k: v for k, v in CV.LAUNCHES.items() if v} == {"deconv4x4": 1}
    scale = CV.deconv_t4_ref(x.float().abs(), CV.pack_weight_t4(
        raw.float().abs()), ps=ps)
    if xla:
        base = CV.deconv4x4_xla(x, packed)
        check(base, CV.deconv_t4_ref(x, packed, xla=True),
              scale=F.pixel_unshuffle(scale, ps) if ps > 1 else scale)
        assert torch.equal(got, xla_epilogue(base, bias, slope, act, ps))
    else:
        check(got, CV.deconv_t4_ref(x, packed, bias, slope, act=act, ps=ps),
              scale=scale)
    if cin <= 128:
        w3 = CV.deconv_phase_weights(raw).contiguous()
        planar = CV.deconv4x4(x, w3, bias.repeat(4), slope.repeat(4),
                              act=act, weight_t4=packed, ps=ps)
        y = CV.interleave_phases(CV.conv3x3(
            [x], w3, bias.repeat(4), slope.repeat(4), act=act,
            weight_tc=CV.pack_weight_tc(w3)))
        assert torch.equal(planar, F.pixel_shuffle(y, ps) if ps > 1 else y)


def test_deconv_rows_do_not_depend_on_the_window_or_the_batch(cuda_device):
    """The C15 repair: rows of a window of the input (a shard's rows and
    their halo) and items of a B=2 batch come out of the deconv kernel as
    they do from the whole frame and from a B=8 batch, bit for bit, in both
    orders."""
    from rife_tpu_torch.ops import conv as CV

    x, raw, bias, slope = deconv_case(3, 8, 64, 24, 272, 480, torch.bfloat16,
                                      cuda_device)
    packed = CV.pack_weight_t4(raw)
    bq = bias.to(torch.bfloat16).float()
    for run in (lambda t: CV.deconv4x4_xla(t, packed, bq, act=CV.ACT_NONE,
                                           ps=2),
                lambda t: CV.deconv4x4(t, None, bias.repeat(4), act=1,
                                       weight_t4=packed)):
        whole = run(x)
        r = whole.shape[2] // x.shape[2]  # output rows an input row
        for s, e in ((0, 69), (67, 137), (135, 205), (203, 272)):
            win = run(x[:, :, s:e].contiguous())
            lo = 0 if s == 0 else 1  # the halo row above is dropped
            hi = e - s if e == 272 else e - s - 1
            assert torch.equal(win[:, :, r * lo:r * hi],
                               whole[:, :, r * (s + lo):r * (s + hi)])
        assert torch.equal(run(x[2:4].contiguous()), whole[2:4])


# every f32 conv3x3 site of a v2.3 and a v1 1080p step (plan.conv_sites of
# f32 sessions; ps 2: v1's head), at B=2: (parts, cout, stride, act, H, W,
# deconv (cout = 4 O), ps); and the -u step's widest site (its weights are
# not resident)
F32_SITES = [
    ((3, 3, 4), 96, 2, 3, 544, 960, False, 1),                       # v2.3
    ((192,), 16, 1, 0, 136, 240, True, 1),
    ((3, 3, 4), 48, 2, 3, 1088, 1920, False, 1),
    ((96,), 16, 1, 0, 272, 480, True, 1),
    ((3,), 32, 2, 3, 1088, 1920, False, 1),
    ((32,), 32, 1, 3, 544, 960, False, 1),
    ((32,), 32, 2, 3, 544, 960, False, 1),
    ((3, 3, 4), 32, 2, 3, 1088, 1920, False, 1),
    ((32,), 64, 2, 3, 544, 960, False, 1),
    ((32,), 16, 1, 0, 544, 960, True, 1),
    ((3, 3, 2), 90, 2, 3, 544, 960, False, 1),                       # v1
    ((3,), 16, 2, 0, 1088, 1920, False, 1),
    ((16,), 16, 1, 0, 544, 960, False, 1),
    ((16,), 32, 2, 3, 544, 960, False, 1),
    ((8,), 32, 2, 3, 1088, 1920, False, 1),
    ((32,), 32, 1, 0, 544, 960, False, 1),
    ((128,), 64, 1, 3, 272, 480, True, 1),
    ((16,), 16, 1, 0, 544, 960, False, 2),
    ((64, 32, 32), 128, 2, 3, 544, 960, False, 1),                  # -u
]


def f32_site_inputs(seed, parts, cout, deconv, h, w, device, b=2):
    """Seeded f32 inputs of a conv3x3 site: the parts, the weights (OIHW,
    or a deconv's phase weights), what the kernel reads (``weight_tc`` or
    ``weight_t4``), bias and slope (phase-tiled at a deconv site)."""
    from rife_tpu_torch.ops import conv as CV

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(  # noqa: E731
        device).contiguous()
    cin = sum(parts)
    xs = [t(rng.normal(size=(b, c, h, w))) for c in parts]
    if deconv:
        raw = t(rng.normal(size=(cin, cout // 4, 4, 4)) / (2 * cin ** 0.5))
        bias = t(np.tile(rng.normal(size=cout // 4) * 0.3, 4))
        slope = t(np.tile(rng.uniform(0, 0.5, cout // 4), 4))
        return (xs, CV.deconv_phase_weights(raw).contiguous(),
                CV.pack_weight_t4(raw), bias, slope)
    weight = t(rng.normal(size=(cout, cin, 3, 3)) / (3 * cin ** 0.5))
    return (xs, weight, CV.pack_weight_tc(weight), t(rng.normal(size=cout)),
            t(rng.uniform(0, 0.5, cout)))


def f32_call(CV, xs, weight, packed, bias, slope, stride, act, deconv, ps):
    if deconv:
        return CV.deconv4x4(xs[0], weight, bias, slope, act=act,
                            weight_t4=packed, ps=ps)
    return CV.conv3x3(xs, weight, bias, slope, stride=stride, act=act,
                      weight_tc=packed, ps=ps)


@pytest.mark.parametrize("site", F32_SITES)
def test_f32_kernel_at_every_site(cuda_device, site):
    """The f32 kernel at every f32 site, B=2: one launch (a deconv site in
    the deconv mode, which writes the interleaved output), against its twin
    at the f32 bar."""
    from rife_tpu_torch.ops import conv as CV

    parts, cout, stride, act, h, w, deconv, ps = site
    xs, weight, packed, bias, slope = f32_site_inputs(
        sum(parts) + cout + h, parts, cout, deconv, h, w, cuda_device)
    CV.reset_launches()
    got = f32_call(CV, xs, weight, packed, bias, slope, stride, act, deconv,
                   ps)
    torch.cuda.synchronize()
    assert {k: v for k, v in CV.LAUNCHES.items() if v} == {
        "conv3x3_ps" if ps > 1 else "conv3x3": 1}
    if deconv:
        want = CV.deconv4x4_ref(xs[0], weight, bias, slope, act=act, ps=ps)
    else:
        want = CV.conv3x3_ref(xs, weight, bias, slope, stride=stride,
                              act=act, ps=ps)
    check(got, want, f32_rel=1e-5)


@pytest.mark.parametrize("parts,cout,stride,act,h,w,deconv,ps", [
    ((3, 3, 4), 16, 2, 3, 12, 20, False, 1),     # three parts, 16-byte rows
    ((5,), 7, 1, 2, 9, 13, False, 1),            # odd Cin and width: 4-byte
    ((17, 9), 20, 2, 1, 10, 26, False, 1),
    ((32,), 32, 1, 3, 20, 36, False, 1),
    ((32,), 64, 2, 3, 11, 24, False, 1),
    ((3, 3, 2), 90, 2, 3, 8, 12, False, 1),
    ((16,), 16, 1, 0, 10, 16, False, 2),         # v1's head
    ((192,), 16, 1, 3, 6, 8, False, 1),          # the widest Cin
    ((64, 32, 32), 128, 2, 3, 6, 8, False, 1),   # weights streamed by stage
    ((32,), 16, 1, 0, 9, 13, True, 1),           # deconv, odd width
    ((192,), 16, 1, 0, 5, 8, True, 1),
    ((128,), 64, 1, 3, 6, 11, True, 1),
    ((12,), 32, 1, 3, 7, 12, True, 2),           # deconv + PixelShuffle
    ((5,), 12, 1, 2, 9, 13, True, 1),            # O = 3
])
def test_f32_kernel_bit_for_bit_with_the_earlier_order(
        cuda_device, parts, cout, stride, act, h, w, deconv, ps):
    """The f32 kernel bit for bit with the kernel it replaced, whose
    algorithm ``torch_f32_order.conv3x3_serial`` repeats (one fmaf chain
    from +0 an output, input channels ascending, taps ascending; a deconv
    site the phase conv over all nine taps, interleaved), at mini sizes."""
    from torch_f32_order import conv3x3_serial

    from rife_tpu_torch.ops import conv as CV

    F = torch.nn.functional
    xs, weight, packed, bias, slope = f32_site_inputs(
        3 * cout + w, parts, cout, deconv, h, w, cuda_device)
    got = f32_call(CV, xs, weight, packed, bias, slope, stride, act, deconv,
                   ps).cpu()
    np_ = lambda t: t.cpu().numpy()  # noqa: E731
    want = torch.from_numpy(conv3x3_serial(
        [np_(x) for x in xs], np_(weight), np_(bias), np_(slope),
        stride=1 if deconv else stride, act=act))
    if deconv:
        want = CV.interleave_phases(want)
    if ps > 1:
        want = F.pixel_shuffle(want, ps)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("parts", [(3, 3, 4), (3,), (32,), (192,), (5,),
                                   (17, 9)])
@pytest.mark.parametrize("cout,stride", [(32, 1), (48, 2), (7, 2), (96, 1)])
def test_f32_kernel_writes_every_output(cuda_device, parts, cout, stride):
    """One launch of the f32 kernel into an output filled with NaN, at the
    part widths of the plan's CPU test: every output written (no NaN left)
    and equal to the twin at the f32 bar."""
    from rife_tpu_torch.ops import conv as CV

    b, h, w = 2, 37, 70
    xs, weight, packed, bias, slope = f32_site_inputs(
        sum(parts) + cout, parts, cout, False, h, w, cuda_device, b)
    out = torch.full((b, cout, (h - 1) // stride + 1, (w - 1) // stride + 1),
                     float("nan"), device=cuda_device)
    CV._launch(xs, weight, bias, slope, out, stride, CV.ACT_PRELU, 0.2,
               packed)
    torch.cuda.synchronize()
    assert not out.isnan().any()
    check(out, CV.conv3x3_ref(xs, weight, bias, slope, stride=stride,
                              act=CV.ACT_PRELU), f32_rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,cin,cout,stride,h,w", [
    ("conv", 16, 16, 1, 272, 480),   # the v1 fusionnet head, B=2
    ("conv", 8, 64, 1, 33, 61),      # 64 channels: 2-row tiles, odd sizes
    ("conv", 12, 36, 2, 22, 38),     # a part-filled n8 tile, stride 2
    ("conv", 5, 12, 1, 9, 13),       # odd sizes, unaligned rows
    ("deconv", 64, 96, 1, 68, 120),  # v4.6 block tail: 24 channels
    ("deconv", 12, 32, 1, 17, 30),
])
def test_conv_ps_kernel(cuda_device, kind, cin, cout, stride, h, w, dtype):
    """B4 (``ps=2``): one launch, bit for bit the unshuffled output
    shuffled, and against its twin at the conv bar; the conv form counts as
    ``conv3x3_ps`` (in bf16 B4's conv kernel, whose sums run in the plain
    kernel's order, so only the write addresses move), the deconv form in
    bf16 as ``deconv4x4`` (the deconv kernel), in f32 as ``conv3x3_ps``
    (the phase conv)."""
    from rife_tpu_torch.ops import conv as CV

    F = torch.nn.functional
    rng = np.random.default_rng(cin + cout)
    t = lambda a, dt: torch.from_numpy(np.asarray(a, np.float32)).to(  # noqa: E731
        device=cuda_device, dtype=dt).contiguous()
    x = t(rng.normal(size=(2, cin, h, w)), dtype)
    if kind == "deconv":
        raw = t(rng.normal(size=(cin, cout // 4, 4, 4)) * 0.3, dtype)
        weight = CV.deconv_phase_weights(raw).contiguous()
    else:
        weight = t(rng.normal(size=(cout, cin, 3, 3)) * 0.2, dtype)
    # a deconv has one bias and slope an output channel: the phase form
    # tiles them 4x (deconv_phase_weights), and the kernel reads the first O
    reps = 4 if kind == "deconv" else 1
    bias = t(np.tile(rng.normal(size=cout // reps), reps), torch.float32)
    slope = t(np.tile(rng.uniform(0, 0.5, cout // reps), reps),
              torch.float32)
    if kind == "deconv":
        packed = CV.pack_weight_t4(raw)

        def run(ps):
            return CV.deconv4x4(x, weight, bias, slope, act=CV.ACT_PRELU,
                                weight_t4=packed, ps=ps)
        want = CV.deconv4x4_ref(x, weight, bias, slope, act=CV.ACT_PRELU,
                                ps=2)
        scale = CV.deconv4x4_ref(x.float().abs(), weight.float().abs(),
                                 ps=2)
    else:
        packed = CV.pack_weight_tc(weight)

        def run(ps):
            return CV.conv3x3([x], weight, bias, slope, stride=stride,
                              act=CV.ACT_PRELU, weight_tc=packed, ps=ps)
        want = CV.conv3x3_ref([x], weight, bias, slope, stride=stride,
                              act=CV.ACT_PRELU, ps=2)
        scale = CV.conv3x3_ref([x.float().abs()], weight.float().abs(),
                               stride=stride, ps=2)
    CV.reset_launches()
    got = run(2)
    torch.cuda.synchronize()
    counter = ("deconv4x4" if kind == "deconv" and dtype == torch.bfloat16
               else "conv3x3_ps")
    assert {k: v for k, v in CV.LAUNCHES.items() if v} == {counter: 1}
    assert torch.equal(got, F.pixel_shuffle(run(1), 2))
    check(got, want, f32_rel=1e-5, scale=scale)


@pytest.mark.parametrize("w", [96, 75])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cin,cout", [(16, 16), (24, 64), (64, 16),
                                      (16, 64)])
def test_conv_ps_kernel_every_shape(cuda_device, cin, cout, stride, w):
    """B4's conv kernel (``csrc/conv_ps.cu``) over the gate's range: stride
    1 and 2, Cin 16/24/64, Cout 16/64, every activation, W % 8 == 0 (TMA)
    and an odd W (the per-thread branch), B = 8 and 1: one launch a call,
    at the conv bar against its twin, bit for bit with the plain kernel
    shuffled, and the rows of the B=1 launch byte for byte those of the
    B=8 launch."""
    from rife_tpu_torch.ops import conv as CV

    F = torch.nn.functional
    rng = np.random.default_rng(cin * cout + stride * w)
    t = lambda a, dt: torch.from_numpy(np.asarray(a, np.float32)).to(  # noqa: E731
        device=cuda_device, dtype=dt).contiguous()
    x = t(rng.normal(size=(8, cin, 38, w)), torch.bfloat16)
    weight = t(rng.normal(size=(cout, cin, 3, 3)) * 0.2, torch.bfloat16)
    bias = t(rng.normal(size=cout), torch.float32)
    slope = t(rng.uniform(0, 0.5, cout), torch.float32)
    packed = CV.pack_weight_tc(weight)
    scale = CV.conv3x3_ref([x.float().abs()], weight.float().abs(),
                           stride=stride, ps=2)
    for act in (CV.ACT_NONE, CV.ACT_RELU, CV.ACT_LEAKY, CV.ACT_PRELU):
        def run(xs, ps=2):
            return CV.conv3x3([xs], weight, bias, slope, stride=stride,
                              act=act, alpha=0.1, weight_tc=packed, ps=ps)
        CV.reset_launches()
        got = run(x)
        torch.cuda.synchronize()
        assert {k: v for k, v in CV.LAUNCHES.items() if v} == {
            "conv3x3_ps": 1}
        want = CV.conv3x3_ref([x], weight, bias, slope, stride=stride,
                              act=act, alpha=0.1, ps=2)
        check(got, want, f32_rel=1e-5, scale=scale)
        assert torch.equal(got, F.pixel_shuffle(run(x, ps=1), 2))
        one = run(x[5:6].contiguous())
        assert torch.equal(one, got[5:6])


def test_v1_f32_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """The v1 reconstruction with every admissible conv site on the kernels
    (size gates lowered to 0; the ConvPS head on B4): the card matches the
    CPU session, launches as the plan says."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites
    from rife_tpu_torch.models.v1_arch import write_v1_params
    from rife_tpu_torch.ops import conv as CV

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    d = write_v1_params(tmp_path, (8, 8, 8, 4))
    a, b = frames(64, 96)
    ts = np.full(2, 0.5, np.float32)
    want = RIFE(str(d), device="cpu").process_batch(a, b, ts)
    sess = RIFE(str(d), device=cuda_device, dtype=torch.float32)
    W.reset_launches()
    CV.reset_launches()
    got = sess.process_batch(a, b, ts)
    counts = {k: v for k, v in {**W.LAUNCHES, **CV.LAUNCHES}.items() if v}
    assert counts == kernel_sites(sess, 64, 96)
    # the three flownet block heads and the fusionnet's head, at mini widths
    assert counts["conv3x3_ps"] == 4
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_failed_launch_raises(cuda_device):
    """A launch the card refuses raises (f32: an empty batch; bf16: the
    weights do not fit in shared memory), and one without its packed
    weights is refused before it; nothing runs a twin in its place."""
    from rife_tpu_torch.ops import conv as CV

    x = torch.zeros(70000, 1, 2, 2, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        W.warp_feat(x, torch.zeros(70000, 2, 2, 2, device=cuda_device))
    CV.reset_launches()
    w32 = torch.zeros(256, 1, 3, 3, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        CV.conv3x3([torch.zeros(0, 1, 2, 2, device=cuda_device)], w32,
                   weight_tc=CV.pack_weight_tc(w32))
    with pytest.raises(ValueError, match="weight_tc"):
        CV.conv3x3([torch.zeros(2, 1, 2, 2, device=cuda_device)], w32)
    assert CV.LAUNCHES == {"conv3x3": 0, "conv3x3_ps": 0, "deconv4x4": 0,
                           "bias_act": 0}
    bf = dict(device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(64, 512, 3, 3, **bf)
    with pytest.raises(RuntimeError, match="CUDA error"):
        CV.conv3x3([torch.zeros(1, 512, 8, 8, **bf)], w,
                   weight_tc=CV.pack_weight_tc(w))
    with pytest.raises(ValueError, match="weight_tc"):
        CV.conv3x3([torch.zeros(1, 512, 8, 8, **bf)], w)
    assert CV.LAUNCHES == {"conv3x3": 0, "conv3x3_ps": 0, "deconv4x4": 0,
                           "bias_act": 0}
    # the deconv kernel: bf16 only (f32 keeps its routes), its activations,
    # a PixelShuffle of 2 and whole 2x2 blocks, the packed weights
    raw = torch.zeros(8, 6, 4, 4, **bf)
    x = torch.zeros(1, 8, 4, 4, **bf)
    with pytest.raises(TypeError, match="bf16"):
        CV.deconv4x4_xla(x.float(), CV.pack_weight_t4(raw.float()))
    with pytest.raises(ValueError, match="activation"):
        CV.deconv4x4_xla(x, CV.pack_weight_t4(raw), act=7)
    with pytest.raises(ValueError, match="PixelShuffle"):
        CV.deconv4x4_xla(x, CV.pack_weight_t4(raw), ps=2)
    with pytest.raises(ValueError, match="weight_t4"):
        CV.deconv4x4(x, None, weight_t4=None)
    with pytest.raises(ValueError, match="slope"):
        CV.deconv4x4_xla(x, CV.pack_weight_t4(raw), act=CV.ACT_PRELU)
    assert CV.LAUNCHES == {"conv3x3": 0, "conv3x3_ps": 0, "deconv4x4": 0,
                           "bias_act": 0}
    # S: rows outside the source, a 1/4 warp of rows not divisible by 4
    W.reset_launches()
    img = torch.zeros(1, 3, 16, 16, **bf)
    with pytest.raises(ValueError, match="outside"):
        W.warp_spatial(img, torch.zeros(1, 2, 8, 16, **bf), 12, u8=True)
    with pytest.raises(ValueError, match="divisible by 4"):
        W.warp_spatial(img, torch.zeros(1, 2, 6, 16, **bf), 4, u8=True,
                       ds4=True)
    assert W.LAUNCHES["warp_spatial"] == 0


def test_failed_build_raises_on_cuda(cuda_device, tmp_path, monkeypatch):
    """A source that does not compile makes the first kernel call raise."""
    from rife_tpu_torch.native import build

    (tmp_path / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(build, "OBJ_DIR", tmp_path / "obj")
    monkeypatch.setattr(build, "LIB_PATH", tmp_path / "lib.so")
    monkeypatch.setattr(build, "_lib", None)
    img, flow = feat_inputs(10, 1, 4, 8, 8, torch.float32, cuda_device)
    with pytest.raises(build.BuildError, match="nvcc failed"):
        W.warp_feat(img, flow)


@pytest.fixture(scope="module")
def v23_dir(tmp_path_factory):
    from rife_tpu_torch.models.v23_arch import write_v23_params

    return write_v23_params(tmp_path_factory.mktemp("cuda23"), (8, 8, 8, 8, 4))


def test_v23_slice_f32_matches_cpu(cuda_device, v23_dir, monkeypatch):
    """Every conv site the channel gates admit runs conv3x3 (size gates
    lowered to 0); the card matches the CPU session and launches each
    kernel as often as plan.kernel_sites says."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites
    from rife_tpu_torch.ops import conv as CV

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    a, b = frames(64, 96)
    ts = np.full(2, 0.5, np.float32)
    want = RIFE(str(v23_dir), device="cpu").process_batch(a, b, ts)
    sess = RIFE(str(v23_dir), device=cuda_device, dtype=torch.float32)
    W.reset_launches()
    CV.reset_launches()
    got = sess.process_batch(a, b, ts)
    assert {**launched(), **{k: v for k, v in CV.LAUNCHES.items() if v}} \
        == kernel_sites(sess, 64, 96)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 68, 260), (2, 52, 196),
                                   (1, 1088, 1920), (1, 1920, 1088),
                                   (2, 1088, 1920), (1, 54, 198), (3, 2, 4),
                                   (1, 2, 2)])
def test_warp_ds2_kernel_matches_twin(cuda_device, shape, dtype):
    """K3 bit for bit with its twin: the step's shapes, B=1, the transposed
    geometry, odd H/2 and W/2 (1x54x198 -> 27x99), the smallest grids."""
    ia, fa, _, _, _ = inputs(11, *shape, dtype, cuda_device)
    W.reset_launches()
    got = W.warp_ds2(ia, fa)
    want = W.warp_ds2_ref(ia, fa)
    torch.cuda.synchronize()
    assert launched() == {"warp_ds2": 1}
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="even"):
        W.warp_ds2(ia[..., :-1].contiguous(), fa[..., :-1].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 52, 196), (1, 54, 198)])
def test_warp_ds2_kernel_unaligned_flow(cuda_device, shape, dtype):
    """A flow one element off its 2-element alignment takes the kernel's
    scalar flow loads: still bit for bit with the twin."""
    ia, fa, _, _, _ = inputs(12, *shape, dtype, cuda_device)
    buf = torch.empty(fa.numel() + 1, device=cuda_device, dtype=dtype)
    odd = buf[1:].view(fa.shape)
    odd.copy_(fa)
    assert odd.is_contiguous() and odd.data_ptr() % (2 * odd.element_size())
    got = W.warp_ds2(ia, odd)
    torch.cuda.synchronize()
    assert torch.equal(got, W.warp_ds2_ref(ia, fa))


def test_uhd_f32_matches_cpu(cuda_device, v23_dir, monkeypatch):
    """``-u`` (with ``-x -z``) on the card against the CPU session, every
    admissible conv site on conv3x3: the UHD flownet launches only float
    warps, and the launches equal plan.kernel_sites."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites
    from rife_tpu_torch.ops import conv as CV

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    a, b = frames(50, 110)
    ts = np.full(2, 0.5, np.float32)
    for kw in ({}, {"tta_mode": True, "tta_temporal_mode": True,
                    "fuse_ds2": True}):
        want = RIFE(str(v23_dir), device="cpu", uhd_mode=True,
                    **kw).process_batch(a, b, ts)
        sess = RIFE(str(v23_dir), device=cuda_device, dtype=torch.float32,
                    uhd_mode=True, **kw)
        W.reset_launches()
        CV.reset_launches()
        got = sess.process_batch(a, b, ts)
        counts = {k: v for k, v in {**W.LAUNCHES, **CV.LAUNCHES}.items()
                  if v}
        assert counts == kernel_sites(sess, 50, 110)
        assert set(counts) == {"warp_feat", "warp_u8", "conv3x3",
                               "bias_act"}
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("model", ["v4.6", "v2.3"])
def test_tta_fused_f32_matches_cpu(cuda_device, model_dir, v23_dir, model,
                                   monkeypatch):
    """``-x -z`` with ``fuse_ds2`` on the card against the CPU session;
    launches per step equal plan.kernel_sites, K3 among them."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites
    from rife_tpu_torch.ops import conv as CV

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    d = str(model_dir if model == "v4.6" else v23_dir)
    kw = {"tta_mode": True, "tta_temporal_mode": True, "fuse_ds2": True}
    a, b = frames(50, 70)
    ts = np.full(2, 0.5, np.float32)
    want = RIFE(d, device="cpu", **kw).process_batch(a, b, ts)
    sess = RIFE(d, device=cuda_device, dtype=torch.float32, **kw)
    W.reset_launches()
    CV.reset_launches()
    got = sess.process_batch(a, b, ts)
    counts = {k: v for k, v in {**W.LAUNCHES, **CV.LAUNCHES}.items() if v}
    assert counts == kernel_sites(sess, 50, 70) and counts["warp_ds2"] == 8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_runner_pinned_path_matches_sync_path(cuda_device, model_dir,
                                              tmp_path, monkeypatch):
    """The runner's CUDA path (pinned slots, upload on the compute stream,
    download on a side stream, two batches in flight per session) writes
    the same bytes as its sync path (``process_batch``), with two bf16
    sessions on one queue over several batches each.  Every slot is
    poisoned as it is released, so a row read after its release, or a slot
    refilled before its download completed, would show in the outputs or
    as a stage error."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.io import runner as R
    from rife_tpu_torch.io.image import decode_image, encode_image

    rng = np.random.default_rng(8)
    ind = tmp_path / "in"
    ind.mkdir()
    paths = []
    for i in range(13):
        paths.append(str(ind / f"{i:03d}.png"))
        encode_image(paths[-1], rng.integers(0, 256, (64, 96, 3), np.uint8))
    sessions = [RIFE(str(model_dir), device=cuda_device) for _ in range(2)]
    assert all(s.dtype == torch.bfloat16 for s in sessions)

    launched, poisoned = [], []
    real_launch, real_release = R._CudaStaging.launch, R._CudaStaging.release

    def launch(self, slot, ts):
        assert slot.in0.is_pinned() and slot.out.is_pinned()
        launched.append(slot.in0.shape[0])
        real_launch(self, slot, ts)

    def release(self, slot):
        for t in (slot.in0, slot.in1, slot.out):
            t.numpy().fill(0xAB)  # the slots are inference tensors
        poisoned.append(slot)
        real_release(self, slot)

    monkeypatch.setattr(R._CudaStaging, "launch", launch)
    monkeypatch.setattr(R._CudaStaging, "release", release)
    outs = {}
    for tag, pinned in (("sync", False), ("pinned", True)):
        outd = tmp_path / tag
        outd.mkdir()
        tasks = [R.Task(id=i, in0_path=paths[i], in1_path=paths[i + 1],
                        out_path=str(outd / f"{i:03d}.png"),
                        timestep=(0.5, 0.25, 0.7)[i % 3])
                 for i in range(len(paths) - 1)]
        runner = R.PipelineRunner(
            [s.process_batch for s in sessions], batch_size=[3, 3],
            jobs_load=2, jobs_save=2,
            device_fns=([s.process_batch_device for s in sessions]
                        if pinned else None),
            devices=[s.device for s in sessions])
        assert runner.run(tasks) == []
        outs[tag] = {n: decode_image(outd / n)
                     for n in sorted(os.listdir(outd))}
    assert len(outs["sync"]) == 12 and outs["sync"].keys() == outs[
        "pinned"].keys()
    for name in outs["sync"]:
        np.testing.assert_array_equal(outs["pinned"][name], outs["sync"][name])
    # every step ran at its session's B; every slot was released once
    assert launched and set(launched) == {3}
    assert len(poisoned) == len(launched)


# --- parallel/sharding.py on the card ----------------------------------------

def _counts():
    from rife_tpu_torch.ops import conv as CV

    return {k: v for k, v in {**W.LAUNCHES, **CV.LAUNCHES}.items() if v}


def _reset():
    from rife_tpu_torch.ops import conv as CV

    W.reset_launches()
    CV.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u8,ds4", [(True, False), (False, False),
                                    (True, True), (False, True)])
def test_sharded_warp_rows_equal_the_unsharded_kernel(cuda_device, u8, ds4,
                                                      dtype):
    """warp_spatial (S: the positions computed in the kernel from a shard's
    flow rows and row0) gives each shard's rows of the unsharded kernel's
    output bit for bit, and equals its twin, one launch a shard; the rows
    include a boundary at row 4 and one at row 124 (row0 on a multiple of
    4 near either edge), and the flows leave the frame."""
    b, h, w = 2, 128, 200
    ia, fa, _, _, _ = inputs(11, b, h, w, dtype, cuda_device)
    img = ia if u8 else ia.repeat(1, 3, 1, 1).contiguous()  # C = 9
    ref = W.warp_u8 if u8 else W.warp_feat
    whole = (W.half_sum2(ref(img, W.ds4_positions(fa), abs_pos=True))
             if ds4 else ref(img, fa))
    W.reset_launches()
    k = 4 if ds4 else 1
    bounds = ((0, 4), (4, 32), (32, 96), (96, 124), (124, 128))
    for s, e in bounds:
        rows = fa[:, :, s:e].contiguous()
        got = W.warp_spatial(img, rows, s, u8=u8, ds4=ds4)
        assert torch.equal(got, whole[:, :, s // k:e // k])
        assert torch.equal(got, W.warp_spatial_ref(img.cpu(), rows.cpu(), s,
                                                   u8=u8, ds4=ds4).to(
                                                       got.device))
    assert {k: v for k, v in W.LAUNCHES.items() if v} == {
        "warp_spatial": len(bounds)}


def test_batch_sharding_on_one_card_twice(cuda_device, model_dir):
    """[cuda:0, cuda:0] at B=4 equals a session at B=2 per shard, bit for
    bit, and launches the plan's kernels once per data shard."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.parallel.sharding import ShardedRIFE, make_mesh

    dev = torch.device("cuda", 0)
    sess = RIFE(str(model_dir), device=dev)
    sharded = ShardedRIFE(sess, make_mesh([dev, dev]))
    a = np.concatenate([frames(64, 96, seed=s)[0] for s in (1, 2)])
    b = np.concatenate([frames(64, 96, seed=s)[1] for s in (1, 2)])
    ts = np.linspace(0.2, 0.8, 4).astype(np.float32)
    _reset()
    got = sharded.process_batch(a, b, ts)
    assert _counts() == sharded.kernel_sites(64, 96)
    want = np.concatenate([sess.process_batch(a[:2], b[:2], ts[:2]),
                           sess.process_batch(a[2:], b[2:], ts[2:])])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_height_sharding_on_one_card(cuda_device, v23_dir, monkeypatch,
                                     mesh):
    """v2.3, f32, every admissible conv site on conv3x3: four shards of
    cuda:0 against the unsharded session on the card (u8 <= 1, >= 99.9%
    exact), launches as the plan says, no fused warp."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.ops import conv as CV
    from rife_tpu_torch.parallel.sharding import ShardedRIFE, make_mesh_2d

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    dev = torch.device("cuda", 0)
    sess = RIFE(str(v23_dir), device=dev, dtype=torch.float32)
    sharded = ShardedRIFE(sess, make_mesh_2d(*mesh, [dev] * 4),
                          height_axis="spatial")
    a, b = frames(128, 96)
    ts = np.full(2, 0.5, np.float32)
    _reset()
    got = sharded.process_batch(a, b, ts)
    counts = _counts()
    assert counts == sharded.kernel_sites(128, 96)
    assert counts["warp_spatial"] > 0 and not {
        "warp_pair", "warp_ds4_pair", "warp_render", "warp_ds2", "warp_u8",
        "warp_feat"} & set(counts)
    per = 2 // mesh[0]
    want = np.concatenate([sess.process_batch(a[i:i + per], b[i:i + per],
                                              ts[:per])
                           for i in range(0, 2, per)])
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_sharding_over_two_cards(cuda_device, model_dir):
    """Two cards: batch sharding equals a session at the shard batch on
    cuda:0, and height sharding over [cuda:0, cuda:1] equals the same mesh
    on cuda:0 named twice, bit for bit (the same kernels on the same
    rows)."""
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.parallel.sharding import (ShardedRIFE, make_mesh,
                                                  make_mesh_2d)

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    sess = RIFE(str(model_dir), device=two[0])
    a, b = frames(128, 96, seed=4)
    ts = np.full(2, 0.5, np.float32)
    got = ShardedRIFE(sess, make_mesh(two)).process_batch(a, b, ts)
    want = np.concatenate([sess.process_batch(a[i:i + 1], b[i:i + 1],
                                              ts[:1]) for i in range(2)])
    assert np.array_equal(got, want)
    spread = ShardedRIFE(sess, make_mesh_2d(1, 2, two),
                         height_axis="spatial").process_batch(a, b, ts)
    one = ShardedRIFE(sess, make_mesh_2d(1, 2, [two[0]] * 2),
                      height_axis="spatial").process_batch(a, b, ts)
    assert np.array_equal(spread, one)


def test_trace_records_the_hand_kernels(cuda_device, tmp_path):
    """``utils/profiling.trace`` on the card: the Chrome trace names the
    ctypes-launched kernel by its CUDA symbol, once a launch."""
    import json

    from rife_tpu_torch.utils.profiling import trace

    img, flow = inputs(3, 2, 64, 96, torch.float32, cuda_device)[:2]
    W.warp_feat(img, flow)  # build and load before the window
    torch.cuda.synchronize()
    with trace(str(tmp_path)):
        for _ in range(2):
            W.warp_feat(img, flow)
    (path,) = tmp_path.glob("*.pt.trace.json")
    kernels = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    assert sum("warp_gather_kernel" in k for k in kernels) == 2, kernels


@pytest.mark.parametrize("name", ["rife-v4.6", "rife-v2.3"])
def test_calibration_evals_match_the_cpu(cuda_device, model_dir, v23_dir,
                                         name):
    """``models/calibrate.py`` on the card (f32, TF32 off within its scope)
    against the CPU at the baked scale: flow std within 1e-3 relative, u8
    output std within 0.05; element by element, the flow tap within 1e-3
    px and the u8 frame within 1 (the smoke's bars at 544x960); the TF32
    settings are restored after."""
    from rife_tpu_torch.graph.weights import SYNTHETIC_FLOWNET_SCALE
    from rife_tpu_torch.models import calibrate as cal

    mdir = str(model_dir if name == "rife-v4.6" else v23_dir)
    rng = np.random.default_rng(5)
    frames = tuple(rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
                   for _ in range(2))
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    s = SYNTHETIC_FLOWNET_SCALE[name]
    got, want = (cal.make_flownet_eval(mdir, frames, dev)(s)
                 for dev in (cuda_device, "cpu"))
    assert abs(got - want) <= 1e-3 * want, (got, want)
    fus = [cal.make_fusionnet_eval(mdir, frames, dev)[0]
           for dev in (cuda_device, "cpu")]
    if name != "rife-v4.6":
        got, want = (f(1.0) for f in fus)
        assert abs(got - want) <= 0.05, (got, want)
    got, want = (cal.make_flownet_tap(mdir, frames, dev)(s).cpu()
                 for dev in (cuda_device, "cpu"))
    assert float((got - want).abs().max()) <= 1e-3
    steps = [cal.make_fusionnet_step(mdir, frames, dev)[0]
             for dev in (cuda_device, "cpu")]
    if name != "rife-v4.6":
        got, want = (f(1.0).cpu().int() for f in steps)
        assert int((got - want).abs().max()) <= 1
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == prev
