"""K3, the fused u8-origin warp + 1/2 downsample (``warp_ds2``), and the
``fuse_ds2`` switch that puts it on the path.

* The twin against the Pallas kernel ``warp_ds2_pallas`` run under
  ``pltpu.force_tpu_interpret_mode`` (as tests/test_warp_pallas.py does), at
  (2,16,256,3), flows x6 and x60 (the second clamps at every edge).  bf16:
  bit-identical.  f32: max |d| <= 2**-23 (one f32 ulp at 1.0), because XLA
  on the CPU contracts the interpret-mode kernel's multiply-adds into FMAs
  and regroups its f32 epilogue (the Pallas kernel then differs in the same
  way from its own full-resolution warp followed by the 0.5/0.5 averages);
  the twin and the CUDA kernel round every operation.  On flows on a
  1/4-pixel grid the warp's products and sums are exact, and the f32 twin is
  bit-identical to the Pallas full-resolution u8 warp followed by the
  averages in numpy.
* The ``rife.WarpDs2`` op: a u8 frame copy with even H and W goes to
  ``warp_ds2``; any other image to the unfused warp + ``resize2d``.
* ``fuse_ds2=True`` against ``fuse_ds2=False`` in the port: bit-identical
  u8 output on both models (K3's twin is the composition of the twins the
  unfused graph runs), and against ``rife_tpu`` built with
  ``RIFE_TPU_FUSE_DS2=1``: u8 max |d| <= 1 and >= 99.9% exact (the JAX
  package runs the XLA ``warp_at`` form on the CPU; tests/test_torch_session.py
  explains the bar).
* The plan: the fused plain steps at 1080p.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rife_tpu.ops.warp_pallas import warp_ds2_pallas
from rife_tpu_torch import RIFE
from rife_tpu_torch.engine import plan
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.models.v46_arch import write_flownet_param
from rife_tpu_torch.ops import launch as L
from rife_tpu_torch.ops import torch_ops
from rife_tpu_torch.ops import warp as W
from torch_other_device import elsewhere

SHAPE = (2, 16, 256)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SIZES = [(64, 96), (50, 70)]
MINI = {"v4.6": (16, 16, 16, 16), "v2.3": (8, 8, 8, 8, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Mini-width tensors gain nothing from torch's thread pool, and the
    suite runs several test processes at once: one thread each keeps them
    from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ds2_inputs(seed, scale, quantum=None):
    """u8-valued image (B,H,W,3) and a flow (B,H,W,2), numpy NHWC."""
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 256, (*SHAPE, 3)) / 255.0).astype(np.float32)
    flow = (rng.normal(size=(*SHAPE, 2)) * scale).astype(np.float32)
    if quantum:
        flow = (np.round(flow / quantum) * quantum).astype(np.float32)
    return img, flow


def nchw(x, td):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(td)


def pallas_and_twin(img, flow, dtype):
    jd, td = DTYPES[dtype]
    with pltpu.force_tpu_interpret_mode():
        ref = warp_ds2_pallas(jnp.asarray(img).astype(jd),
                              jnp.asarray(flow).astype(jd))
    got = W.warp_ds2_ref(nchw(img, td), nchw(flow, td))
    b, h, w = SHAPE
    assert got.shape == (b, 3, h // 2, w // 2) and got.dtype == td
    return (np.asarray(ref, np.float32),
            got.float().permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("scale", [6, 60])
def test_twin_bit_identical_to_pallas_bf16(scale):
    ref, got = pallas_and_twin(*ds2_inputs(1, scale), "bf16")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scale", [6, 60])
def test_twin_matches_pallas_f32(scale):
    ref, got = pallas_and_twin(*ds2_inputs(2, scale), "f32")
    assert np.abs(got - ref).max() <= 2.0 ** -23


@pytest.mark.parametrize("scale", [6, 60])
def test_twin_bit_identical_to_pallas_warp_f32_on_quarter_pixel_flows(scale):
    from rife_tpu.ops.warp_pallas import warp_pallas

    img, flow = ds2_inputs(3, scale, quantum=0.25)
    with pltpu.force_tpu_interpret_mode():
        full = np.asarray(warp_pallas(jnp.asarray(img), jnp.asarray(flow),
                                      u8_origin=True, u8_variant="slab"))
    half = np.float32(0.5)
    rows = full[:, 0::2] * half + full[:, 1::2] * half
    want = rows[:, :, 0::2] * half + rows[:, :, 1::2] * half
    got = W.warp_ds2_ref(nchw(img, torch.float32), nchw(flow, torch.float32))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_twin_is_warp_then_half_downsample():
    """The twin equals the unfused pair the graph runs without the switch:
    ``warp_u8_ref`` then ``torch_ops.resize2d`` to (H/2, W/2)."""
    img, flow = ds2_inputs(4, 6)
    for _, td in DTYPES.values():
        i, f = nchw(img, td), nchw(flow, td)
        want = torch_ops.resize2d(W.warp_u8_ref(i, f), SHAPE[1] // 2,
                                  SHAPE[2] // 2)
        assert torch.equal(W.warp_ds2_ref(i, f), want)


def test_cpu_wrapper_takes_twin_without_counting():
    i, f = (nchw(x, torch.float32) for x in ds2_inputs(5, 6))
    W.reset_launches()
    assert torch.equal(W.warp_ds2(i, f), W.warp_ds2_ref(i, f))
    assert W.LAUNCHES["warp_ds2"] == 0


def test_non_cpu_tensors_never_take_the_twin(monkeypatch):
    """A meta tensor (a plan's) takes the kernel's branch: its checks, its
    output and its count, and launches nothing; any other device raises
    there rather than fall back."""
    def twin(*args):
        raise AssertionError("the twin ran on a meta tensor")

    monkeypatch.setattr(W, "warp_ds2_ref", twin)
    img = torch.empty(1, 3, 8, 8, device="meta")
    flow = torch.empty(1, 2, 8, 8, device="meta")
    with L.planning("cuda") as calls:
        out = W.warp_ds2(img, flow)
        with pytest.raises(ValueError, match="even H and W"):
            W.warp_ds2(torch.empty(1, 3, 7, 8, device="meta"),
                       torch.empty(1, 2, 7, 8, device="meta"))
    assert calls == [("warp_ds2", None)]
    assert out.device.type == "meta" and out.shape == (1, 3, 4, 4)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        W.warp_ds2(elsewhere(1, 3, 8, 8), elsewhere(1, 2, 8, 8))


class _Node:
    type = "rife.WarpDs2"
    name = "interp2_warp__part0__fused"
    bottoms = ["img", "flow"]
    tops = ["out"]


def _route(monkeypatch, image, flow, u8_blobs):
    """Run ``_op_warp_ds2``; return (which wrappers it called, result)."""
    called = []
    for name in ("warp_ds2", "warp_u8", "warp_feat"):
        real = getattr(W, name)
        monkeypatch.setattr(W, name, lambda *a, _r=real, _n=name, **k:
                            called.append(_n) or _r(*a, **k))
    out = torch_ops.OP_TABLE["rife.WarpDs2"](
        _Node(), [image, flow], None, {"u8_image_blobs": u8_blobs})[0]
    return called, out


def test_op_sends_a_frame_copy_to_k3(monkeypatch):
    img, flow = (nchw(x, torch.float32) for x in ds2_inputs(6, 6))
    called, out = _route(monkeypatch, img, flow, frozenset(["img"]))
    assert called == ["warp_ds2"]
    assert torch.equal(out, W.warp_ds2_ref(img, flow))


def test_op_takes_the_unfused_branch_off_k3(monkeypatch):
    """Not a frame copy (u8 gate off), or not 3 channels: the float warp,
    then resize2d; odd H: the u8 warp, then resize2d."""
    img, flow = (nchw(x, torch.float32) for x in ds2_inputs(7, 6))
    h, w = SHAPE[1], SHAPE[2]
    called, out = _route(monkeypatch, img, flow, frozenset())
    assert called == ["warp_feat"]
    assert torch.equal(out, torch_ops.resize2d(W.warp_feat_ref(img, flow),
                                               h // 2, w // 2))
    feat = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 5, h, w)).astype(np.float32))
    called, out = _route(monkeypatch, feat, flow, frozenset(["img"]))
    assert called == ["warp_feat"] and out.shape == (2, 5, h // 2, w // 2)
    resized = []
    monkeypatch.setattr(torch_ops, "resize2d",
                        lambda x, oh, ow: resized.append((oh, ow)) or x)
    odd_img, odd_flow = img[:, :, :15].contiguous(), flow[:, :, :15]
    called, _ = _route(monkeypatch, odd_img, odd_flow, frozenset(["img"]))
    assert called == ["warp_u8"] and resized == [(round(7.5), w // 2)]


def frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, h, w, 3), np.uint8),
            rng.integers(0, 256, (2, h, w, 3), np.uint8))


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds2")
    return {"v4.6": write_flownet_param(root, MINI["v4.6"]),
            "v2.3": write_v23_params(root, MINI["v2.3"])}


@pytest.fixture(scope="module")
def jax_fused(model_dirs):
    """rife_tpu built with RIFE_TPU_FUSE_DS2=1, once per module:
    {(model, h, w): u8}."""
    from rife_tpu.engine.session import RIFE as JaxRIFE

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RIFE_TPU_FUSE_DS2", "1")
        refs = {m: JaxRIFE(str(d)) for m, d in model_dirs.items()}
    for m, ref in refs.items():
        kinds = [n.type for n in ref.executors["flownet"].graph.nodes]
        assert kinds.count("rife.WarpDs2") == 2
        for h, w in SIZES:
            out[(m, h, w)] = ref.process_batch(*frames(h, w),
                                               np.full(2, 0.5, np.float32))
    return out


def assert_u8_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


@pytest.mark.parametrize("model", ["v4.6", "v2.3"])
def test_fuse_ds2_is_exact(model_dirs, model):
    fused = RIFE(str(model_dirs[model]), device="cpu", fuse_ds2=True)
    plain = RIFE(str(model_dirs[model]), device="cpu")
    kinds = [n.type for n in fused.executors["flownet"].graph.nodes]
    assert kinds.count("rife.WarpDs2") == 2
    assert "rife.WarpDs2" not in {
        n.type for n in plain.executors["flownet"].graph.nodes}
    for size in SIZES:
        a, b = frames(*size, seed=1)
        ts = np.full(2, 0.5, np.float32)
        np.testing.assert_array_equal(fused.process_batch(a, b, ts),
                                      plain.process_batch(a, b, ts))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("model", ["v4.6", "v2.3"])
def test_fused_slice_matches_rife_tpu(model_dirs, jax_fused, model, size):
    sess = RIFE(str(model_dirs[model]), device="cpu", fuse_ds2=True)
    got = sess.process_batch(*frames(*size), np.full(2, 0.5, np.float32))
    assert_u8_close(got, jax_fused[(model, *size)])


def test_fused_plain_steps_at_1080p(tmp_path):
    """The fused plain steps at full widths: K3 twice per flownet run, in
    place of one warp pair."""
    v46 = RIFE(str(write_flownet_param(tmp_path)), device="cpu",
               fuse_ds2=True)
    assert plan.kernel_sites(v46, 1080, 1920) == {
        "warp_ds4_pair": 1, "warp_pair": 1, "warp_ds2": 2, "warp_render": 1}
    v23 = RIFE(str(write_v23_params(tmp_path)), device="cpu", fuse_ds2=True)
    assert plan.kernel_sites(v23, 1080, 1920) == {
        "conv3x3": 11, "warp_feat": 4, "warp_u8": 2, "warp_pair": 1,
        "warp_ds2": 2, "warp_ds4_pair": 1}
