"""The TTA view algebra of rife_tpu_torch.ops.frame against rife_tpu.ops.frame,
and the launch plan of the TTA steps against the kernel wrappers' calls.

The view functions take the same random arrays on both sides (NHWC for
``rife_tpu``, NCHW for the port, transposed in the test).  Bars: bit-exact
for the flips, transposes, signed channel permutations and temporal merges;
<= 1 ulp of the operand dtype for the 8-view means (the port sums the views
in order in f32, as XLA reduces ``jnp.mean`` on the CPU; another reduction
order may round the last bit otherwise).  Every port function returns
contiguous tensors: the warp kernels take contiguous planes only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.ops import frame as JF
from rife_tpu_torch import RIFE
from rife_tpu_torch.engine import plan
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.models.v46_arch import write_flownet_param
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import frame as F
from rife_tpu_torch.ops import warp as W

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Mini-width tensors gain nothing from torch's thread pool, and the
    suite runs several test processes at once: one thread each keeps them
    from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def to_port(x, td):
    """NHWC-style numpy (channels last) -> the port's layout (channels at
    dim -3): (..., H, W, C) -> (..., C, H, W)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.movedim(-1, -3).contiguous().to(td)


def from_port(t):
    return t.float().movedim(-3, -1).numpy()


def ulp(x, td):
    x = np.abs(np.asarray(x, np.float32))
    mant = 23 if td == torch.float32 else 7
    e = np.floor(np.log2(np.maximum(x, 2.0 ** -126)))
    return 2.0 ** (e - mant)


def assert_within_ulp(got, want, td):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= ulp(want, td))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_expand_views8_is_exact(dtype):
    jd, td = DTYPES[dtype]
    x = rand(0, (2, 6, 10, 3))
    ja, jb = JF.expand_views8(jnp.asarray(x).astype(jd))
    ga, gb = F.expand_views8(to_port(x, td))
    assert ga.shape == (2, 4, 3, 6, 10) and gb.shape == (2, 4, 3, 10, 6)
    assert ga.is_contiguous() and gb.is_contiguous() and ga.dtype == td
    np.testing.assert_array_equal(from_port(ga), np.asarray(ja, np.float32))
    np.testing.assert_array_equal(from_port(gb), np.asarray(jb, np.float32))


def test_views_round_trip():
    """Expanding and merging 8 copies of one frame gives the frame back, to
    the rounding of the in-order f32 sum of 8 equal values (rtol 1e-6)."""
    x = rand(1, (2, 6, 10, 3))
    got = F.merge_views8_mean(*F.expand_views8(to_port(x, torch.float32)))
    np.testing.assert_allclose(from_port(got), x, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_merge_views8_mean(dtype):
    jd, td = DTYPES[dtype]
    ga, gb = rand(2, (2, 4, 6, 10, 3)), rand(3, (2, 4, 10, 6, 3))
    want = JF.merge_views8_mean(jnp.asarray(ga).astype(jd),
                                jnp.asarray(gb).astype(jd))
    got = F.merge_views8_mean(to_port(ga, td), to_port(gb, td))
    assert got.shape == (2, 3, 6, 10) and got.dtype == td
    assert got.is_contiguous()
    assert_within_ulp(from_port(got), want, td)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_pairs,has_mask,c", [
    (2, True, 6),    # v4.6 taps: 2 flows, mask, one passthrough channel
    (2, False, 4),   # v2 flows
    (1, False, 2),   # v1 flows
])
def test_flow_views_avg(dtype, n_pairs, has_mask, c):
    jd, td = DTYPES[dtype]
    ga, gb = rand(4, (2, 4, 6, 10, c)), rand(5, (2, 4, 10, 6, c))
    ja, jb = JF.flow_views_avg(jnp.asarray(ga).astype(jd),
                               jnp.asarray(gb).astype(jd), n_pairs, has_mask)
    pa, pb = F.flow_views_avg(to_port(ga, td), to_port(gb, td), n_pairs,
                              has_mask)
    for got, want in ((pa, ja), (pb, jb)):
        assert got.is_contiguous() and got.dtype == td
        assert_within_ulp(from_port(got), want, td)
    n_sig = 2 * n_pairs + has_mask
    # the passthrough channels keep their per-view values, bit for bit
    np.testing.assert_array_equal(from_port(pa)[..., n_sig:],
                                  np.asarray(ja, np.float32)[..., n_sig:])


def test_flow_views_avg_keeps_a_consistent_field():
    """A flow field that the views agree on (its 8 views, each with the
    view's signed components) is its own consensus."""
    flow = to_port(rand(6, (1, 8, 8, 2)), torch.float32)
    ga, gb = F.expand_views8(flow)
    ga = torch.stack([F._flow_channel_map(ga[:, k], k, 1, [], F._SCATTER)
                      for k in range(4)], dim=1)
    gb = torch.stack([F._flow_channel_map(gb[:, k], k + 4, 1, [], F._SCATTER)
                      for k in range(4)], dim=1)
    na, nb = F.flow_views_avg(ga, gb, 1, False)
    torch.testing.assert_close(na, ga, rtol=0, atol=1e-6)
    torch.testing.assert_close(nb, gb, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fn,c", [("flow_temporal_avg_v1", 2),
                                  ("flow_temporal_avg_v2", 4),
                                  ("flow_temporal_avg_v4", 6),
                                  ("out_temporal_avg", 3)])
def test_temporal_merges_are_exact(dtype, fn, c):
    jd, td = DTYPES[dtype]
    a, b = rand(7, (2, 4, 6, 10, c)), rand(8, (2, 4, 6, 10, c))
    want = getattr(JF, fn)(jnp.asarray(a).astype(jd),
                           jnp.asarray(b).astype(jd))
    got = getattr(F, fn)(to_port(a, td), to_port(b, td))
    if fn == "out_temporal_avg":
        want, got = (want,), (got,)
    for g, r in zip(got, want):
        assert g.is_contiguous() and g.dtype == td
        np.testing.assert_array_equal(from_port(g), np.asarray(r, np.float32))


# --- the plan of the TTA steps ---------------------------------------------

MODES = {"plain": (False, False), "x": (True, False), "z": (False, True),
         "xz": (True, True)}


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tta_plan")
    return {"v4.6": write_flownet_param(root, (16, 16, 16, 16)),
            "v2.3": write_v23_params(root, (8, 8, 8, 8, 4))}


def _count_calls(monkeypatch, calls):
    """Count the kernel wrappers' calls (on the CPU they run the twins)."""
    for mod, names in ((W, [k for k in W.LAUNCHES]), (CV, ["conv3x3"])):
        for name in names:
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(*a, **k)
            monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model", ["v4.6", "v2.3"])
def test_kernel_sites_match_dispatch(model_dirs, model, mode, fuse,
                                     monkeypatch):
    """``plan.kernel_sites`` counts what one TTA step hands the wrappers, in
    both view geometries (an unaligned size, so the transposed group has
    another padded shape); the v2.3 conv gates are lowered so that conv3x3
    sites are counted too."""
    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    tta, temporal = MODES[mode]
    sess = RIFE(str(model_dirs[model]), device="cpu", tta_mode=tta,
                tta_temporal_mode=temporal, fuse_ds2=fuse)
    h, w = 50, 70
    want = plan.kernel_sites(sess, h, w)
    calls = {}
    _count_calls(monkeypatch, calls)
    rng = np.random.default_rng(9)
    a, b = (rng.integers(0, 256, (1, h, w, 3), np.uint8) for _ in range(2))
    sess.process_batch(a, b, np.full(1, 0.5, np.float32))
    assert calls == want
    runs = (2 if tta else 1) * (2 if temporal else 1)
    assert want.get("warp_ds2", 0) == (2 * runs if fuse else 0)
    if model == "v2.3":
        assert want["conv3x3"] > 0
