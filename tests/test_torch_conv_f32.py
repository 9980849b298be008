"""The f32 conv kernel (``csrc/conv.cu`` ``conv3x3_f32_kernel``) on the CPU:
its sum order, its deconv mode and the plan its wrapper passes it.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to its
twin and, bit for bit, to ``torch_f32_order``); here:

* ``fma32`` (the tests' numpy ``fmaf``) against exact rational arithmetic;
* the deconv mode's order (each output phase over its four non-zero taps
  of ``pack_weight_t4``, written interleaved: ``deconv4x4_phases``) bit for
  bit against the earlier kernel's order (the phase conv over all nine taps
  of ``deconv_phase_weights``, then ``interleave_phases``) on random data,
  and on data whose sums are exact (small dyadic values) bit for bit
  against ``deconv4x4_ref`` and ``rife_tpu``'s ``deconv_planar`` in
  interpret mode, as tests/test_conv_planar.py runs it, at every f32 deconv
  site of the mini v2.3 and v1 reconstructions; at the f32 bar (1e-5 of the
  largest output) on random data;
* the kernel's launch plan (``csrc/conv_f32_plan.h``, compiled for the
  host with g++): every output pixel and channel computed once, every input
  channel staged once and no channel past Cin;
* the wrapper hands the kernel the shapes it plans from (a fake library);
* ``plan.kernel_sites`` of f32 sessions as they were before this kernel.
"""

import ctypes
import shutil
import subprocess
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rife_tpu.ops import conv_planar as CP
from rife_tpu_torch.native import build
from rife_tpu_torch.ops import conv as CV
from torch_f32_order import conv3x3_serial, deconv4x4_phases, fma32

# every f32 deconv site of the mini reconstructions at 64x96 with the gates
# at 0 (test_mini_deconv_sites_are_the_plans): (Cin, O, act, H, W)
MINI_DECONV_SITES = [
    (16, 4, 0, 2, 3), (16, 4, 0, 4, 6), (16, 4, 0, 8, 12), (16, 4, 0, 16, 24),
    (64, 16, 3, 4, 6), (32, 8, 3, 8, 12), (16, 4, 3, 16, 24),
    (4, 4, 0, 32, 48),                           # v2.3 (8, 8, 8, 8, 4)
    (64, 16, 3, 8, 12), (32, 4, 3, 16, 24),      # v1 (8, 8, 8, 4)
]


def exact_f32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    r = np.float32(float(x))
    best = None
    for c in (np.nextafter(r, np.float32(-np.inf)), r,
              np.nextafter(r, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        even = (int(np.float32(c).view(np.uint32)) & 1) == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return np.float32(best[1])


def test_fma32_is_one_rounding():
    rng = np.random.default_rng(0)
    n = 3000
    a = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    b = (rng.normal(size=n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.normal(size=n) * 1e-6)
         ).astype(np.float32)
    c[::3] = (rng.normal(size=len(c[::3])) * 1e3).astype(np.float32)
    # halfway in float64 but not exactly: 2^30 + 128 + (64 - 2^-40), whose
    # float64 sum ties between 2^30 + 128 and 2^30 + 256, and its mirror
    one_up = np.float32(1 + 2.0 ** -23)
    just_under = np.float32(64 * (1 - 2.0 ** -23))
    odd = np.float32(2.0 ** 30 + 128)
    a = np.concatenate([a, [one_up, -one_up]]).astype(np.float32)
    b = np.concatenate([b, [just_under, just_under]]).astype(np.float32)
    c = np.concatenate([c, [odd, -odd]]).astype(np.float32)
    got = fma32(a, b, c)
    want = np.array([exact_f32(Fraction(float(x)) * Fraction(float(y))
                               + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[-2] == odd  # a rounding of the float64 sum gives 2^30 + 256
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert naive[-2] != got[-2]


@pytest.mark.parametrize("parts,cout,stride,act", [
    ((3, 3, 4), 8, 2, CV.ACT_PRELU), ((5,), 7, 1, CV.ACT_LEAKY),
    ((16,), 16, 1, CV.ACT_RELU)])
def test_serial_conv_is_the_conv(parts, cout, stride, act):
    """The order the card's kernel is held to bit for bit computes the conv
    (against the twin at the f32 bar)."""
    rng = np.random.default_rng(sum(parts) + cout)
    xs = [rng.normal(size=(2, c, 9, 14)).astype(np.float32) for c in parts]
    weight = (rng.normal(size=(cout, sum(parts), 3, 3)) * 0.3).astype(
        np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    slope = rng.uniform(0.05, 0.4, cout).astype(np.float32)
    got = conv3x3_serial(xs, weight, bias, slope, stride=stride, act=act)
    t = torch.from_numpy
    want = CV.conv3x3_ref([t(x) for x in xs], t(weight), t(bias), t(slope),
                          stride=stride, act=act).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def deconv_case(seed, cin, o, h, w, exact):
    """x, raw (I, O, 4, 4) weights, bias, slope; ``exact``: multiples of
    2^-4 and 2^-5 small enough that every product and sum is exact, so
    every order of the sums gives the same float32."""
    rng = np.random.default_rng(seed)
    if exact:
        x = rng.integers(-8, 9, (2, cin, h, w)) / 16.0
        raw = rng.integers(-8, 9, (cin, o, 4, 4)) / 32.0
        bias = rng.integers(-8, 9, o) / 16.0
    else:
        x = rng.normal(size=(2, cin, h, w))
        raw = rng.normal(size=(cin, o, 4, 4)) / (2 * cin ** 0.5)
        bias = rng.normal(size=o) * 0.3
    slope = rng.uniform(0.05, 0.4, o)
    return [np.asarray(v, np.float32) for v in (x, raw, bias, slope)]


def test_mini_deconv_sites_are_the_plans(tmp_path, monkeypatch):
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import conv_sites
    from rife_tpu_torch.models.v1_arch import write_v1_params
    from rife_tpu_torch.models.v23_arch import write_v23_params

    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    found = []
    for d in (write_v23_params(tmp_path, (8, 8, 8, 8, 4)),
              write_v1_params(tmp_path, (8, 8, 8, 4))):
        sess = RIFE(str(d), device="cpu")
        assert sess.dtype == torch.float32
        for kind in ("conv3x3", "conv3x3_ps"):
            found += [(parts[0], cout // 4, act, h, w)
                      for _, parts, cout, _, act, h, w, deconv
                      in conv_sites(sess, 64, 96, kind) if deconv]
    assert found == MINI_DECONV_SITES


@pytest.mark.parametrize("cin,o,act,h,w", MINI_DECONV_SITES)
def test_deconv_mode_order(cin, o, act, h, w):
    """Random data: the deconv mode's four taps a phase, bit for bit with
    the earlier kernel's nine (dropping a zero tap leaves an fmaf chain
    from +0 as it is), and against the twin at the f32 bar."""
    x, raw, bias, slope = deconv_case(cin * o + h, cin, o, h, w, False)
    t4 = CV.pack_weight_t4(torch.from_numpy(raw)).numpy()
    b4, s4 = np.tile(bias, 4), np.tile(slope, 4)
    got = deconv4x4_phases(x, t4, b4, s4, act=act)
    w3 = CV.deconv_phase_weights(torch.from_numpy(raw))
    nine = CV.interleave_phases(torch.from_numpy(conv3x3_serial(
        [x], w3.numpy(), b4, s4, act=act))).numpy()
    assert np.array_equal(got.view(np.uint32), nine.view(np.uint32))
    t = torch.from_numpy
    want = CV.deconv4x4_ref(t(x), w3, t(b4), t(s4), act=act).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("cin,o,act,h,w", MINI_DECONV_SITES)
def test_deconv_mode_against_deconv_planar(cin, o, act, h, w):
    """Exact sums: the deconv mode bit for bit against ``deconv4x4_ref``
    and ``rife_tpu``'s ``deconv_planar`` (f32, interpret mode; it takes the
    raw weights spatially flipped as HWIO)."""
    x, raw, bias, slope = deconv_case(cin + o * h, cin, o, h, w, True)
    t4 = CV.pack_weight_t4(torch.from_numpy(raw)).numpy()
    b4, s4 = np.tile(bias, 4), np.tile(slope, 4)
    got = deconv4x4_phases(x, t4, b4, s4, act=act)
    t = torch.from_numpy
    twin = CV.deconv4x4_ref(t(x), CV.deconv_phase_weights(t(raw)), t(b4),
                            t(s4), act=act).numpy()
    flipped = jnp.asarray(raw[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
    with pltpu.force_tpu_interpret_mode():
        ref = CP.deconv_planar(jnp.asarray(x.transpose(0, 2, 1, 3)), flipped,
                               jnp.asarray(bias), act=act, alpha=0.2,
                               slope=jnp.asarray(slope))
    ref = np.asarray(ref, np.float32).transpose(0, 2, 1, 3)
    assert got.shape == twin.shape == ref.shape == (2, o, 2 * h, 2 * w)
    assert np.array_equal(got, twin)
    assert np.array_equal(got, ref)


# the kernel's plan and walk (csrc/conv_f32_plan.h) built by a host
# compiler behind a C shim
PLAN_SHIM = r"""
#include "conv_f32_plan.h"
extern "C" {
int f32_plan(int batch, int cin, int cout, int h, int w, int stride,
             int deconv, int* out) {
  rife_f32::Plan p;
  if (!rife_f32::plan(batch, cin, cout, h, w, stride, deconv != 0, &p))
    return 0;
  const int v[] = {p.wc, p.rows, p.groups, p.group_out, p.tiles_x,
                   p.tiles_y, p.n_tiles, p.kc, p.n_chunks, p.resident,
                   p.smem, p.r, p.wr, p.out_ch};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 1;
}
void f32_tile_at(int t, int tiles_x, int tiles_y, int rows, int* out) {
  const rife_f32::TileAt at = rife_f32::tile_at(t, tiles_x, tiles_y, rows);
  out[0] = at.b;
  out[1] = at.oy0;
  out[2] = at.ox0;
}
int f32_block_tiles(int n, int b, int blocks) {
  return rife_f32::block_tiles(n, b, blocks);
}
int f32_chunk_start(int k, int cin, int n) {
  return rife_f32::chunk_start(k, cin, n);
}
int f32_warp_row0(int warp, int wr, int r) {
  return rife_f32::warp_row0(warp, wr, r);
}
int f32_warp_ch0(int warp, int wr, int c) {
  return rife_f32::warp_ch0(warp, wr, c);
}
int f32_warps() { return rife_f32::kWarps; }
int f32_tile_cols() { return rife_f32::kTileCols; }
int f32_smem_block() { return rife_f32::kSmemBlock; }
}
"""
PLAN_FIELDS = ("wc", "rows", "groups", "group_out", "tiles_x", "tiles_y",
               "n_tiles", "kc", "n_chunks", "resident", "smem", "r", "wr",
               "out_ch")


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build csrc/conv_f32_plan.h")
    root = tmp_path_factory.mktemp("f32_plan")
    (root / "shim.cpp").write_text(PLAN_SHIM)
    lib = root / "libf32plan.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{build.SRC_DIR}", "-o", str(lib),
                    str(root / "shim.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def kernel_plan(lib, b, cin, cout, h, w, stride, deconv):
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    if not lib.f32_plan(b, cin, cout, h, w, stride, int(deconv), out):
        return None
    return dict(zip(PLAN_FIELDS, out))


def walk(lib, plan, b, cin, ho, wo, cout, deconv, blocks):
    """The kernel's walk: ``blocks`` blocks (gridDim.x) of each channel
    group over its tiles, each warp over its share of a tile; returns how
    often each output (b, channel, y, x) is written (deconv: each phase
    channel) and each input channel staged per tile."""
    chans = 4 * cout if deconv else cout
    written = np.zeros((b, chans, ho, wo), np.int32)
    n_tiles, grid = plan["n_tiles"], min(plan["n_tiles"], blocks)
    staged = np.zeros((n_tiles, cin), np.int32)
    at = (ctypes.c_int * 3)()
    cols = lib.f32_tile_cols()
    n = plan["n_chunks"]
    bounds = [lib.f32_chunk_start(k, cin, n) for k in range(n + 1)]
    for g in range(plan["groups"]):
        for x in range(grid):
            for i in range(lib.f32_block_tiles(n_tiles, x, grid)):
                t = x + i * grid
                lib.f32_tile_at(t, plan["tiles_x"], plan["tiles_y"],
                                plan["rows"], at)
                tb, oy0, ox0 = at
                if g == 0:
                    for k in range(n):
                        staged[t, bounds[k]:bounds[k + 1]] += 1
                for warp in range(lib.f32_warps()):
                    y0 = oy0 + lib.f32_warp_row0(warp, plan["wr"], plan["r"])
                    c0 = g * plan["group_out"] + lib.f32_warp_ch0(
                        warp, plan["wr"], plan["out_ch"])
                    c1 = min(c0 + plan["out_ch"], cout)
                    for ph in range(4) if deconv else (0,):
                        written[tb, ph * cout + c0:ph * cout + c1,
                                y0:y0 + plan["r"], ox0:ox0 + cols] += 1
    return written, staged, bounds


@pytest.mark.parametrize("parts", [(3, 3, 4), (3,), (32,), (192,), (5,),
                                   (17, 9)])
@pytest.mark.parametrize("cout,stride,deconv", [
    (32, 1, False), (48, 2, False), (7, 2, False), (96, 1, False),
    (4, 1, True), (16, 1, True), (3, 1, True)])
def test_plan_covers_every_output_once(plan_lib, parts, cout, stride,
                                       deconv):
    """The kernel's own plan and walk (``csrc/conv_f32_plan.h``, built for
    the host): every output written once whatever the grid, every input
    channel staged once a tile, in chunks of at most ``kc`` that split Cin
    evenly and stage no channel past it, within two blocks' shared memory
    an SM."""
    cin = sum(parts)
    b, h, w = 2, 37, 70
    plan = kernel_plan(plan_lib, b, cin, cout, h, w, stride, deconv)
    assert plan is not None
    ho, wo = ((h, w) if deconv else
              ((h - 1) // stride + 1, (w - 1) // stride + 1))
    assert plan["rows"] == plan["r"] * plan["wr"]
    assert plan["smem"] <= plan_lib.f32_smem_block()
    for blocks in (1, 5, 264):
        written, staged, bounds = walk(plan_lib, plan, b, cin, ho, wo, cout,
                                       deconv, blocks)
        assert (written == 1).all()
        assert (staged == 1).all()
    counts = np.diff(bounds)
    assert bounds[0] == 0 and bounds[-1] == cin
    assert counts.min() >= 1 and counts.max() <= plan["kc"] <= cin
    assert counts.max() - counts.min() <= 1


def test_plan_refuses_what_the_kernel_does_not_take(plan_lib):
    assert kernel_plan(plan_lib, 1, 8, 8, 8, 8, 3, False) is None
    assert kernel_plan(plan_lib, 1, 8, 8, 8, 8, 2, True) is None
    assert kernel_plan(plan_lib, 0, 8, 8, 8, 8, 1, False) is None
    assert kernel_plan(plan_lib, 1, 8, 8, 8, 8, 1, False) is not None


@pytest.mark.parametrize("deconv", [False, True])
def test_f32_launch_hands_the_kernel_its_plan(monkeypatch, plan_lib, deconv):
    """On the card an f32 launch calls ``rife_conv3x3`` with the shapes the
    kernel plans its launch from (``conv_f32_plan.h``) and its mode (a fake
    library and a tensor that reports a CUDA device)."""
    calls = []

    class Lib:
        def rife_conv3x3(self, *args):
            calls.append(args)
            return 0

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    monkeypatch.setattr(build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 10, 12, 20)).astype(
        np.float32)).as_subclass(OnCard)
    CV.reset_launches()
    if deconv:
        raw = torch.from_numpy(rng.normal(size=(10, 6, 4, 4)).astype(
            np.float32))
        CV.deconv4x4(x, CV.deconv_phase_weights(raw).as_subclass(OnCard),
                     torch.zeros(24).as_subclass(OnCard),
                     weight_t4=CV.pack_weight_t4(raw).as_subclass(OnCard))
        want = (2, 12, 20, 6, 1)
    else:
        weight = torch.from_numpy(rng.normal(size=(20, 10, 3, 3)).astype(
            np.float32)).as_subclass(OnCard)
        CV.conv3x3([x], weight, stride=2,
                   weight_tc=CV.pack_weight_tc(weight))
        want = (2, 12, 20, 20, 2)
    assert len(calls) == 1
    args = calls[0]
    assert args[4:8] == (10, 0, 0, 0) and args[9] == 16
    assert args[13:18] == want and args[-2] == int(deconv)
    b, h, w, cout, stride = want
    assert kernel_plan(plan_lib, b, 10, cout, h, w, stride,
                       deconv) is not None
    assert CV.LAUNCHES == {"conv3x3": 1, "conv3x3_ps": 0, "deconv4x4": 0,
                           "bias_act": 0}


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_f32_card_launch_needs_the_packed_weights(monkeypatch):
    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    x = torch.zeros(1, 3, 8, 8).as_subclass(OnCard)
    weight = torch.zeros(4, 3, 3, 3).as_subclass(OnCard)
    with pytest.raises(ValueError, match="weight_tc"):
        CV.conv3x3([x], weight)
    raw = torch.zeros(3, 2, 4, 4)
    with pytest.raises(ValueError, match="weight_t4"):
        CV.deconv4x4(x, CV.deconv_phase_weights(raw).as_subclass(OnCard))


# plan.kernel_sites of f32 sessions at full widths before the f32 kernel's
# redesign (the deconv mode keeps counting as conv3x3 / conv3x3_ps)
F32_KERNEL_SITES = {
    ("v4.6", (), (1080, 1920)): {"warp_ds4_pair": 1, "warp_pair": 2,
                                 "warp_render": 1},
    ("v2.3", (), (1080, 1920)): {"warp_ds4_pair": 1, "warp_pair": 2,
                                 "conv3x3": 11, "warp_feat": 4,
                                 "warp_u8": 2},
    ("v1", (), (1080, 1920)): {"warp_ds4_pair": 1, "warp_pair": 2,
                               "conv3x3": 15, "warp_feat": 8,
                               "conv3x3_ps": 1},
    ("v2.3", ("uhd_mode",), (2160, 3840)): {"warp_feat": 10, "conv3x3": 14,
                                            "warp_u8": 2},
    ("v2.3", ("tta_mode", "tta_temporal_mode"), (1080, 1920)): {
        "warp_ds4_pair": 4, "warp_pair": 8, "conv3x3": 38, "warp_feat": 8,
        "warp_u8": 8},
}


@pytest.fixture(scope="module")
def full_dirs(tmp_path_factory):
    from rife_tpu_torch.models.v1_arch import write_v1_params
    from rife_tpu_torch.models.v23_arch import write_v23_params
    from rife_tpu_torch.models.v46_arch import write_flownet_param

    root = tmp_path_factory.mktemp("full")
    return {"v4.6": write_flownet_param(root), "v2.3": write_v23_params(root),
            "v1": write_v1_params(root)}


@pytest.mark.parametrize("key", list(F32_KERNEL_SITES))
def test_f32_kernel_sites_unchanged(full_dirs, key):
    from rife_tpu_torch import RIFE
    from rife_tpu_torch.engine.plan import kernel_sites

    model, modes, (h, w) = key
    sess = RIFE(str(full_dirs[model]), device="cpu",
                **{m: True for m in modes})
    assert sess.dtype == torch.float32
    assert kernel_sites(sess, h, w) == F32_KERNEL_SITES[key]
