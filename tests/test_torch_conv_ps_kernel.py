"""B4's conv kernel (``csrc/conv_ps.cu`` ``conv3x3_ps_kernel``) on the CPU:
the host side it reads and a plain-torch walk of what it does.

* ``ps_geometry`` (the tile and box geometry the wrapper computes and the
  kernel checks): the v1 head's launch, every shape of the gate's range in
  shared memory, the accumulators' size, the TMA conditions; shapes outside
  the kernel's range raise.
* The wrapper (``conv3x3(..., ps=2)`` on a bf16 CUDA tensor, with the C
  library replaced by a recorder): one call of ``rife_conv3x3_ps`` with the
  geometry's tile rows, stages and TMA flags; it raises on a non-contiguous
  input, a wrong dtype, a base that is not 16-byte aligned, two parts, a
  shuffle other than 2 and channels past 64, and launches nothing then.  The
  kernel reads ``pack_weight_tc``'s layout: no new packing.
* ``walk``: the kernel step by step in torch: each (tile, chunk) staged as
  TMA (or the per-thread branch) lands it, 80 columns from x0 - 8 a row
  (at stride 2 the even and the odd columns), then the consumers'
  transpose job by job into the swizzled channels-inner layout, the A
  fragments gathered at the ldmatrix lane addresses (which must find every
  slot they read written), each warp's rows streamed in the kernel's order
  (chunk, then input row, then column shift: taps 0..8 per output), the
  epilogue's bf16 pairs at their swizzled places in the two output halves,
  and the halves read back and clipped as the TMA store and the per-thread
  stores write them.  Held to ``conv3x3_ref(..., ps=2)``: bit for bit in f32
  and bf16 on dyadic inputs (every sum exact, so the order cannot move a
  rounding); on random inputs (the walk's f32 sums run in another order
  than oneDNN's) f32 max |d| <= 1e-5 of the largest output, bf16 <= 1 ulp
  of max(|out|, 2^-14 x the sum of absolute products) and >= 99% exact.
  Held to ``rife_tpu``'s ``conv_ps_planar`` in interpret mode: the same
  bars.  ``mirror_ps_store`` (the epilogue alone) is also
  tests/test_torch_conv_tc.py's mirror of B4's conv form.

The kernel against its twin on the card: tests/test_torch_cuda.py.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rife_tpu.ops import conv_planar as CP
from rife_tpu_torch.native import build
from rife_tpu_torch.ops import conv as CV

ACTS = [CV.ACT_NONE, CV.ACT_RELU, CV.ACT_LEAKY, CV.ACT_PRELU]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tswz(m, half):
    """``csrc/conv_ps.cu`` ``tswz``: the 16 bytes of channels 8 half .. 8
    half + 7 of pixel m (row r, pixel l: m = 24 r + l) of a warp's
    transposed window."""
    return m * 32 + (((half ^ (m >> 2)) & 1) << 4)


T_PX = 32  # pixels of a warp's transposed row


def stage(x, b, chunk, y0, x0, stride, box_rows):
    """One stage as a TMA box (or the per-thread branch) lands it,
    [plane][row][channel][80] flattened to (rows, 16, 80): plane p of row rr
    holds input row s y0 - 1 + rr at columns s (x0 - 8 + q) - p, zero
    outside the frame and past Cin."""
    _, cin, h, w = x.shape
    ph, rr, c, q = torch.meshgrid(torch.arange(stride),
                                  torch.arange(box_rows),
                                  torch.arange(CV.PS_CHUNK),
                                  torch.arange(CV.PS_RAW_PX), indexing="ij")
    ch = chunk * CV.PS_CHUNK + c
    gy = y0 * stride - 1 + rr
    gx = stride * (x0 - 8 + q) - ph
    ok = (ch < cin) & (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    raw = torch.where(ok, x[b, ch.clamp(max=cin - 1), gy.clamp(0, h - 1),
                            gx.clamp(0, w - 1)], torch.zeros(()))
    return raw.reshape(stride * box_rows, CV.PS_CHUNK, CV.PS_RAW_PX)


def warp_window(raw, rg, cg, r, stride, box_rows):
    """Warp (rg, cg)'s transpose, 8 x 8 block by block (row of its window,
    pixel block pb, channel half): staged pixels 16 cg + 8 pb .. + 7 of
    channels 8 half .. + 7 to ``tswz`` (as ldmatrix.trans then stmatrix
    move them); returns the window as a flat f32 array of bf16 slots (NaN
    where nothing was written)."""
    win = (r - 1) * stride + 3
    rows = stride * win
    flat = torch.full((rows * T_PX * CV.PS_CHUNK,), float("nan"))
    for row in range(rows):
        src = (row // win) * box_rows + rg * r * stride + row % win
        for pb in range(T_PX // 8):
            for half in (0, 1):
                block = raw[src, 8 * half:8 * half + 8,
                            16 * cg + 8 * pb:16 * cg + 8 * pb + 8]
                for px in range(8):
                    slot = tswz(row * T_PX + 8 * pb + px, half) // 2
                    assert bool(torch.isnan(flat[slot:slot + 8]).all())
                    flat[slot:slot + 8] = block[:, px]
    return flat


def a_fragment(flat, kx, rr, win, stride):
    """The 16 pixels x 16 channels A tile that ``ldmatrix.x4`` gives a warp
    at window row ``rr`` and tap column ``kx``: lane l reads the 8 channels
    8 (l // 16) .. of window pixel l0 + 8 ((l // 8) % 2) + l % 8 of plane ph
    (stride 1: l0 = 7 + kx, plane 0; stride 2: l0 = 8, 8, 9 and planes 1,
    0, 1 for kx = 0, 1, 2)."""
    ph = 0 if stride == 1 or kx == 1 else 1
    l0 = 7 + kx if stride == 1 else (9 if kx == 2 else 8)
    a = torch.empty(16, 16)
    for lane in range(32):
        pix = 8 * ((lane >> 3) & 1) + (lane & 7)
        half = lane >> 4
        byte = tswz((ph * win + rr) * T_PX + l0 + pix, half)
        a[pix, 8 * half:8 * half + 8] = flat[byte // 2:byte // 2 + 8]
    assert not torch.isnan(a).any()
    return a


def warp_words(r, nt, cout):
    """A warp's output tile, [C/4][2R][32 columns] as 32-bit words:
    ``word[q, px, n / 2]``, where the epilogue puts the bf16 pair of even
    channel n (and n + 1) of its conv pixel (row q, column px), ``keep``: n
    < Cout; ``back[c, yy, xw]``, the word the TMA store (or the per-thread
    stores) writes to output (c, oy + yy, ox + 2 xw)."""
    q, px, ne = torch.meshgrid(torch.arange(r), torch.arange(16),
                               torch.arange(0, 8 * nt, 2), indexing="ij")
    line = (ne >> 2) * 2 * r + 2 * q + ((ne >> 1) & 1)
    word = line * (CV.PS_OUT_LINE // 4) + px
    keep = ne < cout
    c, yy, xw = torch.meshgrid(torch.arange(cout // 4), torch.arange(2 * r),
                               torch.arange(16), indexing="ij")
    back = (c * 2 * r + yy) * (CV.PS_OUT_LINE // 4) + xw
    assert len(torch.unique(word[keep])) == int(keep.sum()) == back.numel()
    return word, keep, back


def store_warp(out, v, words, bb, oy, ox):
    """A warp's epilogue stores of its (R, 16, NT x 8) rounded values, then
    its output tile into ``out`` (B, Cout/4, 2 Ho, 2 Wo) at (oy, ox),
    clipped."""
    word, keep, back = words
    r, c4 = v.shape[0], out.shape[1]
    tile = torch.full((int(back.max()) + 1, 2), float("nan"))
    tile[word[keep]] = v.reshape(r, 16, -1, 2)[keep]
    vals = tile[back].reshape(c4, 2 * r, 32)
    rows = min(2 * r, out.shape[2] - oy)
    cols = min(32, out.shape[3] - ox)
    if rows > 0 and cols > 0:
        out[bb, :, oy:oy + rows, ox:ox + cols] = vals[:, :rows, :cols]


def tiles(geo):
    """(batch item, first conv row, first conv column) of each tile, in the
    order a block walks them."""
    for t in range(geo.n_tiles):
        tx, r0 = t % geo.tiles_x, t // geo.tiles_x
        ty, bb = r0 % geo.tiles_y, r0 // geo.tiles_y
        yield bb, ty * geo.tile_rows, tx * CV.PS_TILE_COLS


def warps(geo, y0, x0):
    """(row group, column group, first conv row, first conv column) of the
    8 consumer warps of the tile at (y0, x0)."""
    r = geo.tile_rows // 2
    for w in range(CV.PS_CONSUMER_WARPS):
        rg, cg = w >> 2, w & 3
        yield rg, cg, y0 + rg * r, x0 + 16 * cg


def mirror_ps_store(y, stride):
    """Place the (B, Cout, Ho, Wo) rounded conv results of a stride-``stride``
    launch as the kernel's epilogue does; returns (B, Cout/4, 2 Ho, 2 Wo)."""
    b, cout, ho, wo = y.shape
    geo = CV.ps_geometry(b, 16, cout, ho * stride, wo * stride, stride)
    r, n = geo.tile_rows // 2, geo.nt * 8
    words = warp_words(r, geo.nt, cout)
    out = torch.full((b, cout // 4, 2 * ho, 2 * wo), float("nan"))
    pad = torch.nn.functional.pad(y.float(), (0, 64, 0, geo.tile_rows, 0,
                                              n - cout))
    for bb, y0, x0 in tiles(geo):
        for _, _, wy, wx in warps(geo, y0, x0):
            v = pad[bb, :, wy:wy + r, wx:wx + 16].permute(1, 2, 0)
            store_warp(out, v, words, bb, 2 * wy, 2 * wx)
    return out


def walk(x, weight_tc, bias=None, slope=None, *, stride=1, act=CV.ACT_NONE,
         alpha=0.2):
    """``conv3x3_ps_kernel`` step by step (module docstring); returns the
    (B, Cout/4, 2 Ho, 2 Wo) output in ``x``'s dtype."""
    b, cin, h, w = x.shape
    cout = weight_tc.shape[1]
    geo = CV.ps_geometry(b, cin, cout, h, w, stride)
    r, n = geo.tile_rows // 2, geo.nt * 8
    win = (r - 1) * stride + 3
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    wt = torch.zeros(9, n, geo.chunks * CV.PS_CHUNK)
    wt[:, :cout, :weight_tc.shape[2]] = weight_tc.float()
    pad = (lambda t: None if t is None  # noqa: E731
           else torch.nn.functional.pad(t.float(), (0, n - cout)))
    xf = x.float()
    out = torch.full((b, cout // 4, 2 * ho, 2 * wo), float("nan"))
    words = warp_words(r, geo.nt, cout)
    for bb, y0, x0 in tiles(geo):
        accs = {}
        for chunk in range(geo.chunks):
            raw = stage(xf, bb, chunk, y0, x0, stride, geo.box_rows)
            wc = wt[:, :, chunk * CV.PS_CHUNK:(chunk + 1) * CV.PS_CHUNK]
            for rg, cg, _, _ in warps(geo, y0, x0):
                acc = accs.setdefault((rg, cg), torch.zeros(r, 16, n))
                flat = warp_window(raw, rg, cg, r, stride, geo.box_rows)
                for rr in range(win):
                    for kx in range(3):
                        a = a_fragment(flat, kx, rr, win, stride)
                        for qq in range(r):
                            ky = rr - qq * stride
                            if 0 <= ky <= 2:
                                acc[qq] += a @ wc[ky * 3 + kx].t()
        for rg, cg, wy, wx in warps(geo, y0, x0):
            v = accs[(rg, cg)]
            v = v if bias is None else v + pad(bias)
            v = CV.activate_f32(v.permute(2, 0, 1)[None], act, alpha,
                                pad(slope))
            v = v[0].permute(1, 2, 0).to(x.dtype).float()
            store_warp(out, v, words, bb, 2 * wy, 2 * wx)
    assert not torch.isnan(out).any()
    return out.to(x.dtype)


def dyadic(rng, shape, scale):
    """Values k * scale, |k| <= 3: every product and sum of a conv at these
    sizes is exact in f32."""
    return torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32)
                            * scale)


def operands(seed, b, cin, cout, h, w, dtype, exact):
    rng = np.random.default_rng(seed)
    if exact:
        x = dyadic(rng, (b, cin, h, w), 0.25)
        weight = dyadic(rng, (cout, cin, 3, 3), 0.125)
        bias = dyadic(rng, (cout,), 0.5)
        slope = torch.from_numpy(rng.integers(1, 4, cout).astype(
            np.float32) * 0.125)
    else:
        x = torch.from_numpy(rng.normal(size=(b, cin, h, w)).astype(
            np.float32))
        weight = torch.from_numpy((rng.normal(size=(cout, cin, 3, 3))
                                   * 0.2).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
        slope = torch.from_numpy(rng.uniform(0.05, 0.4, cout).astype(
            np.float32))
    return x.to(dtype), weight.to(dtype), bias, slope


def bf16_ulp(x):
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def check(got, want, exact, scale=None):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, r = got.float(), want.float()
    if exact:
        assert torch.equal(g, r)
    elif want.dtype == torch.float32:
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
    else:
        diff = (g - r).abs()
        mag = torch.maximum(r.abs(), scale * 2.0 ** -14)
        assert bool((diff <= bf16_ulp(mag)).all())
        assert float((diff == 0).float().mean()) >= 0.99


# -- the geometry -----------------------------------------------------------

def test_geometry_at_the_v1_head():
    """16 -> 16 at 544x960, B=8: tiles of 8 x 64 conv columns (a window of
    10 rows x 80 columns, 1.56x the tile's pixels), 8160 tiles, four stages
    of 25 KiB, each warp's two transposed windows and its output tile in
    the H100's 227 KiB, both ends by TMA."""
    geo = CV.ps_geometry(8, 16, 16, 544, 960, 1)
    assert geo == CV.PsGeometry(
        nt=2, tile_rows=8, box_rows=10, chunks=1, tiles_x=15, tiles_y=68,
        n_tiles=8160, stages=4, out_bytes=2048, smem_bytes=191_424,
        tma_in=True, tma_out=True)
    assert geo.smem_bytes <= CV.SMEM_OPTIN


GATE_RANGE = [(cin, cout, s) for cin in (1, 3, 16, 17, 24, 32, 48, 64)
              for cout in (4, 8, 12, 16, 20, 32, 36, 64) for s in (1, 2)
              if CV.planar_conv_ok(cin, cout, 64, 64, s, 3, 1, 1)]


@pytest.mark.parametrize("cin,cout,stride", GATE_RANGE)
def test_geometry_fits_the_gate_range(cin, cout, stride):
    """Every conv the planar gate admits (Cin, Cout <= 64, one <= 32) with
    Cout a multiple of 4: it fits in shared memory, a thread holds 32
    accumulators (rows/2 x NT x 4), the window covers the tile's taps, and
    TMA takes exactly the widths whose rows are 16-byte multiples."""
    for h, w in ((544, 960), (38, 61)):
        geo = CV.ps_geometry(2, cin, cout, h, w, stride)
        assert geo.smem_bytes <= CV.SMEM_OPTIN and geo.stages in (2, 3, 4)
        assert 8 * geo.nt >= cout and geo.nt in (1, 2, 4, 8)
        assert geo.tile_rows // 2 * geo.nt * 4 <= 32
        assert geo.box_rows == (geo.tile_rows - 1) * stride + 3
        assert geo.chunks * CV.PS_CHUNK >= cin
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        assert geo.tiles_x * CV.PS_TILE_COLS >= wo
        assert geo.tiles_y * geo.tile_rows >= ho
        assert geo.tma_in == (stride == 1 and w % 8 == 0)
        assert geo.tma_out == ((2 * wo * 2) % 16 == 0)
        assert geo.out_bytes % 128 == 0


@pytest.mark.parametrize("cin,cout,stride", [
    (65, 16, 1), (16, 68, 1), (16, 6, 1), (16, 16, 3), (0, 16, 1)])
def test_geometry_rejects_what_the_kernel_does_not_take(cin, cout, stride):
    with pytest.raises(ValueError, match="B4's conv kernel"):
        CV.ps_geometry(1, cin, cout, 32, 32, stride)


# -- the wrapper --------------------------------------------------------------

class OnCard(torch.Tensor):
    """A CPU tensor that reports cuda:0 as its device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def calls(monkeypatch):
    """The C library replaced by a recorder of its calls."""
    got = []

    def record(name):
        return lambda *args: got.append((name, args)) or 0
    lib = types.SimpleNamespace(rife_conv3x3_ps=record("rife_conv3x3_ps"),
                                rife_conv3x3=record("rife_conv3x3"))
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: _Ctx())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    CV.reset_launches()
    return got


class _Ctx:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def bf16_case(b=2, cin=16, cout=16, h=12, w=24):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(b, cin, h, w)).astype(
        np.float32)).to(torch.bfloat16)
    weight = torch.from_numpy(rng.normal(size=(cout, cin, 3, 3)).astype(
        np.float32)).to(torch.bfloat16)
    return x, weight


def launch(x, weight, **kw):
    card = lambda t: t.as_subclass(OnCard)  # noqa: E731
    wtc = kw.pop("weight_tc", CV.pack_weight_tc(weight))
    kw["weight_tc"] = None if wtc is None else card(wtc)
    parts = kw.pop("parts", [x])
    return CV.conv3x3([card(p) for p in parts], card(weight),
                      card(torch.zeros(weight.shape[0])), ps=kw.pop("ps", 2),
                      **kw)


@pytest.mark.parametrize("stride,w", [(1, 24), (1, 27), (2, 24)])
def test_wrapper_passes_the_geometry(calls, stride, w):
    """One call of ``rife_conv3x3_ps``: x, Cin, the packed weights and
    their padded Cin, bias, slope, out; B, H, W, Cout, stride, activation,
    alpha; the geometry's tile rows, stages and TMA flags.  The output is
    the shuffled shape; one ``conv3x3_ps`` launch."""
    x, weight = bf16_case(w=w)
    out = launch(x, weight, stride=stride, act=CV.ACT_LEAKY, alpha=0.1)
    (name, args), = calls
    assert name == "rife_conv3x3_ps"
    geo = CV.ps_geometry(2, 16, 16, 12, w, stride)
    ho, wo = (12 - 1) // stride + 1, (w - 1) // stride + 1
    assert out.shape == (2, 4, 2 * ho, 2 * wo)
    assert (args[1], args[3]) == (16, 16)
    assert list(args[7:13]) == [2, 12, w, 16, stride, CV.ACT_LEAKY]
    assert args[13].value == pytest.approx(0.1)
    assert list(args[14:18]) == [geo.tile_rows, geo.stages, int(geo.tma_in),
                                 int(geo.tma_out)]
    assert CV.LAUNCHES == {"conv3x3": 0, "conv3x3_ps": 1, "deconv4x4": 0,
                           "bias_act": 0}


def test_wrapper_raises_on_what_the_kernel_does_not_take(calls):
    x, weight = bf16_case()
    bad = [
        (ValueError, "contiguous", dict(
            parts=[x.transpose(2, 3).contiguous().transpose(2, 3)])),
        (ValueError, "16-byte aligned", dict(
            parts=[torch.empty(x.numel() + 1, dtype=x.dtype)[1:]
                   .view(x.shape).copy_(x)])),
        (ValueError, "one input part", dict(
            parts=[x[:, :8].contiguous(), x[:, 8:].contiguous()])),
        (ValueError, "shuffles by 2", dict(ps=4)),
    ]
    for err, what, kw in bad:
        with pytest.raises(err, match=what):
            launch(x, weight, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch(x.half(), weight.half(),
               weight_tc=CV.pack_weight_tc(weight.half()))
    wide, wide_w = bf16_case(cin=80, cout=16)
    with pytest.raises(ValueError, match="B4's conv kernel"):
        launch(wide, wide_w)
    assert calls == []
    assert CV.LAUNCHES["conv3x3_ps"] == 0


def test_f32_keeps_the_cuda_core_kernel_and_the_shuffle(calls):
    """An f32 shuffled conv: the f32 kernel on the CUDA cores (it reads the
    packed weights too), then ``pixel_shuffle``, counted as
    ``conv3x3_ps``."""
    x, weight = bf16_case()
    out = launch(x.float(), weight.float())
    assert [name for name, _ in calls] == ["rife_conv3x3"]
    assert out.shape == (2, 4, 24, 48)
    assert CV.LAUNCHES["conv3x3_ps"] == 1


# -- the walk -----------------------------------------------------------------

WALK_CASES = [
    # (B, Cin, Cout, stride, H, W)
    (2, 16, 16, 1, 18, 136),   # the v1 head's widths; a ragged last tile
    (1, 5, 12, 1, 9, 13),      # odd sizes: the per-thread branches
    (1, 24, 64, 1, 7, 40),     # two chunks, 16 output channels, 2-row tiles
    (1, 64, 16, 1, 10, 24),    # four chunks, two stages
    (1, 16, 32, 1, 9, 70),     # NT 4: 4-row tiles
    (1, 16, 16, 2, 18, 36),    # stride 2
    (1, 32, 36, 2, 10, 26),    # stride 2, NT 8, ragged 9 x 13 conv output
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_matches_twin_on_dyadic_inputs(case, dtype):
    b, cin, cout, stride, h, w = case
    x, weight, bias, slope = operands(sum(case), b, cin, cout, h, w, dtype,
                                      exact=True)
    got = walk(x, CV.pack_weight_tc(weight), bias, slope, stride=stride,
               act=CV.ACT_PRELU)
    want = CV.conv3x3_ref([x], weight, bias, slope, stride=stride,
                          act=CV.ACT_PRELU, ps=2)
    check(got, want, exact=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
def test_walk_every_activation(act, dtype):
    x, weight, bias, slope = operands(7 + act, 1, 16, 16, 10, 70, dtype,
                                      exact=True)
    got = walk(x, CV.pack_weight_tc(weight), bias, slope, act=act,
               alpha=0.25)
    want = CV.conv3x3_ref([x], weight, bias, slope, act=act, alpha=0.25,
                          ps=2)
    check(got, want, exact=True)
    got = walk(x, CV.pack_weight_tc(weight), act=act, alpha=0.25,
               slope=slope)
    want = CV.conv3x3_ref([x], weight, None, slope, act=act, alpha=0.25,
                          ps=2)
    check(got, want, exact=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WALK_CASES[:3] + WALK_CASES[5:6])
def test_walk_matches_twin_on_random_inputs(case, dtype):
    b, cin, cout, stride, h, w = case
    x, weight, bias, slope = operands(3 * sum(case), b, cin, cout, h, w,
                                      dtype, exact=False)
    got = walk(x, CV.pack_weight_tc(weight), bias, slope, stride=stride,
               act=CV.ACT_LEAKY)
    want = CV.conv3x3_ref([x], weight, bias, slope, stride=stride,
                          act=CV.ACT_LEAKY, ps=2)
    scale = CV.conv3x3_ref([x.float().abs()], weight.float().abs(),
                           stride=stride, ps=2)
    check(got, want, exact=False, scale=scale)


def bhcw(x, jd):
    return jnp.asarray(x.float().numpy().transpose(0, 2, 1, 3)).astype(jd)


@pytest.mark.parametrize("jd,td,exact", [
    (jnp.float32, torch.float32, True), (jnp.bfloat16, torch.bfloat16, True),
    (jnp.bfloat16, torch.bfloat16, False)])
def test_walk_matches_conv_ps_planar(jd, td, exact):
    """The Pallas kernel the port replaces, in interpret mode, at the v1
    head's widths (16 -> 16) on a frame with a ragged last tile."""
    x, weight, bias, slope = operands(11, 1, 16, 16, 12, 72, td, exact)
    hwio = jnp.asarray(weight.float().numpy().transpose(2, 3, 1, 0)).astype(
        jd)
    with pltpu.force_tpu_interpret_mode():
        ref = CP.conv_ps_planar(bhcw(x, jd), hwio, jnp.asarray(bias.numpy()),
                                r=2, act=CV.ACT_PRELU, alpha=0.2,
                                slope=jnp.asarray(slope.numpy()))
    want = torch.from_numpy(np.array(ref, np.float32).transpose(
        0, 2, 1, 3)).to(td)
    got = walk(x, CV.pack_weight_tc(weight), bias, slope, act=CV.ACT_PRELU)
    scale = CV.conv3x3_ref([x.float().abs()], weight.float().abs(), ps=2)
    check(got, want, exact=exact, scale=scale)
