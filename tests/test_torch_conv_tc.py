"""The tensor-core ``conv3x3``'s layouts on the CPU, at the 11 sites of a
1080p v2.3 step (``plan.conv_sites`` of the full-width reconstruction) cut
to mini sizes: the packed weights (``pack_weight_tc``) unpack to the OIHW
weights bit for bit, the twin over the packed layout equals ``conv3x3_ref``
bit for bit, the deconv twin (``deconv4x4_ref``, the phases interleaved)
equals ``deconv4x4``'s interleave of the phase conv, and a Python mirror of
the conv kernel's epilogue addressing (channel groups, 16-column tiles,
8-column stores), one of B4's conv kernel's (``csrc/conv_ps.cu``: the
swizzled output tile and its halves, ``mirror_ps_store`` of
tests/test_torch_conv_ps_kernel.py) and one of the deconv kernel's
(``csrc/deconv.cu``: phase rows a warp, interleaved segments, the
PixelShuffle of B4's deconv form) put every value where the twins do.  The
kernels themselves against the twins: tests/test_torch_cuda.py, on the
card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rife_tpu_torch import RIFE
from rife_tpu_torch.engine import plan
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import torch_ops
from test_torch_conv_ps_kernel import mirror_ps_store

N_SITES = 11


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Mini-size tensors gain nothing from torch's thread pool, and the
    suite runs several test processes at once: one thread each keeps them
    from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MINI_HW = (20, 36)  # even, so stride-2 sites keep their gate


@pytest.fixture(scope="module")
def sites(tmp_path_factory):
    d = write_v23_params(tmp_path_factory.mktemp("tc"))
    s = plan.conv_sites(RIFE(str(d), device="cpu"), 1080, 1920)
    assert len(s) == N_SITES
    return s


def site_case(site, dtype, seed):
    """Mini-size parts, weights (phase weights for a deconv site), f32 bias
    and slope of one site."""
    _, parts, cout, stride, act, _, _, deconv = site
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    h, w = MINI_HW
    xs = [t(rng.normal(size=(2, c, h, w))).to(dtype) for c in parts]
    cin = sum(parts)
    if deconv:
        raw = t(rng.normal(size=(cin, cout // 4, 4, 4)) * 0.3)
        weight = CV.deconv_phase_weights(raw).to(dtype)
    else:
        weight = t(rng.normal(size=(cout, cin, 3, 3)) * 0.3).to(dtype)
    bias = t(rng.normal(size=cout))
    slope = t(rng.uniform(0.05, 0.4, cout))
    return xs, weight, bias, slope, stride, act


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("i", range(N_SITES))
def test_packed_weights_unpack_bit_for_bit(sites, i, dtype):
    _, weight, _, _, _, _ = site_case(sites[i], dtype, i)
    cout, cin = weight.shape[:2]
    packed = CV.pack_weight_tc(weight)
    assert packed.shape == (9, cout, CV.padded_cin(cin))
    assert packed.dtype == dtype and packed.is_contiguous()
    assert packed.shape[2] % 16 == 0 and packed.shape[2] - cin < 16
    assert torch.equal(CV.unpack_weight_tc(packed, cin), weight)
    assert not packed[:, :, cin:].any()
    for ky in range(3):
        for kx in range(3):
            assert torch.equal(packed[ky * 3 + kx, :, :cin],
                               weight[:, :, ky, kx])


@pytest.mark.parametrize("i", range(N_SITES))
def test_packed_twin_equals_twin(sites, i):
    xs, weight, bias, slope, stride, act = site_case(sites[i],
                                                    torch.bfloat16, 20 + i)
    packed = CV.pack_weight_tc(weight)
    got = CV.conv3x3_packed_ref(xs, packed, bias, slope, stride=stride,
                                act=act)
    assert torch.equal(got, CV.conv3x3_ref(xs, weight, bias, slope,
                                           stride=stride, act=act))


def kernel_groups(cout, ps=1, most=64):
    """The conv and deconv kernels' channel groups (``rife_conv3x3_tc``:
    at most 64 channels; ``rife_deconv4x4``: ``most`` 24), whole blocks of
    ps^2 channels each."""
    blk = ps * ps
    n = -(-cout // most)
    size = -(-(cout // blk) // n) * blk
    assert size <= most
    return [(g * size, min(size, cout - g * size)) for g in range(n)]


def mirror_store(y, span):
    """Place the (B, N, Ho, Wo) per-channel results as ``csrc/conv.cu``'s
    epilogue does: per channel group, per tile of ``span`` output columns
    (16, the m16 rows of an MMA) and row, lanes of 8 output columns."""
    b, n_ch, ho, wo = y.shape
    out = torch.full((b, n_ch, ho, wo), float("nan"))
    for g0, n_valid in kernel_groups(n_ch):
        for ox0 in range(0, wo, span):
            for oy in range(ho):
                ob = torch.zeros(b, 64, span)  # a warp's staged row
                cols = min(span, wo - ox0)
                ob[:, :n_valid, :cols] = y[:, g0:g0 + n_valid, oy,
                                           ox0:ox0 + cols]
                vecs = span // 8
                for idx in range(n_valid * vecs):
                    n, h = idx // vecs, idx % vecs
                    x0 = ox0 + 8 * h
                    k = min(8, wo - x0)
                    if k > 0:
                        out[:, g0 + n, oy, x0:x0 + k] = \
                            ob[:, n, 8 * h:8 * h + k]
    return out


def mirror_deconv_store(y, ps=1):
    """Place a deconv's (B, O, 2H, 2W) output phase by phase as
    ``csrc/deconv.cu``'s epilogue does: per channel group of at most 24 (NT
    n8 tiles; MT = 2 m16 tiles a warp), per tile of 4 input rows x 32
    columns, warp (row w // 2, phase row py = w % 2) stages phase (py, px)
    of channel n at input column pix in segment n, column 2 pix + px (ps 1)
    or segment 2 (n // 4) + (n // 2) % 2, column 4 pix + 2 px + n % 2 (ps
    2), then writes each segment as 8-column vectors to output channel s
    (ps 1) or s // 2 (ps 2), row ps (2 m + py) + (s % 2 if ps 2)."""
    b, o, h2, w2 = y.shape
    h, w = h2 // 2, w2 // 2
    out = torch.full((b, o // (ps * ps), 2 * ps * h, 2 * ps * w), float("nan"))
    for g0, n_valid in kernel_groups(o, ps, most=24):
        mt, kn = 2, 8 * -(-n_valid // 8)
        tw = 16 * mt
        seg_len = 32 * mt * ps
        n_segs = kn if ps == 1 else kn // 2
        for m0 in range(0, h, 4):
            for tx0 in range(0, w, tw):
                for warp in range(8):
                    m, py = m0 + warp // 2, warp % 2
                    stage = torch.zeros(b, n_segs, seg_len)
                    for px in (0, 1):
                        for n in range(n_valid):
                            xs = range(tx0, min(tx0 + tw, w))
                            pix = torch.tensor([x - tx0 for x in xs])
                            if m >= h or not len(pix):
                                continue
                            vals = y[:, g0 + n, 2 * m + py,
                                     [2 * x + px for x in xs]]
                            if ps == 1:
                                seg, cols = n, 2 * pix + px
                            else:
                                seg = (n >> 2) * 2 + ((n >> 1) & 1)
                                cols = 4 * pix + 2 * px + (n & 1)
                            stage[:, seg, cols] = vals
                    if m >= h:
                        continue
                    segs = n_valid if ps == 1 else n_valid // 2
                    x0 = 2 * ps * tx0
                    for idx in range(segs * (seg_len // 8)):
                        vecs = seg_len // 8
                        sg, c0 = idx // vecs, 8 * (idx % vecs)
                        ch = g0 // (ps * ps) + (sg if ps == 1 else sg >> 1)
                        row = ps * (2 * m + py) + (0 if ps == 1 else sg & 1)
                        k = min(8, 2 * ps * w - x0 - c0)
                        if k > 0:
                            out[:, ch, row, x0 + c0:x0 + c0 + k] = \
                                stage[:, sg, c0:c0 + k]
    return out


@pytest.mark.parametrize("i", range(N_SITES))
def test_kernel_store_addressing(sites, i):
    """A mirror of the epilogue's index arithmetic writes every output once,
    where ``conv3x3_ref`` / ``deconv4x4_ref`` put it; also at widths that
    leave a ragged last tile."""
    xs, weight, bias, slope, stride, act = site_case(sites[i],
                                                    torch.float32, 40 + i)
    deconv = sites[i][-1]
    for cut in (0, 6):
        xs_c = [x[..., :MINI_HW[1] - cut].contiguous() for x in xs]
        if deconv:
            want = CV.deconv4x4_ref(xs_c[0], weight, bias, slope, act=act)
            got = mirror_deconv_store(want)
        else:
            want = CV.conv3x3_ref(xs_c, weight, bias, slope, stride=stride,
                                  act=act)
            got = mirror_store(want, 16)
        assert not torch.isnan(got).any()
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", [
    ("conv", 16, 16, 1), ("conv", 8, 64, 1), ("conv", 12, 36, 2),
    ("conv", 6, 36, 1), ("deconv", 12, 4 * 8, 1), ("deconv", 8, 4 * 24, 1),
    ("deconv", 16, 4 * 32, 1), ("deconv", 16, 4 * 128, 1)])
def test_kernel_ps_store_addressing(case):
    """B4: the kernels' shuffled stores write every output once, where the
    twins put them (``pixel_shuffle`` of ``conv3x3_ref`` / of
    ``deconv4x4_ref``): B4's conv kernel (``mirror_ps_store``) at the v1
    head (16 -> 16), 64 output channels (2-row tiles), 36 (NT 8 at stride
    2: 2-row tiles, a part-filled last n8 tile); deconvs of 8 to 128 output
    channels (v1's up0: six groups of 22 and the rest;
    ``mirror_deconv_store``), at widths that leave a ragged last tile and,
    at stride 2, odd output sizes."""
    kind, cin, cout, stride = case
    rng = np.random.default_rng(cin * cout)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    for h, w in ((10, 40), (9, 27)):
        x = t(rng.normal(size=(2, cin, h, w)))
        if kind == "deconv":
            raw = t(rng.normal(size=(cin, cout // 4, 4, 4)) * 0.3)
            weight = CV.deconv_phase_weights(raw)
        else:
            weight = t(rng.normal(size=(cout, cin, 3, 3)) * 0.3)
        if kind == "deconv":
            got = mirror_deconv_store(CV.deconv4x4_ref(x, weight), ps=2)
            want = CV.deconv4x4_ref(x, weight, ps=2)
        else:
            got = mirror_ps_store(CV.conv3x3_ref([x], weight, stride=stride),
                                  stride)
            want = CV.conv3x3_ref([x], weight, stride=stride, ps=2)
        assert got.shape == want.shape
        assert not torch.isnan(got).any()
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("i", range(N_SITES))
def test_deconv_twin_equals_interleaved_phase_conv(sites, i, dtype):
    """At a deconv site the fused plain version equals what ``deconv4x4``
    computed before (the phase conv, then ``interleave_phases``); at a conv
    site the phase weights of a random transposed conv of its width give the
    same identity, and in f32 both equal ``conv_transpose2d``."""
    _, parts, cout, _, act, _, _, deconv = sites[i]
    cin = sum(parts)
    co = cout // 4 if deconv else max(1, cout // 8)
    rng = np.random.default_rng(60 + i)
    x = torch.from_numpy(rng.normal(size=(1, cin, 10, 18)).astype(
        np.float32)).to(dtype)
    raw = torch.from_numpy((rng.normal(size=(cin, co, 4, 4)) * 0.3).astype(
        np.float32))
    w3 = CV.deconv_phase_weights(raw).to(dtype)
    bias = torch.from_numpy(np.tile(rng.normal(size=co), 4).astype(
        np.float32))
    slope = torch.from_numpy(np.tile(rng.uniform(0.05, 0.4, co), 4).astype(
        np.float32))
    got = CV.deconv4x4_ref(x, w3, bias, slope, act=act)
    want = CV.interleave_phases(CV.conv3x3([x], w3, bias, slope, stride=1,
                                           act=act))
    assert torch.equal(got, want)
    assert torch.equal(CV.deconv4x4(x, w3, bias, slope, act=act), got)
    if dtype == torch.float32:
        ref = F.conv_transpose2d(x, raw, bias[:co], stride=2, padding=1)
        # the repo's f32 conv bar: 1e-5 of the largest output
        torch.testing.assert_close(CV.deconv4x4_ref(x, w3, bias[:co].repeat(4)),
                                   ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


def test_session_weights_are_packed_once(tmp_path):
    """``prepare_weights`` packs every 3x3 conv's weights and every 4x4
    stride-2 deconv's weights (``pack_weight_t4``) once; they unpack to the
    plain tensors."""
    d = write_v23_params(tmp_path, (8, 8, 8, 8, 4))
    sess = RIFE(str(d), device="cpu", dtype=torch.bfloat16)
    n_conv = n_deconv = 0
    for net, tree in sess.weights.items():
        graph = sess.executors[net].graph
        kinds = {n.name: n.type for n in graph.nodes}
        for name, e in tree.items():
            w = e.get("weight")
            if kinds[name] in torch_ops._CONV_KINDS and w.shape[2:] == (3, 3):
                assert torch.equal(
                    CV.unpack_weight_tc(e["weight_tc"], w.shape[1]), w)
                n_conv += 1
            if "weight_t4" in e:
                assert torch.equal(
                    CV.unpack_weight_t4(e["weight_t4"], w.shape[0]), w)
                n_deconv += 1
    assert n_conv > 20 and n_deconv >= 4
