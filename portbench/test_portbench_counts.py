"""``portbench/counts.py`` against hand arithmetic, and the configurations'
totals."""

import json

import pytest

from portbench import counts, ncnn, peaks
from portbench.models import v23_arch, v46_arch
from portbench.testing import ROOT

CFG = {n: json.loads((ROOT / "portbench" / "configs" / f"{n}.json")
                     .read_text())
       for n in ("rife-v4.6-arch", "rife-v2.3-arch")}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    v46 = v46_arch.write_flownet_param(root, tuple(CFG["rife-v4.6-arch"]
                                                   ["widths"]))
    v23 = v23_arch.write_v23_params(root, tuple(CFG["rife-v2.3-arch"]
                                                ["widths"]))
    return {"rife-v4.6-arch": counts.count(CFG["rife-v4.6-arch"], v46, 1,
                                           1080, 1920),
            "rife-v2.3-arch": counts.count(CFG["rife-v2.3-arch"], v23, 1,
                                           1080, 1920),
            "v46_b8": counts.count(CFG["rife-v4.6-arch"], v46, 8, 1080,
                                   1920)}


def _site(w, name):
    return next(s for s in w.sites if s.name == name)


def test_conv_site_by_hand(work):
    # v4.6 block 0's first conv: 7 -> 96, 3x3 stride 2, on the 1/8 input
    # 136x240 -> 68x120
    s = _site(work["rife-v4.6-arch"], "conv0_0")
    macs = 96 * 68 * 120 * 7 * 9
    assert s.macs == macs
    assert s.bytes == 2 * (7 * 136 * 240 + 96 * 7 * 9 + 96 * 68 * 120) \
        + 4 * 96
    assert s.least_s == max(2 * macs / peaks.BF16_FLOP_S,
                            s.bytes / peaks.HBM_BYTES_S)


def test_deconv_site_by_hand(work):
    # v4.6 block 3's head: 64 -> 24, 4x4 stride 2 pad 1, 272x480 -> 544x960;
    # the taps inside the output: 4n - 2 an axis
    s = _site(work["rife-v4.6-arch"], "deconv3")
    assert s.macs == 64 * 24 * (4 * 272 - 2) * (4 * 480 - 2)
    assert s.bytes == 2 * (64 * 272 * 480 + 64 * 24 * 16 + 24 * 544 * 960) \
        + 4 * 24


def test_warp_sites_by_hand(work):
    px = 1088 * 1920
    w = work["rife-v4.6-arch"]
    # full-scale entry warp of a frame copy: u8 source, bf16 flow and output
    assert _site(w, "warp_4").bytes == 3 * px + 2 * 2 * px + 2 * 3 * px
    # block 1 entry: its concat is read by a 1/4 downscale, two taps in 4
    assert _site(w, "warp_0").bytes == pytest.approx(
        (3 * px + 4 * px) / 4 + 6 * px / 16)
    # a contextnet feature warp: bf16 source
    f1 = _site(work["rife-v2.3-arch"], "warp_f1")
    c, n = 32, 2 * 272 * 480  # stage 1 (c=32) at 1/4, both frames
    assert f1.bytes == 2 * c * n + 2 * 2 * n + 2 * c * n


def test_totals(work):
    v46, v23 = work["rife-v4.6-arch"], work["rife-v2.3-arch"]
    assert len(v46.of("conv|deconv")) == 44 and len(v46.of("warp")) == 8
    assert len(v23.of("conv|deconv")) == 61 and len(v23.of("warp")) == 12
    assert v46.flop_per_frame == pytest.approx(175.197e9, rel=1e-5)
    assert v23.flop_per_frame == pytest.approx(596.791e9, rel=1e-5)
    assert work["v46_b8"].flop == pytest.approx(8 * v46.flop, rel=1e-12)


def test_frame_blobs_trace_copies():
    nodes = ncnn.parse_param_text(v23_arch.flownet_param_text())
    frames = counts._frame_blobs(nodes, ["input0", "input1"])
    assert "cat_in" in frames and "Slice_img0_0" in frames
    assert "flowx2_0_up" not in frames


def test_v1_gates_are_glue(tmp_path):
    """The v1 graphs at 1080p: the squeeze-excitation gates (Pooling,
    InnerProduct, the gate's multiply) are no site; the convolutions,
    deconvolutions and warps are counted as for the other families."""
    from portbench.models import v1_arch
    from portbench.testing import V1_ARCH

    md = v1_arch.write_v1_params(tmp_path, tuple(V1_ARCH["widths"]))
    w = counts.count(V1_ARCH, md, 1, 1080, 1920)
    assert (len(w.of("conv")), len(w.of("deconv")), len(w.of("warp"))) \
        == (67, 3, 10)
    assert not [s for s in w.sites
                if s.name.endswith(("_fc1", "_fc2", "_pool", "_scale"))]
    assert w.flop_per_frame == pytest.approx(675.306e9, rel=1e-5)
    px = 1088 * 1920
    # block 1's entry warp of a frame copy, read by a 1/4 downscale
    assert _site(w, "warp0_0").bytes == pytest.approx(
        (3 * px + 4 * px) / 4 + 6 * px / 16)
    # the fusionnet's warp of img0: u8 source, full resolution
    assert _site(w, "warp_img0").bytes == 3 * px + 2 * 2 * px + 2 * 3 * px
