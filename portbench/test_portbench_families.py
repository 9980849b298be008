"""Each family's pipeline is found by name, and moving the v4 and v2
pipelines into ``reference/families/`` changed no bit: the ``.bin`` bytes,
the calibration and the counted work equal values recorded from the code
before the move, and the reference frames and flow taps equal those of that
code's pipeline, kept here as it was."""

import hashlib
import importlib

import pytest
import torch

from portbench import counts, harness, scene, weights
from portbench.reference import families
from portbench.reference.rife import (Reference, no_tf32, postprocess,
                                      preprocess)
from portbench.testing import MINI_WIDTHS

# (config, seed) -> (sha256[:16] of each net's .bin, what the weights'
# search found, sha256[:16] of the counted sites), at mini widths on the
# first pair of a 4-frame 64x96 clip of the seed.  The search's readings
# (the flow's std, the bf16 flow error) move in their 7th digit with the
# CPU's thread count; the multiplier and the draw they pick do not.
RECORDED = {
    ("rife-v4.6-arch", 11): (
        {"flownet": "1217544c3c6593e8"},
        {"flow_std_px": 5.998970031738281, "flownet": 0.7593511526612626,
         "draw": 0}, "ed7f5c2f403594a1"),
    ("rife-v4.6-arch", 2 ** 40 + 7): (
        {"flownet": "fa2793d2e3d7c48a"},
        {"flow_std_px": 6.006552696228027, "flownet": 0.7442124173044679,
         "draw": 0}, "ed7f5c2f403594a1"),
    ("rife-v4.6-arch", 3100000001): (
        {"flownet": "f2a265793b9677b7"},
        {"flow_std_px": 5.993225574493408, "flownet": 0.8480745113686781,
         "draw": 0}, "ed7f5c2f403594a1"),
    ("rife-v2.3-arch", 11): (
        {"flownet": "acb3854807c40d71", "contextnet": "c0099a7ebd6de753",
         "fusionnet": "9fdd9cd09754ddc0"},
        {"flow_std_px": 5.99950647354126, "flownet": 1.4438849217783534,
         "draw": 1, "bf16_flow_err": 0.007383076474070549,
         "contextnet": 1.0, "fusionnet": 0.3038}, "6cd8dc44d899760b"),
    ("rife-v2.3-arch", 2 ** 40 + 7): (
        {"flownet": "87adfee811e299ae", "contextnet": "df37a7a14685c9a0",
         "fusionnet": "202c22a125f9ee6b"},
        {"flow_std_px": 5.995296001434326, "flownet": 1.5330253406182408,
         "draw": 0, "bf16_flow_err": 0.004377115983515978,
         "contextnet": 1.0, "fusionnet": 0.3038}, "6cd8dc44d899760b"),
    ("rife-v2.3-arch", 3100000001): (
        {"flownet": "10d5e6b6b1ae9257", "contextnet": "eaa4acae5492102b",
         "fusionnet": "273f840b77182a85"},
        {"flow_std_px": 6.005181312561035, "flownet": 1.3599277272860464,
         "draw": 3, "bf16_flow_err": 0.004152134992182255,
         "contextnet": 1.0, "fusionnet": 0.3038}, "6cd8dc44d899760b"),
}
# config -> (sha256[:16] of the sites, FLOP) of a 1080p B=8 step
RECORDED_1080P = {
    "rife-v4.6-arch": ("6d874691c73ba283", 1401576357888.0),
    "rife-v2.3-arch": ("e1d71936580d4d70", 4774326222848.0),
}


def _h(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _sites(work) -> str:
    return _h(repr([(s.net, s.name, s.kind, s.macs, s.bytes)
                    for s in work.sites]).encode())


def _parent_pair(ref, in0, in1, t):
    """The reference's pipelines as they were before the families moved
    out (``Reference.pair``'s body then), on ``ref``'s nets."""
    h, w = in0.shape[1], in0.shape[2]
    with no_tf32(), torch.no_grad():
        i0 = preprocess(in0.to(ref.device))
        i1 = preprocess(in1.to(ref.device))
        if ref.family == "v4":
            tp = torch.full_like(i0[:, :1], float(t))
            out, flow = ref._run("flownet", {"in0": i0, "in1": i1,
                                             "in2": tp}, ["out0", "flow3"])
            return postprocess(out.float(), h, w), flow[:, :4]
        flow, = ref._run("flownet", {"input0": i0, "input1": i1}, ["flow"])
        feats = ["f1", "f2", "f3", "f4"]
        c0 = ref._run("contextnet", {"input.1": i0,
                                     "flow.0": flow[:, 0:2]}, feats)
        c1 = ref._run("contextnet", {"input.1": i1,
                                     "flow.0": flow[:, 2:4]}, feats)
        inputs = {"img0": i0, "img1": i1, "flow": flow}
        for k, f in enumerate(c0 + c1):
            inputs[str(3 + k)] = f
        out, = ref._run("fusionnet", inputs, ["output"])
        return postprocess(out.float(), h, w), flow


@pytest.mark.parametrize("name,seed", sorted(RECORDED))
def test_v4_v2_bit_for_bit_with_the_parent(tmp_path, name, seed):
    bins, found, sites = RECORDED[(name, seed)]
    cfg = harness.config(name)
    cfg["widths"] = MINI_WIDTHS[name]
    clip = scene.clip(seed, 4, 64, 96, 2, "cpu")
    md, info = weights.write_model(cfg, tmp_path, seed, "cpu", clip[:2])
    info.pop("calibration_s")
    want = dict(found)
    for reading in ("flow_std_px", "bf16_flow_err"):
        assert info.pop(reading, None) == pytest.approx(
            want.pop(reading, None), rel=1e-5)
    assert info == want
    assert {n: _h((md / f"{n}.bin").read_bytes()) for n in cfg["nets"]} \
        == bins
    assert _sites(counts.count(cfg, md, 2, 64, 96)) == sites
    ref = Reference(md, cfg["family"], cfg["nets"], "cpu")
    frames, flow = ref.pair(clip[:3], clip[1:4], 0.5)
    frames0, flow0 = _parent_pair(ref, clip[:3], clip[1:4], 0.5)
    assert torch.equal(frames, frames0)
    assert flow.shape == flow0.shape and torch.equal(flow, flow0)


@pytest.mark.parametrize("name", sorted(RECORDED_1080P))
def test_1080p_work_as_recorded(tmp_path, name):
    cfg = harness.config(name)
    writer = importlib.import_module(cfg["writer"])
    md = getattr(writer, cfg["write"])(tmp_path, tuple(cfg["widths"]))
    work = counts.count(cfg, md, 8, 1080, 1920)
    assert (_sites(work), work.flop) == RECORDED_1080P[name]


@pytest.mark.parametrize("family,tap", [("v4", ("flow3", 4)),
                                        ("v2", ("flow", 4)),
                                        ("v1", ("flow", 2))])
def test_families_found_by_name(family, tap):
    fam = families.load(family)
    assert tuple(fam.TAP) == tap
    for attr in ("flownet_inputs", "pair", "net_inputs"):
        assert callable(getattr(fam, attr))
    x = torch.zeros(1, 3, 64, 96)
    inputs, got = weights.calibration_inputs(
        family, torch.zeros(2, 64, 96, 3, dtype=torch.uint8))
    assert got == fam.TAP
    assert set(inputs) == set(fam.flownet_inputs(x, x))
    with pytest.raises(ModuleNotFoundError):
        families.load("v0")
