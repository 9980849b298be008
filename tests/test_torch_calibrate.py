"""The port's calibration tool (``rife_tpu_torch/models/calibrate.py``)
against ``rife_tpu/models/calibrate.py``, on the CPU, f32, at 64x96 on
mini-width reconstructions written under their zoo names (v4.6, v2.3, v1
``rife``), from seeded smooth frames.

``rife_tpu`` is run as it is: its ``_frames`` and ``TEST_HW`` are
monkeypatched to the test's frames, and its zoo root to the test's model
root, so that it gets the zoo **name** (its ``_make_eval`` tags the
synthetic weights, and looks up the baked scale, by the string it is
given); the port is given the same root and tags by the resolved dir's
name.

Bars: the two flownet searches bit for bit on a stub evaluation; the
flownet evaluation within 1e-4 relative (measured: <= 2e-6; on the CPU
``rife_tpu``'s raw ``rife.Warp`` takes XLA's ``warp_at``, the port the
Pallas kernels' form); ``calibrate`` within one final bisection interval
in log space, log(30)/2**11; ``calibrate_fusionnet`` the same grid point
and the u8 output std within 0.05.
"""

import math

import numpy as np
import pytest
import torch

import rife_tpu.models.calibrate as jcal
import rife_tpu.models.zoo as jzoo
from rife_tpu_torch.graph.weights import SYNTHETIC_FLOWNET_SCALE
from rife_tpu_torch.models import calibrate as cal
from rife_tpu_torch.models import zoo
from rife_tpu_torch.models.v1_arch import write_v1_params
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.models.v46_arch import write_flownet_param

HW = (64, 96)
MODELS = ("rife-v4.6", "rife-v2.3", "rife")
FLOW_REL = 1e-4
LOG_INTERVAL = math.log(30) / 2 ** 11
OUT_STD_ABS = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Mini-width tensors gain nothing from torch's thread pool, and the
    suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def smooth_frames(seed=0):
    """(1,H,W,3) float32 frames in [0, 1]: a few random low-frequency
    waves a channel; the second frame is the first moved by 3 px."""
    rng = np.random.default_rng(seed)
    h, w = HW
    y, x = np.mgrid[0:h, 0:w + 3].astype(np.float32)
    planes = []
    for _ in range(3):
        v = np.full((h, w + 3), 0.5, np.float32)
        for _ in range(3):
            ky, kx = rng.uniform(-0.08, 0.08, 2)
            v += 0.12 * np.sin(ky * y + kx * x + rng.uniform(0, 2 * np.pi))
        planes.append(v)
    img = np.clip(np.stack(planes, -1), 0.0, 1.0).astype(np.float32)
    return (np.ascontiguousarray(img[None, :, :w]),
            np.ascontiguousarray(img[None, :, 3:]))


FRAMES = smooth_frames()


@pytest.fixture(scope="module")
def model_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("calmodels")
    write_flownet_param(root, (16, 16, 16, 16))
    write_v23_params(root, (8, 8, 8, 8, 4))
    write_v1_params(root, (8, 8, 8, 4), "rife")
    return root


def patch_rife_tpu(mp, root):
    """Point ``rife_tpu``'s calibration at the test's models and frames."""
    mp.setattr(jzoo, "DEFAULT_MODEL_ROOT", root)
    mp.setattr(jcal, "_frames", lambda h, w: FRAMES)
    mp.setattr(jcal, "TEST_HW", HW)


@pytest.fixture(scope="module")
def jax_flownet_eval(model_root):
    """``rife_tpu``'s ``_make_eval(name)``, built once a model."""
    evals = {}

    def get(name):
        if name not in evals:
            with pytest.MonkeyPatch.context() as mp:
                patch_rife_tpu(mp, model_root)
                evals[name] = jcal._make_eval(name)
        return evals[name]
    return get


def test_constants_and_zoo_names_are_rife_tpus():
    assert (cal.TARGET_FLOW_STD, cal.TEST_HW, cal.TARGET_OUT_STD) == (
        jcal.TARGET_FLOW_STD, jcal.TEST_HW, jcal.TARGET_OUT_STD)
    assert zoo.MODEL_NAMES == jzoo.MODEL_NAMES


# (a) the flownet search on stub evaluations: monotone responses, one
# whose target lies inside the bracket, one at each edge
STUBS = {
    "cubic": lambda s: 6.0 * (s / 0.7) ** 3,
    "exp": lambda s: math.exp(9.0 * (s - 0.9)) * 6.0,
    "all_above": lambda s: 100.0 + s,
    "all_below": lambda s: s * 1e-3,
}


@pytest.mark.parametrize("stub", sorted(STUBS))
def test_flownet_search_bit_for_bit(monkeypatch, stub):
    fn = STUBS[stub]
    monkeypatch.setattr(jcal, "_make_eval", lambda name: fn)
    monkeypatch.setattr(cal, "make_flownet_eval", lambda *a, **k: fn)
    want = jcal.calibrate("rife-v4.6")
    got = cal.calibrate("rife-v4.6", FRAMES, device="cpu")
    assert got == want
    assert type(got[0]) is type(want[0]) and type(got[1]) is type(want[1])
    assert cal.at_search_edge(got[0]) == stub.startswith("all_")


# (b) the flownet evaluation against rife_tpu's at three scales
@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("which", ["0.3", "baked", "1.2"])
def test_flownet_eval_matches_rife_tpu(model_root, jax_flownet_eval, name,
                                       which):
    s = SYNTHETIC_FLOWNET_SCALE[name] if which == "baked" else float(which)
    want = jax_flownet_eval(name)(s)
    got = cal.make_flownet_eval(name, FRAMES, device="cpu",
                                model_root=model_root)(s)
    assert math.isfinite(got) and got > 0
    assert abs(got - want) <= FLOW_REL * want, (got, want)


def test_flownet_eval_tags_by_dir_name(model_root):
    """A full path and the zoo name give the same synthetic weights and
    baked scale (the port tags by the resolved dir's name)."""
    by_name = cal.make_flownet_eval("rife-v4.6", FRAMES, device="cpu",
                                    model_root=model_root)
    by_path = cal.make_flownet_eval(str(model_root / "rife-v4.6"), FRAMES,
                                    device="cpu")
    assert by_name(0.5) == by_path(0.5)


# (c) the search end to end on the v4.6 reconstruction
def test_calibrate_v46_end_to_end(monkeypatch, model_root):
    patch_rife_tpu(monkeypatch, model_root)
    want = jcal.calibrate("rife-v4.6")
    got = cal.calibrate("rife-v4.6", FRAMES, device="cpu",
                        model_root=model_root)
    assert abs(math.log(got[0] / want[0])) <= LOG_INTERVAL, (got, want)
    if got[0] == want[0]:
        assert abs(got[1] - want[1]) <= FLOW_REL * want[1], (got, want)


# (d) the fusionnet sweep
@pytest.mark.parametrize("name", ["rife-v2.3", "rife"])
def test_calibrate_fusionnet_matches_rife_tpu(monkeypatch, model_root, name):
    patch_rife_tpu(monkeypatch, model_root)
    want = jcal.calibrate_fusionnet(name)
    got = cal.calibrate_fusionnet(name, FRAMES, device="cpu",
                                  model_root=model_root)
    assert got[0] == want[0], (got, want)  # the same grid point
    assert abs(got[1] - want[1]) <= OUT_STD_ABS, (got, want)


def test_calibrate_fusionnet_v4_has_none(monkeypatch, model_root):
    patch_rife_tpu(monkeypatch, model_root)
    assert jcal.calibrate_fusionnet("rife-v4.6") == (None, None)
    assert cal.calibrate_fusionnet("rife-v4.6", FRAMES, device="cpu",
                                   model_root=model_root) == (None, None)


@pytest.mark.parametrize("name", MODELS)
def test_flownet_tap_is_the_evals(model_root, name):
    """``make_flownet_tap`` returns the whole tap, NCHW, whose
    ``flow_std`` is exactly what ``make_flownet_eval`` reads."""
    s = SYNTHETIC_FLOWNET_SCALE[name]
    tap = cal.make_flownet_tap(name, FRAMES, device="cpu",
                               model_root=model_root)(s)
    assert tap.dtype == torch.float32 and tap.shape[:2] == (
        1, {"rife-v4.6": 6, "rife-v2.3": 4, "rife": 2}[name])
    assert bool(torch.isfinite(tap).all())
    assert cal.flow_std(tap) == cal.make_flownet_eval(
        name, FRAMES, device="cpu", model_root=model_root)(s)


def test_fusionnet_step_is_the_evals(model_root):
    """``make_fusionnet_step`` returns the u8 frame whose std is what
    ``make_fusionnet_eval`` reads; v4 has none."""
    step, baked = cal.make_fusionnet_step("rife-v2.3", FRAMES, device="cpu",
                                          model_root=model_root)
    out = step(1.0)
    assert baked == 0.3038
    assert out.dtype == torch.uint8 and out.shape == (1, *HW, 3)
    eval_scale = cal.make_fusionnet_eval("rife-v2.3", FRAMES, device="cpu",
                                         model_root=model_root)[0]
    assert float(out.numpy().std()) == eval_scale(1.0)
    assert cal.make_fusionnet_step("rife-v4.6", FRAMES, device="cpu",
                                   model_root=model_root) == (None, None)


def test_fusionnet_eval_leaves_session_weights(model_root):
    """Each scale re-prepares the fusionnet from the raw weights: the
    baked multiplier 1 reads the same std before and after another."""
    eval_scale, baked = cal.make_fusionnet_eval(
        "rife-v2.3", FRAMES, device="cpu", model_root=model_root)
    assert baked == 0.3038
    first = eval_scale(1.0)
    eval_scale(3.0)
    assert eval_scale(1.0) == first


def write_png(path, frame):
    from PIL import Image

    Image.fromarray((frame[0] * 255).astype(np.uint8)).save(path)


def test_main_prints_the_tables(monkeypatch, capsys, tmp_path, model_root):
    """``main`` loads and resizes the frames, runs both searches on every
    model dir given and prints the tables keyed by the dirs' names."""
    monkeypatch.setattr(cal, "TEST_HW", HW)
    a, b = tmp_path / "0.png", tmp_path / "1.png"
    write_png(a, FRAMES[0])
    write_png(b, FRAMES[1])
    dirs = [str(model_root / n) for n in ("rife-v4.6", "rife")]
    assert cal.main(["--frames", str(a), str(b), "--device", "cpu",
                     *dirs]) == 0
    out = capsys.readouterr().out
    frames = cal.load_frames(str(a), str(b), HW)
    flow = {n: cal.calibrate(str(model_root / n), frames, "cpu")[0]
            for n in ("rife-v4.6", "rife")}
    fus = cal.calibrate_fusionnet(str(model_root / "rife"), frames, "cpu")[0]
    assert f"SYNTHETIC_FLOWNET_SCALE = {flow}" in out
    assert f"SYNTHETIC_FUSIONNET_SCALE = {{'rife': {fus}}}" in out


# (e) missing inputs raise, nothing stands in for them
def test_missing_frames_raise(tmp_path, model_root):
    with pytest.raises(FileNotFoundError):
        cal.load_frames(str(tmp_path / "a.png"), str(tmp_path / "b.png"), HW)
    with pytest.raises(FileNotFoundError):
        cal.main(["--frames", str(tmp_path / "a.png"),
                  str(tmp_path / "b.png"), "--device", "cpu",
                  str(model_root / "rife-v4.6")])


@pytest.mark.parametrize("fn", ["make_flownet_eval", "make_fusionnet_eval"])
def test_missing_model_dir_raises(tmp_path, fn):
    with pytest.raises(FileNotFoundError):
        getattr(cal, fn)("rife-v2.3", FRAMES, device="cpu",
                         model_root=tmp_path)


def test_main_default_models_missing_raise(monkeypatch, tmp_path):
    """Without model dirs ``main`` takes the zoo's names under ./models."""
    monkeypatch.chdir(tmp_path)
    a = tmp_path / "0.png"
    write_png(a, FRAMES[0])
    with pytest.raises(FileNotFoundError, match="rife"):
        cal.main(["flownet", "--frames", str(a), str(a), "--device", "cpu"])


# (f) CUDA without a card raises
@pytest.mark.parametrize("fn", ["calibrate", "calibrate_fusionnet"])
def test_cuda_without_a_card_raises(monkeypatch, model_root, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(cal, fn)("rife-v2.3", FRAMES, model_root=model_root)
