"""The port's CLI (``python -m rife_tpu_torch.cli``) against ``rife_tpu.cli``
on the CPU (``-g -1``), on the in-repo reconstructions at mini widths with
synthetic weights: the same parsing and planning, the same return codes on
invalid input, and outputs within the session tests' f32 bar (u8 max |d| <=
1 and >= 99.9% exact: on the CPU ``rife_tpu`` warps with XLA's ``warp_at``
and the port with the twins of the Pallas kernels).  Then the port's own
rules: without a card only ``-g -1`` runs (``-g all`` included), a v1 dir
runs, and ``RIFE_TORCH_RANK``/``RIFE_TORCH_WORLD`` split the outputs.
"""

import dataclasses
import getopt
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import rife_tpu.cli as jax_cli
from rife_tpu_torch import cli
from rife_tpu_torch.models.v1_arch import write_v1_params
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.models.v46_arch import write_flownet_param

V46_MINI = (16, 16, 16, 16)
V23_MINI = (8, 8, 8, 8, 4)
V1_MINI = (8, 8, 8, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once: one torch thread each
    keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("climodels")
    return {"v4.6": str(write_flownet_param(root, V46_MINI)),
            "v2.3": str(write_v23_params(root, V23_MINI))}


def write_frames(d: Path, n, h, w, seed=0):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            d / f"{i:03d}.png")
    return d


def read_dir(d: Path):
    return {n: np.asarray(Image.open(d / n)) for n in sorted(os.listdir(d))}


def assert_u8_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


# -- parsing and planning: equal to rife_tpu.cli --------------------------

ARGVS = [
    [],
    ["-0", "a.png", "-1", "b.png", "-o", "o.png"],
    ["-i", "in", "-o", "out", "-n", "7", "-s", "0.25", "-m", "rife-v4.6"],
    ["-g", "-1", "-j", "2:4,4:3", "-x", "-z", "-u", "-v", "-f", "%06d.jpg"],
    ["-g", "0,1,1", "-h"],
    ["-xzuv", "-g-1", "-mmodels/rife-v2.3"],
    ["-s", "1e-3", "-n", "-2", "-o", "-o"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_equals_rife_tpu(argv):
    assert cli.OPTSTRING == jax_cli.OPTSTRING
    assert (dataclasses.asdict(cli.parse_args(argv))
            == dataclasses.asdict(jax_cli.parse_args(argv)))


@pytest.mark.parametrize("argv", [["-q"], ["-n", "x"], ["-s", "half"],
                                  ["-g"]])
def test_parse_args_errors_equal_rife_tpu(argv):
    errors = []
    for mod in (cli, jax_cli):
        try:
            mod.parse_args(argv)
        except (getopt.GetoptError, ValueError) as e:
            errors.append(type(e))
    assert len(errors) == 2 and errors[0] is errors[1]


@pytest.mark.parametrize("text", ["1:2:2", "2:2,4,4:3", "1::2", "0:1:1",
                                  "1:2", "1:2:3:4", "a:1:1", "1:,2,:1"])
def test_parse_jobs_equals_rife_tpu(text):
    def run(mod):
        try:
            return mod.parse_jobs(text)
        except ValueError as e:
            return type(e)
    assert run(cli) == run(jax_cli)


@pytest.mark.parametrize("out,fmt", [
    ("out.png", "%08d.png"), ("out.WEBP", "%08d.png"), ("out.jpeg", "x.png"),
    ("out.tiff", "%08d.png"), ("DIR", "webp"), ("DIR", "%06d.jpg"),
    ("DIR", "%08d.bmp"), ("DIR", ".png"), ("out", "%08d.png")])
def test_guess_format_equals_rife_tpu(tmp_path, out, fmt):
    out = str(tmp_path) if out == "DIR" else out

    def run(mod):
        try:
            return mod.guess_format(out, fmt)
        except ValueError as e:
            return str(e)
    assert run(cli) == run(jax_cli)


@pytest.mark.parametrize("count,numframe", [(2, 0), (4, 0), (4, 9), (5, 3),
                                            (3, 1), (1, 0)])
def test_plan_directory_jobs_equals_rife_tpu(tmp_path, count, numframe):
    ind = tmp_path / "in"
    ind.mkdir()
    for i in range(count):
        (ind / f"{i:03d}.png").write_bytes(b"x")
    (ind / ".hidden").write_bytes(b"x")
    (ind / "sub").mkdir()

    def run(mod):
        try:
            return mod.plan_directory_jobs(str(ind), str(tmp_path / "o"),
                                           numframe, "%08d", "png")
        except ValueError as e:
            return str(e)
    assert run(cli) == run(jax_cli)


# the invalid cases of tests/test_cli.py:test_cli_validation_errors
INVALID = [
    ["-0", "A", "-1", "B"],
    ["-0", "A", "-1", "B", "-o", "O/o.png", "-s", "1.5"],
    ["-0", "A", "-1", "B", "-o", "O/o.png", "-m", "rife-v2.3", "-s", "0.3"],
    ["-i", "O", "-o", "O", "-m", "rife-v2.3", "-n", "7"],
    ["-0", "A", "-1", "B", "-o", "O/o.tiff"],
    ["-0", "A", "-1", "B", "-o", "O/o.png", "-m", "unknown-model"],
    ["-0", "A", "-1", "B", "-o", "O/o.png", "-j", "0:1:1"],
    ["-q"],
    ["-i", "O", "-o", "O", "-m", "rife-v4.6", "-n", "-1"],
    ["-i", "O", "-o", "O/o.png", "-m", "rife-v4.6"],
    ["-0", "A", "-1", "B", "-o", "O/o.png", "-j", "1:2"],
]


@pytest.mark.parametrize("argv", INVALID)
def test_invalid_input_return_codes_equal_rife_tpu(tmp_path, argv):
    write_frames(tmp_path, 2, 32, 32)
    subst = {"A": str(tmp_path / "000.png"), "B": str(tmp_path / "001.png")}
    argv = [subst.get(a, a.replace("O", str(tmp_path), 1)
                      if a.startswith("O") else a) for a in argv]
    rc = cli.main(argv)
    assert rc == jax_cli.main(argv)
    assert rc == 255


def test_help_returns_0():
    assert cli.main(["-h"]) == jax_cli.main(["-h"]) == 0


# -- outputs against rife_tpu.cli on the CPU ------------------------------

E2E = {
    # name: (model, frames (n, h, w), argv after the model and -g -1)
    "v4.6 directory": ("v4.6", (4, 64, 96), ["-i", "IN", "-o", "OUT"]),
    "v4.6 -n 3 one pair": ("v4.6", (2, 64, 96),
                           ["-0", "IN/000.png", "-1", "IN/001.png", "-o",
                            "OUT", "-n", "3"]),
    "v2.3 pair": ("v2.3", (2, 64, 96),
                  ["-0", "IN/000.png", "-1", "IN/001.png", "-o",
                   "OUT/mid.png"]),
    "v4.6 -x -z pair t=0.25": ("v4.6", (2, 50, 70),
                               ["-0", "IN/000.png", "-1", "IN/001.png", "-o",
                                "OUT/mid.webp", "-x", "-z", "-s", "0.25"]),
    "v2.3 -u": ("v2.3", (3, 64, 128),
                ["-i", "IN", "-o", "OUT", "-u", "-j", "1:1:1",
                 "-f", "%04d.webp"]),
}


@pytest.mark.parametrize("case", list(E2E))
def test_outputs_match_rife_tpu_cli(tmp_path, models, case):
    model, (n, h, w), rest = E2E[case]
    ind = write_frames(tmp_path / "in", n, h, w, seed=len(case))
    outs = {}
    for tag, main in (("port", cli.main), ("jax", jax_cli.main)):
        outd = tmp_path / tag
        outd.mkdir()
        argv = [a.replace("IN", str(ind)).replace("OUT", str(outd))
                for a in rest]
        assert main(argv + ["-m", models[model], "-g", "-1"]) == 0, tag
        outs[tag] = read_dir(outd)
    assert outs["port"].keys() == outs["jax"].keys() and outs["port"]
    got = np.stack(list(outs["port"].values()))
    want = np.stack(list(outs["jax"].values()))
    assert got.shape[1:] == (h, w, 3)
    assert_u8_close(got, want)


# -- the port's own rules -------------------------------------------------

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


@pytest.mark.parametrize("gflag", [None, "0", "0,-1", "-1,1", "all"])
def test_without_a_card_only_the_cpu_runs(tmp_path, models, no_card, gflag,
                                          capsys):
    ind = write_frames(tmp_path / "in", 2, 32, 32)
    outd = tmp_path / "out"
    outd.mkdir()
    argv = ["-i", str(ind), "-o", str(outd), "-m", models["v4.6"]]
    assert cli.main(argv + (["-g", gflag] if gflag else [])) == 255
    assert os.listdir(outd) == []
    err = capsys.readouterr().err
    assert "-g -1" in err


def test_invalid_device_ids(tmp_path, models, monkeypatch, capsys):
    """With a card, an id past the last one, or one below -1, is an
    invalid device (no session is built)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    ind = write_frames(tmp_path / "in", 2, 32, 32)
    argv = ["-i", str(ind), "-o", str(tmp_path), "-m", models["v4.6"]]
    for gflag in ("1", "0,2", "-2", "x"):
        assert cli.main(argv + ["-g", gflag]) == 255
        assert "invalid device" in capsys.readouterr().err


def test_v1_model_dir_is_refused(tmp_path, models):
    """A v1 dir (no rife-v2/v3/v4 in its path) is no longer refused: the CLI
    runs it on the CPU and writes what the session computes for the pair,
    byte for byte; -s other than 0.5 is refused as for v2."""
    from rife_tpu_torch import RIFE

    v1 = write_v1_params(tmp_path / "m", V1_MINI)
    write_frames(tmp_path, 2, 40, 56)
    argv = ["-0", str(tmp_path / "000.png"), "-1", str(tmp_path / "001.png"),
            "-o", str(tmp_path / "o.png"), "-m", str(v1), "-g", "-1"]
    assert cli.main(argv) == 0
    a, b = (np.asarray(Image.open(tmp_path / f"00{i}.png")) for i in (0, 1))
    want = RIFE(str(v1), device="cpu").process(a, b)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "o.png")), want)
    assert cli.main(argv + ["-s", "0.25"]) == 255


def test_ranks_write_disjoint_complete_outputs(tmp_path, models, monkeypatch):
    ind = write_frames(tmp_path / "in", 3, 32, 32)
    argv = ["-i", str(ind), "-m", models["v4.6"], "-n", "6", "-g", "-1"]
    written = {}
    monkeypatch.setenv("RIFE_TORCH_WORLD", "2")
    for rank in (0, 1):
        outd = tmp_path / f"out{rank}"
        outd.mkdir()
        monkeypatch.setenv("RIFE_TORCH_RANK", str(rank))
        assert cli.main(argv + ["-o", str(outd)]) == 0
        written[rank] = set(os.listdir(outd))
    assert written[0] and written[1]
    assert written[0].isdisjoint(written[1])
    assert written[0] | written[1] == {f"{i:08d}.png" for i in range(1, 7)}
    for rank, world in (("2", "2"), ("-1", "2"), ("x", "2"), ("0", "y")):
        monkeypatch.setenv("RIFE_TORCH_RANK", rank)
        monkeypatch.setenv("RIFE_TORCH_WORLD", world)
        assert cli.main(argv + ["-o", str(tmp_path / "out0")]) == 255


def test_reads_no_rife_tpu_rank(tmp_path, models, monkeypatch):
    """``RIFE_TPU_RANK``/``WORLD`` are the JAX package's; the port ignores
    them and writes every output."""
    ind = write_frames(tmp_path / "in", 2, 32, 32)
    monkeypatch.setenv("RIFE_TPU_WORLD", "2")
    monkeypatch.setenv("RIFE_TPU_RANK", "1")
    outd = tmp_path / "out"
    outd.mkdir()
    assert cli.main(["-i", str(ind), "-o", str(outd), "-m", models["v4.6"],
                     "-g", "-1"]) == 0
    assert len(os.listdir(outd)) == 4


def test_two_cpu_sessions_equal_one(tmp_path, models):
    """``-g -1,-1``: two sessions over one queue write the outputs of one
    session, within the f32 bar: two CPU steps that run at once may round
    otherwise than one alone (measured: 1 LSB on a few pixels with torch's
    default thread pool, none with one thread); the card holds the two to
    bit equality (``chip_smoke.py``)."""
    ind = write_frames(tmp_path / "in", 5, 32, 64, seed=2)
    outs = {}
    for tag, g, j in (("one", "-1", "1:2:2"), ("two", "-1,-1", "1:2,2:2")):
        outd = tmp_path / tag
        outd.mkdir()
        assert cli.main(["-i", str(ind), "-o", str(outd), "-m",
                         models["v4.6"], "-g", g, "-j", j]) == 0
        outs[tag] = read_dir(outd)
    assert outs["one"].keys() == outs["two"].keys()
    assert_u8_close(np.stack(list(outs["two"].values())),
                    np.stack(list(outs["one"].values())))


def test_any_synthetic_equals_rife_tpu(models, tmp_path):
    from rife_tpu.models import zoo as jax_zoo
    from rife_tpu_torch.models import zoo

    for d in models.values():
        port, ref = zoo.load_model(d), jax_zoo.load_model(d)
        assert port.any_synthetic is ref.any_synthetic is True
    for synth in ((False, False), (False, True)):
        port = zoo.LoadedModel("m", "v2", {
            str(i): zoo.LoadedNet(None, {}, s) for i, s in enumerate(synth)})
        ref = jax_zoo.LoadedModel("m", "v2", {
            str(i): jax_zoo.LoadedNet(None, {}, s)
            for i, s in enumerate(synth)})
        assert port.any_synthetic == ref.any_synthetic == any(synth)


def test_stage_failure_exits_1_as_rife_tpu(tmp_path, models, capsys):
    """A frame that does not decode is a load-stage error: the other
    outputs are written, the error is printed and the run exits 1, as
    ``rife_tpu.cli`` does."""
    rcs = {}
    for tag, main in (("port", cli.main), ("jax", jax_cli.main)):
        ind = write_frames(tmp_path / tag / "in", 3, 32, 32)
        (ind / "001.png").write_bytes(b"not a png")
        outd = tmp_path / tag / "out"
        outd.mkdir()
        rcs[tag] = main(["-i", str(ind), "-o", str(outd), "-m",
                         models["v4.6"], "-g", "-1"])
        assert "decode" in capsys.readouterr().err
    assert rcs == {"port": 1, "jax": 1}
