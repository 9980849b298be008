"""parallel/sharding.py on the CPU: meshes, batch sharding, the launches
``engine/plan.py`` counts for sharded steps, and ``-g all``.

Batch sharding runs the session's own pipeline per data shard, so its
rows equal a plain session's at the shard batch bit for bit (a frame's
bytes may depend on the B of its step: the bar never compares across B).
Against ``rife_tpu``'s ``ShardedRIFE`` on the 8-device virtual mesh of
``tests/conftest.py`` the bar is the session tests' f32 one (u8 max |d| <=
1 and >= 99.9% exact: XLA's ``warp_at`` against the Pallas forms).
"""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import rife_tpu.cli as jax_cli
from rife_tpu_torch import RIFE, cli
from rife_tpu_torch.engine import plan
from rife_tpu_torch.io import runner as port_runner
from rife_tpu_torch.models.v1_arch import write_v1_params
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.models.v46_arch import write_flownet_param
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import warp as W
from rife_tpu_torch.parallel import sharding as S

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharding")
    return {"v4.6": str(write_flownet_param(root, (16, 16, 16, 16))),
            "v2.3": str(write_v23_params(root, (8, 8, 8, 8, 4))),
            "v1": str(write_v1_params(root, (8, 8, 8, 4), "rife"))}


def frames(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, h, w, 3), np.uint8),
            rng.integers(0, 256, (b, h, w, 3), np.uint8))


def assert_u8_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


def timesteps(n):
    return np.linspace(0.2, 0.8, n).astype(np.float32)


def per_shard_session(sess, a, b, ts, n_data):
    """The plain session on each data shard's rows (the batch padded to a
    multiple of ``n_data`` by replaying the last pair), padding dropped."""
    n = len(a)
    per = -(-n // n_data)
    idx = [min(i, n - 1) for i in range(per * n_data)]
    a, b, ts = a[idx], b[idx], ts[idx]
    return np.concatenate([sess.process_batch(a[i:i + per], b[i:i + per],
                                              ts[i:i + per])
                           for i in range(0, len(a), per)])[:n]


@pytest.fixture(scope="module")
def rife_tpu_batch(model_dirs):
    """rife_tpu's batch-sharded outputs, {(n_devices, B): u8}."""
    from rife_tpu.engine.session import RIFE as JaxRIFE
    from rife_tpu.parallel.sharding import ShardedRIFE as JaxSharded
    from rife_tpu.parallel.sharding import make_mesh as jax_mesh

    out = {}
    for n in (8, 4):
        sess = JaxSharded(JaxRIFE(model_dirs["v4.6"]),
                          jax_mesh(jax.devices()[:n]))
        for bsz in (8, 3):
            a, b = frames(bsz, 64, 64, seed=bsz)
            out[n, bsz] = sess.process_batch(a, b, timesteps(bsz))
    return out


@pytest.mark.parametrize("bsz", [8, 3])
@pytest.mark.parametrize("n", [8, 4])
def test_batch_sharding(model_dirs, rife_tpu_batch, n, bsz):
    sess = RIFE(model_dirs["v4.6"], device="cpu")
    sharded = S.ShardedRIFE(sess, S.make_mesh([CPU] * n))
    a, b = frames(bsz, 64, 64, seed=bsz)
    ts = timesteps(bsz)
    got = sharded.process_batch(a, b, ts)
    assert np.array_equal(got, per_shard_session(sess, a, b, ts, n))
    assert_u8_close(got, rife_tpu_batch[n, bsz])


@pytest.mark.parametrize("model", ["v2.3", "v1"])
def test_batch_sharding_other_families(model_dirs, model):
    sess = RIFE(model_dirs[model], device="cpu")
    sharded = S.ShardedRIFE(sess, S.make_mesh([CPU] * 2))
    a, b = frames(3, 32, 64)
    ts = np.full(3, 0.5, np.float32)
    assert np.array_equal(sharded.process_batch(a, b, ts),
                          per_shard_session(sess, a, b, ts, 2))


def test_batch_and_height_sharding_take_tensors(model_dirs):
    """The runner hands device tensors; the result is a tensor on the
    mesh's first device, the padding rows dropped."""
    sess = RIFE(model_dirs["v4.6"], device="cpu")
    sharded = S.ShardedRIFE(sess, S.make_mesh_2d(2, 2, [CPU] * 4),
                            height_axis="spatial")
    a, b = frames(3, 64, 32)
    ts = timesteps(3)
    out = sharded.process_batch_device(torch.from_numpy(a),
                                       torch.from_numpy(b), ts)
    assert isinstance(out, torch.Tensor) and out.device == CPU
    assert np.array_equal(out.numpy(), sharded.process_batch(a, b, ts))
    assert_u8_close(out.numpy(), per_shard_session(sess, a, b, ts, 2))


def test_meshes():
    mesh = S.make_mesh_2d(2, 4, [CPU] * 8)
    assert mesh.shape == {"data": 2, "spatial": 4}
    assert S.make_mesh([CPU] * 3).shape == {"data": 3, "_": 1}
    with pytest.raises(ValueError, match="2x3"):
        S.make_mesh_2d(2, 3, [CPU] * 8)


def test_sharded_session_checks_its_axes(model_dirs):
    sess = RIFE(model_dirs["v4.6"], device="cpu")
    mesh = S.make_mesh_2d(2, 2, [CPU] * 4)
    with pytest.raises(ValueError, match="no axis"):
        S.ShardedRIFE(sess, mesh, height_axis="rows")
    with pytest.raises(ValueError, match="neither"):
        S.ShardedRIFE(sess, mesh)  # the spatial axis would be unused
    # the axes may come in either order
    swapped = S.ShardedRIFE(sess, mesh, batch_axis="spatial",
                            height_axis="data")
    assert len(swapped.grid) == 2 and len(swapped.grid[0]) == 2


def test_one_weight_copy_per_device(model_dirs):
    sess = RIFE(model_dirs["v4.6"], device="cpu")
    sharded = S.ShardedRIFE(sess, S.make_mesh([CPU] * 4))
    assert list(sharded.weights) == [CPU]
    assert sharded.weights[CPU] is sess.weights


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_mesh_without_a_card_raises(no_card):
    for make in (S.make_mesh, lambda: S.make_mesh_2d(1, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# --- launches -------------------------------------------------------------

def spy_wrappers(monkeypatch, calls):
    """Count the kernel wrappers' calls (the twins on the CPU) under the
    names the plan uses: a call with ps > 1 is ``conv3x3_ps``."""
    def wrap(mod, name):
        real = getattr(mod, name)

        def spy(*args, **kw):
            key = "conv3x3_ps" if kw.get("ps", 1) > 1 else name
            calls[key] = calls.get(key, 0) + 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)

    for name in ("warp_feat", "warp_u8", "warp_pair", "warp_ds4_pair",
                 "warp_render", "warp_ds2", "warp_spatial"):
        wrap(W, name)
    wrap(CV, "conv3x3")


@pytest.mark.parametrize("model,modes", [
    ("v4.6", {}), ("v2.3", {}), ("v1", {}), ("v2.3", {"uhd_mode": True}),
    ("v4.6", {"tta_mode": True, "tta_temporal_mode": True,
              "fuse_ds2": True}),
])
@pytest.mark.parametrize("mesh", [(1, 4), (2, 2), (2, 1)])
def test_kernel_sites_of_sharded_steps(model_dirs, monkeypatch, model, modes,
                                       mesh):
    """``ShardedRIFE.kernel_sites`` (``plan.kernel_sites`` per data shard)
    counts what one step hands the wrappers: per data shard a step; height-sharded, per non-empty shard
    each net's conv sites (gated on the whole blob) and its warps, every
    one a sharded warp (``warp_spatial``)."""
    monkeypatch.setattr(CV, "CONV_MIN_HW", 0)
    monkeypatch.setattr(CV, "DECONV_MIN_HW", 0)
    sess = RIFE(model_dirs[model], device="cpu", **modes)
    n_data, n_sp = mesh
    sharded = S.ShardedRIFE(
        sess, S.make_mesh_2d(n_data, n_sp, [CPU] * (n_data * n_sp)),
        height_axis="spatial" if n_sp > 1 else None,
        batch_axis="data")
    want = sharded.kernel_sites(128, 64)
    calls = {}
    spy_wrappers(monkeypatch, calls)
    a, b = frames(2, 128, 64)
    sharded.process_batch(a, b, np.full(2, 0.5, np.float32))
    assert calls == want
    if n_sp > 1:
        assert not {"warp_pair", "warp_ds4_pair", "warp_render",
                    "warp_ds2", "warp_u8", "warp_feat"} & set(want)
        assert want.get("warp_spatial", 0) > 0


# --- -g all -----------------------------------------------------------------

def write_frames(d: Path, n, h, w, seed=0):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            d / f"{i:04d}.png")
    return d


def read_dir(d: Path):
    return {n: np.asarray(Image.open(d / n)) for n in sorted(os.listdir(d))}


@pytest.fixture
def cpu_cards(monkeypatch):
    """A host whose 'cards' are the CPU: -g all then shards over them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cli, "mesh_devices", lambda: [CPU] * 2)


def test_g_all_without_a_card_exits_255(tmp_path, model_dirs, no_card,
                                        capsys):
    ind = write_frames(tmp_path / "in", 2, 32, 32)
    outd = tmp_path / "out"
    outd.mkdir()
    argv = ["-i", str(ind), "-o", str(outd), "-m", model_dirs["v4.6"]]
    assert cli.main(argv + ["-g", "all"]) == 255
    assert os.listdir(outd) == [] and "-g -1" in capsys.readouterr().err
    assert cli.main(argv + ["-g", "-1"]) == 0
    assert len(os.listdir(outd)) == 4


def test_g_all_equals_one_session_at_the_per_card_batch(tmp_path, model_dirs,
                                                        cpu_cards):
    """Directory mode: -g all over two devices at -j 1:2:1 (steps of 4,
    each shard a batch of 2) writes what one session at -j 1:2:1 does."""
    ind = write_frames(tmp_path / "in", 6, 32, 64)
    outs = {}
    for g in ("all", "-1"):
        outd = tmp_path / f"out{g}"
        outd.mkdir()
        assert cli.main(["-i", str(ind), "-o", str(outd), "-m",
                         model_dirs["v4.6"], "-g", g, "-j", "1:2:1"]) == 0
        outs[g] = read_dir(outd)
    assert outs["all"].keys() == outs["-1"].keys() and len(outs["all"]) == 12
    assert all(np.array_equal(outs["all"][k], outs["-1"][k])
               for k in outs["all"])


@pytest.mark.parametrize("jobs", [None, "1:3:1"])
def test_g_all_batch_plan_equals_rife_tpu(tmp_path, model_dirs, monkeypatch,
                                          jobs):
    """The step batch of -g all is the -j proc value (default 2) times the
    devices, in both CLIs, each given eight devices."""
    import rife_tpu.io.runner as jax_runner

    seen = {}

    def fake(tag):
        class Runner:
            def __init__(self, fns, **kw):
                seen[tag] = (len(fns), kw["batch_size"])

            def run(self, tasks):
                return []
        return Runner

    monkeypatch.setattr(jax_runner, "PipelineRunner", fake("rife_tpu"))
    monkeypatch.setattr(port_runner, "PipelineRunner", fake("port"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cli, "mesh_devices", lambda: [CPU] * 8)
    assert len(jax.devices()) == 8
    ind = write_frames(tmp_path / "in", 2, 32, 32)
    argv = ["-i", str(ind), "-o", str(tmp_path), "-m", model_dirs["v4.6"],
            "-g", "all"] + (["-j", jobs] if jobs else [])
    assert jax_cli.main(argv) == 0 and cli.main(argv) == 0
    assert seen["port"] == seen["rife_tpu"]
    assert seen["port"] == (1, [8 * (3 if jobs else 2)])
    assert cli.mesh_batch([], 8) == 16
