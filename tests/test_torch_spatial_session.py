"""Height sharding end to end (parallel/sharding.py ShardedRIFE with
``height_axis``, graph/spatial.py SpatialExecutor) on the CPU, f32, at
mini widths, for the v4.6-, v2.3- and v1-architecture reconstructions.

The port's sharded session is held (a) to the port's unsharded session at
the same per-shard batch and (b) to ``rife_tpu``'s ``ShardedRIFE`` on the
8-device virtual CPU mesh of ``tests/conftest.py``, built from the same
parameter directory.  Bar for both: u8 max |d| <= 1 and >= 99.9% exact.
(a) differs only where a conv on a window of rows sums in another order
than on the whole blob (oneDNN picks its blocking by shape); (b) also where
``rife_tpu`` warps with XLA's ``warp_at`` and the port with the twins of
the Pallas kernels (ROADMAP queue C).  Meshes: 1x4 (128-row frames: four
shards of 32 rows), 2x4 (B=2) and 1x8 on 96-row frames, where three shards
hold rows and five stay idle (the 1/16 level: two rows a shard).  The
TTA and UHD modes are in tests/test_torch_spatial_modes.py.
"""

import jax
import numpy as np
import pytest
import torch

from rife_tpu_torch import RIFE
from rife_tpu_torch.models.v1_arch import write_v1_params
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.models.v46_arch import write_flownet_param
from rife_tpu_torch.parallel.sharding import ShardedRIFE, make_mesh_2d

CPU = torch.device("cpu")
# (n_data, n_spatial, B, H, W)
MESHES = {"1x4": (1, 4, 1, 128, 64), "2x4": (2, 4, 2, 64, 64),
          "1x8": (1, 8, 1, 96, 64)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    return {"v4.6": str(write_flownet_param(root, (16, 16, 16, 16))),
            "v2.3": str(write_v23_params(root, (16, 16, 16, 16, 8))),
            "v1": str(write_v1_params(root, (16, 16, 16, 8), "rife"))}


def frames(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, h, w, 3), np.uint8),
            rng.integers(0, 256, (b, h, w, 3), np.uint8))


def assert_u8_close(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


def rife_tpu_sharded(model_dir, n_data, n_sp, a, b, ts, **modes):
    from rife_tpu.engine.session import RIFE as JaxRIFE
    from rife_tpu.parallel.sharding import ShardedRIFE as JaxSharded
    from rife_tpu.parallel.sharding import make_mesh_2d as jax_mesh_2d

    mesh = jax_mesh_2d(n_data, n_sp, jax.devices()[:n_data * n_sp])
    return JaxSharded(JaxRIFE(model_dir, **modes), mesh, batch_axis="data",
                      height_axis="spatial").process_batch(a, b, ts)


def port_runs(model_dir, n_data, n_sp, a, b, ts, **modes):
    """(sharded, unsharded at the per-shard batch) outputs of the port."""
    sess = RIFE(model_dir, device="cpu", **modes)
    mesh = make_mesh_2d(n_data, n_sp, [CPU] * (n_data * n_sp))
    got = ShardedRIFE(sess, mesh, height_axis="spatial").process_batch(a, b,
                                                                       ts)
    per = len(a) // n_data
    want = np.concatenate([sess.process_batch(a[i:i + per], b[i:i + per],
                                              ts[i:i + per])
                           for i in range(0, len(a), per)])
    return got, want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", ["v4.6", "v2.3", "v1"])
def test_height_sharding(model_dirs, model, mesh):
    n_data, n_sp, bsz, h, w = MESHES[mesh]
    a, b = frames(bsz, h, w)
    ts = np.full(bsz, 0.5, np.float32)
    if model == "v4.6" and bsz > 1:
        ts = np.linspace(0.25, 0.75, bsz).astype(np.float32)
    got, want = port_runs(model_dirs[model], n_data, n_sp, a, b, ts)
    assert_u8_close(got, want)
    assert_u8_close(got, rife_tpu_sharded(model_dirs[model], n_data, n_sp,
                                          a, b, ts))


@pytest.mark.parametrize("model", ["v4.6", "v2.3", "v1"])
def test_height_sharding_bf16_is_bit_for_bit_on_the_cpu(model_dirs, model):
    """In bf16 too a sharded step computes what the unsharded step does:
    on the CPU, whose convs sum a window of rows as they sum the whole
    blob, the bytes agree exactly (on the card cuDNN picks its algorithms
    by shape, so there they need not)."""
    sess = RIFE(model_dirs[model], device="cpu", dtype=torch.bfloat16)
    a, b = frames(1, 128, 96, seed=2)
    ts = np.full(1, 0.5, np.float32)
    got = ShardedRIFE(sess, make_mesh_2d(1, 4, [CPU] * 4),
                      height_axis="spatial").process_batch(a, b, ts)
    assert np.array_equal(got, sess.process_batch(a, b, ts))
