"""Height sharding with the ``-x -z`` TTA modes (v4.6, v2.3) and UHD
``-u`` (v2.3 at sides that are multiples of 64, v1) on a 1x4 mesh of the
CPU: the port's ``ShardedRIFE`` against its unsharded session and against
``rife_tpu``'s ``ShardedRIFE`` on the virtual mesh, at the bar of
tests/test_torch_spatial_session.py (whose helpers this file uses).
"""

import numpy as np
import pytest

from rife_tpu_torch import RIFE
from rife_tpu_torch.parallel.sharding import ShardedRIFE, make_mesh_2d
from test_torch_spatial_session import (  # noqa: F401  (fixtures)
    CPU, _one_torch_thread, assert_u8_close, frames, model_dirs, port_runs,
    rife_tpu_sharded)

MODES = {
    "v4.6 -x -z": ("v4.6", dict(tta_mode=True, tta_temporal_mode=True),
                   (128, 64)),
    "v2.3 -x -z": ("v2.3", dict(tta_mode=True, tta_temporal_mode=True),
                   (128, 64)),
    "v2.3 -u": ("v2.3", dict(uhd_mode=True), (128, 128)),
    "v1 -u": ("v1", dict(uhd_mode=True), (128, 64)),
}


@pytest.mark.parametrize("case", list(MODES))
def test_height_sharding_modes(model_dirs, case):
    model, modes, (h, w) = MODES[case]
    a, b = frames(1, h, w, seed=1)
    ts = np.full(1, 0.5, np.float32)
    got, want = port_runs(model_dirs[model], 1, 4, a, b, ts, **modes)
    assert_u8_close(got, want)
    assert_u8_close(got, rife_tpu_sharded(model_dirs[model], 1, 4, a, b, ts,
                                          **modes))


def test_v23_uhd_needs_sides_that_are_multiples_of_64(model_dirs):
    """-u on the v2.3 reconstruction halves the padded frame, whose halved
    rows the 32-row cut must divide, as unsharded its 1/32 level must."""
    sess = RIFE(model_dirs["v2.3"], device="cpu", uhd_mode=True)
    sharded = ShardedRIFE(sess, make_mesh_2d(1, 2, [CPU] * 2),
                          height_axis="spatial")
    a, b = frames(1, 96, 128)
    with pytest.raises(ValueError):
        sharded.process_batch(a, b, np.full(1, 0.5, np.float32))
