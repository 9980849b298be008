"""``engine/plan.py`` is the session's own step run on meta tensors and
counted: it needs no card and no kernel library, and leaves the wrappers'
launch counters and the sharded runs' traffic as it found them."""

import torch

from rife_tpu_torch import RIFE
from rife_tpu_torch.engine import plan
from rife_tpu_torch.graph import spatial
from rife_tpu_torch.models.v23_arch import write_v23_params
from rife_tpu_torch.native import build
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import warp as W

# a v2.3 1080p bf16 step on the card: of the 11 gated sites
# (test_torch_v23_session.py test_kernel_sites_at_1080p) 8 convs on conv3x3
# and 3 deconvs on the deconv kernel, which takes the 6 other deconvs in
# XLA's order; one bias_act a library site (test_torch_bias_act.py
# FULL_SITES); height-sharded 1x4, each of the four shards runs every net
CARD_BF16_SITES = {"conv3x3": 8, "deconv4x4": 9, "bias_act": 44,
                   "warp_ds4_pair": 1, "warp_pair": 2, "warp_feat": 4,
                   "warp_u8": 2}
CARD_BF16_1X4_SITES = {"conv3x3": 32, "deconv4x4": 36, "bias_act": 176,
                       "warp_spatial": 48}


def test_plan_of_a_card_step_runs_no_kernel(tmp_path, monkeypatch):
    def no_card(*args):
        raise OSError("no kernel library and no card")

    monkeypatch.setattr(build, "load", no_card)
    monkeypatch.setattr(torch.cuda, "device", no_card)
    monkeypatch.setattr(torch.cuda, "current_stream", no_card)
    real = CV.epilogue_on_kernel
    monkeypatch.setattr(CV, "epilogue_on_kernel",
                        lambda device, act, has_bias: real("cuda", act,
                                                           has_bias))
    monkeypatch.setattr(CV, "deconv_on_kernel",
                        lambda device, dtype: dtype == torch.bfloat16)
    for launches in (CV.LAUNCHES, W.LAUNCHES, spatial.TRAFFIC):
        for i, name in enumerate(launches):
            monkeypatch.setitem(launches, name, i + 1)
    before = [dict(d) for d in (CV.LAUNCHES, W.LAUNCHES, spatial.TRAFFIC)]

    sess = RIFE(str(write_v23_params(tmp_path)), device="cpu",
                dtype=torch.bfloat16)
    assert plan.kernel_sites(sess, 1080, 1920) == CARD_BF16_SITES
    assert plan.kernel_sites(sess, 1080, 1920, n_spatial=4) == \
        CARD_BF16_1X4_SITES
    deconvs = plan.conv_site_counts(sess, 1080, 1920, "deconv4x4")
    assert sum(n for _, n in deconvs) == 9
    assert sum(xla for (*_, xla), _ in deconvs) == 6
    assert [dict(d) for d in (CV.LAUNCHES, W.LAUNCHES,
                              spatial.TRAFFIC)] == before
