"""Each family's frame pipeline, found by the configuration's ``family``:
``portbench/reference/families/<family>.py``.  A later family is one new
file.  A family module gives:

* ``TAP``: the flownet's flow tap, the blob whose std the weights'
  calibration sets, and its flow channels;
* ``flownet_inputs(i0, i1)``: the flownet's inputs for preprocessed frames
  (B,3,H,W), as the calibration feeds them (the midpoint);
* ``pair(run, i0, i1, t)``: preprocessed frames -> (the float output frame,
  still padded; the flow tap's flow channels), where ``run(net, inputs,
  outputs)`` runs one net of the model and returns the ``outputs`` blobs;
* ``net_inputs(cfg, net, b, hp, wp)``: the input shapes of one run of
  ``net`` as ``pair`` feeds it, for a batch of ``b`` frames padded to
  ``hp`` x ``wp`` (the work counts).
"""

from __future__ import annotations

import importlib
from typing import NamedTuple


class Tap(NamedTuple):
    blob: str
    channels: int


def load(family: str):
    """The module of ``families/<family>.py``."""
    return importlib.import_module(f"{__name__}.{family}")
