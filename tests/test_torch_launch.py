"""Every kernel wrapper calls its C function inside a device guard for its
tensors' device, on that device's current stream, and raises when the call
fails (ops/launch.py).

Runs on the CPU: ``build.load`` is replaced by a fake library that records
each call, ``torch.cuda.device`` by a recording context manager and
``torch.cuda.current_stream`` by a stand-in; the operands are CPU tensors of
a subclass that reports a CUDA device, so each wrapper takes its kernel path
and not its twin.  On two cards: tests/test_torch_cuda.py.
"""

import types

import pytest
import torch

from rife_tpu_torch.native import build
from rife_tpu_torch.ops import conv as CV
from rife_tpu_torch.ops import warp as W


class OnCard(torch.Tensor):
    """A CPU tensor that reports ``OnCard.card`` as its device."""

    card = torch.device("cuda", 0)

    @property
    def device(self):
        return OnCard.card


class Recorder:
    """The fake library, the guard and the stream: records (C function,
    guarded device, stream's device) per call; ``rc`` is what each call
    returns."""

    def __init__(self):
        self.calls, self.guards, self.rc = [], [], 0

    def guard(self, device):
        rec = self

        class Guard:
            def __enter__(self):
                rec.guards.append(torch.device(device))

            def __exit__(self, *exc):
                rec.guards.pop()
        return Guard()

    def stream(self, device=None):
        return types.SimpleNamespace(cuda_stream=0, device=device)

    def __getattr__(self, name):
        if name == "rife_error_string":
            return lambda code: b"recorded failure"
        if not name.startswith("rife_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, self.guards[-1] if self.guards else None,
                               args[-1]))
            return self.rc
        return call


@pytest.fixture
def rec(monkeypatch):
    r = Recorder()
    monkeypatch.setattr(build, "load", lambda: r)
    monkeypatch.setattr(torch.cuda, "device", r.guard)
    monkeypatch.setattr(torch.cuda, "current_stream", r.stream)
    W.reset_launches()
    CV.reset_launches()
    return r


def on_card(*shape, dtype=torch.float32):
    return torch.rand(*shape).to(dtype).as_subclass(OnCard)


def warp_calls(dtype):
    """(wrapper, C function, thunk) for every warp wrapper."""
    b, h, w = 2, 8, 16
    img = lambda: on_card(b, 3, h, w, dtype=dtype)  # noqa: E731
    flow = lambda: on_card(b, 2, h, w, dtype=dtype)  # noqa: E731
    pos = on_card(b, 2, h // 2, w // 2)
    feat = on_card(b, 5, h, w, dtype=dtype)
    mask = on_card(b, h, w, dtype=dtype)
    return [
        ("warp_pair", "rife_warp_pair",
         lambda: W.warp_pair(img(), flow(), img(), flow())),
        ("warp_render", "rife_warp_render",
         lambda: W.warp_render(img(), flow(), img(), flow(), mask)),
        ("warp_ds4_pair", "rife_warp_ds4_pair",
         lambda: W.warp_ds4_pair(img(), flow(), img(), flow())),
        ("warp_ds2", "rife_warp_ds2", lambda: W.warp_ds2(img(), flow())),
        ("warp_feat", "rife_warp_single", lambda: W.warp_feat(feat, flow())),
        ("warp_feat", "rife_warp_single",
         lambda: W.warp_feat(feat, pos, abs_pos=True)),
        ("warp_u8", "rife_warp_single", lambda: W.warp_u8(img(), flow())),
        ("warp_u8", "rife_warp_single",
         lambda: W.warp_u8(img(), pos, abs_pos=True)),
        ("warp_spatial", "rife_warp_spatial",
         lambda: W.warp_spatial(img(), flow()[:, :, 4:].contiguous(), 4,
                                u8=True)),
        ("warp_spatial", "rife_warp_spatial",
         lambda: W.warp_spatial(feat, flow()[:, :, :4].contiguous(), 0,
                                u8=False, ds4=True)),
    ]


def conv_calls(dtype):
    """(counter, C function, thunk) for the library sites' epilogue
    (``bias_act``), conv3x3 (one and three parts) and deconv4x4, each also
    in its PixelShuffle form (B4, ``conv3x3_ps``), and in bf16
    deconv4x4_xla: a bf16 deconv launches the deconv kernel, an f32 one the
    f32 conv kernel's deconv mode; a bf16 shuffled conv B4's conv kernel,
    an f32 one the f32 conv kernel."""
    bf16 = dtype == torch.bfloat16
    c_fn = "rife_conv3x3_tc" if bf16 else "rife_conv3x3"
    d_fn = "rife_deconv4x4" if bf16 else c_fn
    parts = [on_card(2, c, 8, 12, dtype=dtype) for c in (3, 3, 4)]
    weight = on_card(16, 10, 3, 3, dtype=dtype)
    bias, slope = on_card(16), on_card(16)
    raw6, raw8 = (torch.rand(10, o, 4, 4).to(dtype) for o in (6, 8))
    phase, phase8 = (CV.deconv_phase_weights(r).as_subclass(OnCard)
                     for r in (raw6, raw8))
    t4, t48 = (CV.pack_weight_t4(r).as_subclass(OnCard) for r in (raw6, raw8))
    calls = [
        ("bias_act", "rife_bias_act", lambda: CV.bias_act(
            on_card(2, 16, 8, 12, dtype=dtype), bias, slope, CV.ACT_PRELU)),
        ("conv3x3", c_fn, lambda: CV.conv3x3(
            parts, weight, bias, slope, stride=2, act=CV.ACT_PRELU,
            weight_tc=CV.pack_weight_tc(weight))),
        ("conv3x3", c_fn, lambda: CV.conv3x3(
            [torch.cat(parts, 1)], weight, bias,
            weight_tc=CV.pack_weight_tc(weight))),
        ("deconv4x4" if bf16 else "conv3x3", d_fn, lambda: CV.deconv4x4(
            torch.cat(parts, 1), phase, on_card(24), act=CV.ACT_RELU,
            weight_t4=t4)),
        ("conv3x3_ps", "rife_conv3x3_ps" if bf16 else c_fn, lambda: CV.conv3x3(
            [torch.cat(parts, 1)], weight, bias, slope, act=CV.ACT_PRELU,
            weight_tc=CV.pack_weight_tc(weight), ps=2)),
        ("deconv4x4" if bf16 else "conv3x3_ps", d_fn, lambda: CV.deconv4x4(
            torch.cat(parts, 1), phase8, on_card(32), weight_t4=t48, ps=2)),
    ]
    if bf16:
        calls.append(("deconv4x4", d_fn, lambda: CV.deconv4x4_xla(
            torch.cat(parts, 1), t48, on_card(8), on_card(8),
            act=CV.ACT_PRELU, ps=2)))
    return calls


def counts():
    return {k: v for k, v in {**W.LAUNCHES, **CV.LAUNCHES}.items() if v}


@pytest.mark.parametrize("index", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["warp", "conv"])
def test_every_launch_runs_under_its_devices_guard(rec, monkeypatch, kind,
                                                   dtype, index):
    card = torch.device("cuda", index)
    monkeypatch.setattr(OnCard, "card", card)
    for counter, c_fn, thunk in (warp_calls if kind == "warp"
                                 else conv_calls)(dtype):
        rec.calls.clear()
        before = counts().get(counter, 0)
        out = thunk()
        outs = out if isinstance(out, tuple) else (out,)
        assert all(o.device == card for o in outs)
        assert len(rec.calls) == 1, rec.calls
        name, guarded, stream = rec.calls[0]
        assert (name, guarded) == (c_fn, card)
        assert stream.value in (None, 0)
        assert rec.guards == []  # the guard is left after the call
        assert counts()[counter] == before + 1


@pytest.mark.parametrize("kind", ["warp", "conv"])
def test_failed_launch_raises_and_counts_nothing(rec, kind):
    rec.rc = 700
    for counter, c_fn, thunk in (warp_calls if kind == "warp"
                                 else conv_calls)(torch.bfloat16):
        with pytest.raises(RuntimeError, match=f"{c_fn}: CUDA error 700 "
                                               r"\(recorded failure\)"):
            thunk()
    assert counts() == {}


def test_stream_is_the_guarded_devices(rec, monkeypatch):
    """The stream handed to the C function is taken for the tensor's
    device, inside the guard."""
    seen = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: seen.append(
                            (torch.device(device), list(rec.guards)))
                        or rec.stream(device))
    monkeypatch.setattr(OnCard, "card", torch.device("cuda", 2))
    warp_calls(torch.float32)[0][2]()
    assert seen == [(torch.device("cuda", 2), [torch.device("cuda", 2)])]


@pytest.mark.parametrize("case", ["odd H", "odd W", "strided image",
                                  "strided flow"])
def test_warp_ds2_rejects_odd_sizes_and_strided_operands(rec, case):
    """K3 takes even H and W (its output is the exact 1/2 grid) and
    contiguous operands; anything else raises before any C call."""
    shape = {"odd H": (7, 8), "odd W": (8, 7)}.get(case, (8, 8))
    img = on_card(1, 3, *shape)
    flow = on_card(1, 2, *shape)
    if case == "strided image":
        img = on_card(1, 3, 8, 10)[..., :8]
    if case == "strided flow":
        flow = on_card(1, 2, 8, 10)[..., :8]
    match = "even H and W" if case.startswith("odd") else "contiguous"
    with pytest.raises(ValueError, match=match):
        W.warp_ds2(img, flow)
    assert rec.calls == [] and counts() == {}
