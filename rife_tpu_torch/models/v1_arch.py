"""In-repo reconstruction of the v1-family graphs (``rife``, ``rife-anime``)
as ncnn ``.param`` text.

The real ``rife/{flownet,contextnet,fusionnet}.param`` files are not in the
repository.  Until they are, the port runs on this reconstruction of the
public RIFE v1.x nets (``model/IFNet.py`` and ``model/RIFE.py`` of
hzwer/arXiv2020-RIFE; arXiv 2011.06294 v1), written as the ncnn layers the
converter emits and held to every invariant the repo records about the real
files (SURVEY.md §2.3, tests/test_param_parser.py,
tests/test_graph_executor.py, tests/test_rewrite.py).  Weights are the
deterministic synthetic ones (``synthesize_weights`` with the calibrated
scales of ``rife`` / ``rife-anime``), so every number printed from it
belongs to the "v1-architecture graphs (in-repo reconstruction, synthetic
weights)", never to the real models.

**SE ResBlock** ``(cin, cout, stride)``: ``y = x`` when cin == cout and
stride 1, else a bias-free 3x3 conv ``conv0``; ``x = conv2(PReLU(conv1(x)))``
(3x3, ``conv1`` at the stride, both with bias); the squeeze-excitation gate
``w = sigmoid(IP2(PReLU1(IP1(Pooling(x)))))`` (global average ``Pooling
0=1 4=1`` to (B,C), two bias-free ``InnerProduct`` C -> 16 -> C, a
one-slope ``PReLU``); then ``PReLU(x * w + y)``, the ``BinaryOp`` MUL of
the (B,C) vector into the (B,C,H,W) map first.  The sigmoid rides the
second ``InnerProduct`` as its fused activation (``9=4``): the layer
histogram of the real files (SURVEY.md §2.3) counts 244 InnerProduct and
122 Pooling layers but only 5 Sigmoid layers in all 29 graphs, so the
converter folded the SE sigmoids into their InnerProducts.  ``sigmoid`` of
the ``InnerProduct`` is the same function as a separate ``Sigmoid`` layer.

* **flownet** (inputs ``input0``/``input1``, output ``flow``: 2 channels at
  half resolution).  Three IFBlocks at scales 8, 4, 2 of the frame (the
  v1 IFNet's 4, 2, 1 of its half-resolution input) with widths c = 240,
  150, 90 (``V1_WIDTHS``).  A block enters through ``Interp`` 1/scale, runs
  a 3x3 stride-2 conv to c with PReLU, six SE ResBlocks at c (stride 1,
  identity skip), a 3x3 conv to 8 channels and ``PixelShuffle`` 2 (a
  2-channel flow at 1/scale), then ``Interp`` x scale/2 back to half
  resolution (none at scale 2); the flows accumulate with ``BinaryOp``
  adds.  Between blocks, ``rife.Warp`` warps the two frames, the second by
  the flow negated with ``UnaryOp 0=1``; the next block takes
  ``Concat(warp0, warp1, flow)`` (8 channels).
  - ``rife``: the warps read ``Crop`` copies of ``Concat(input0, input1)``
    at full resolution by the flow upsampled x2 and multiplied by 2, so
    they stay value copies of the frames (the u8-origin kernels).
  - ``rife-anime``: the concat is scaled by 0.5 (``Interp``) before it is
    sliced, as the v1 IFNet does, and the blocks and warps run on that
    half-resolution copy (scales 4, 2, 1 of it): no warp reads a value copy
    of the frames (tests/test_param_parser.py:139-144).
* **contextnet** (inputs ``input.1`` and ``flow.1``, outputs ``f1..f4``).
  ``UnaryOp 0=1`` negates ``flow.1`` into the blob ``flow.0``, so a run fed
  ``flow.0`` (frame 0) skips the negation and a run fed ``flow.1`` (frame 1)
  warps by ``-flow``, as ``RIFE.predict`` calls ``contextnet(img1, -flow)``.
  Four stride-2 SE ResBlocks 3->c, c->2c, 2c->4c, 4c->8c (c = 16); ``f1``
  warps the first stage's output by the half-resolution flow, each later
  ``f_i`` by the flow downscaled by 1/2 and halved once more.
* **fusionnet** (inputs ``img0``, ``img1``, the half-resolution ``flow``
  and the context features ``"3".."10"``, output ``output``).  The flow is
  upsampled x2 (times 2) and warps ``img0``, its negation ``img1``; a U-Net
  of stride-2 SE ResBlocks (8->2c, 4c->4c, 8c->8c, 16c->16c over the
  concats with the context features) and 4x4 stride-2 deconvs with PReLU
  (32c->8c, 16c->4c, 8c->c over the concats with the encoder outputs) ends
  at half resolution in c channels; the head is ``Convolution`` 3x3 c->16
  then ``PixelShuffle`` 2 (4 channels at full resolution).  The tail is
  ``out = warp0*mask + warp1*(1-mask) + res`` with ``res = sigmoid(r)*2-1``,
  ``mask = sigmoid(m)``, then ``Clip`` to [0, 1].

Details neither the public code nor a recorded invariant fixes, as chosen
here (both packages load the same files): the ``rife`` variant's full-
resolution warps and single 1/8 block entry; the decoder ending at half
resolution, where the public code's last deconv would reach full resolution
before the conv + PixelShuffle head (the TPU's record has that head's input
at 544x960 for a 1080p frame, on its planar conv gate); the first encoder
stage feeding only the next one; the zero biases, 0.25 slopes and delta-tap
convs of ``synthesize_weights``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

from .v46_arch import _ParamWriter

# three flownet block widths, then the contextnet/fusionnet base width
V1_WIDTHS = (240, 150, 90, 16)
VARIANTS = ("rife", "rife-anime")
NETS = ("flownet", "contextnet", "fusionnet")
SE_WIDTH = 16  # the squeeze width of every SE gate
LABEL = "v1-architecture graphs (in-repo reconstruction, synthetic weights)"

_SIGMOID = 4  # ncnn fused activation_type of an InnerProduct


class _Writer(_ParamWriter):
    def conv(self, name: str, blob: str, cin: int, cout: int, *,
             stride: int = 1, bias: bool = True) -> str:
        """3x3 pad-1 conv, no activation."""
        return self.one(
            "Convolution", name, [blob],
            f"0={cout} 1=3 3={stride} 4=1 5={int(bias)} 6={cout * cin * 9}")

    def prelu(self, name: str, blob: str, n: int) -> str:
        return self.one("PReLU", name, [blob], f"0={n}")

    def binop(self, name: str, bottoms, op: int, scalar=None) -> str:
        params = f"0={op}" if scalar is None else f"0={op} 1=1 2={scalar:e}"
        return self.one("BinaryOp", name, list(bottoms), params)

    def neg(self, name: str, blob: str) -> str:
        return self.one("UnaryOp", name, [blob], "0=1")

    def up2x2(self, name: str, flow: str) -> str:
        """``F.interpolate(flow, scale_factor=2) * 2``."""
        up = self.interp(f"{name}_up", flow, 2.0)
        return self.binop(f"{name}_mul", [up], 2, 2.0)

    def se_resblock(self, name: str, blob: str, cin: int, cout: int, *,
                    stride: int) -> str:
        identity = cin == cout and stride == 1
        x, y = self.split(blob, 2)
        if not identity:
            y = self.conv(f"{name}_conv0", y, cin, cout, stride=stride,
                          bias=False)
        x = self.prelu(f"{name}_conv1_prelu",
                       self.conv(f"{name}_conv1", x, cin, cout, stride=stride),
                       cout)
        x, xs = self.split(self.conv(f"{name}_conv2", x, cout, cout), 2)
        w = self.one("Pooling", f"{name}_pool", [xs], "0=1 4=1")
        w = self.one("InnerProduct", f"{name}_fc1", [w],
                     f"0={SE_WIDTH} 1=0 2={SE_WIDTH * cout}")
        w = self.prelu(f"{name}_fc1_prelu", w, 1)
        w = self.one("InnerProduct", f"{name}_fc2", [w],
                     f"0={cout} 1=0 2={SE_WIDTH * cout} 9={_SIGMOID}")
        x = self.binop(f"{name}_scale", [x, w], 2)
        x = self.binop(f"{name}_add", [x, y], 0)
        return self.prelu(f"{name}_prelu", x, cout)


def _check(widths: Sequence[int], variant: str) -> None:
    if len(widths) != 4 or any(c <= 0 for c in widths):
        raise ValueError(f"need three flownet widths and a context width, "
                         f"got {widths!r}")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")


def flownet_param_text(widths: Sequence[int] = V1_WIDTHS,
                       variant: str = "rife") -> str:
    _check(widths, variant)
    anime = variant == "rife-anime"
    # block scales relative to the blob the block enters from (the frames'
    # concat, or its half-resolution copy for rife-anime)
    scales = (4, 2, 1) if anime else (8, 4, 2)
    p = _Writer()
    for name in ("input0", "input1"):
        p.layer("Input", name, [], [name])
    x = p.one("Concat", "cat_in", ["input0", "input1"], "0=0")
    if anime:
        x = p.interp("interp_half", x, 0.5)
    x = p.split(x, 5)
    entry = p.interp("interp0", x[0], 1.0 / scales[0])
    cin = 6
    acc = None
    for i, (c, s) in enumerate(zip(widths[:3], scales)):
        y = p.prelu(f"block{i}_conv0_prelu",
                    p.conv(f"block{i}_conv0", entry, cin, c, stride=2), c)
        for k in range(6):
            y = p.se_resblock(f"block{i}_res{k}", y, c, c, stride=1)
        y = p.one("PixelShuffle", f"block{i}_ps",
                  [p.conv(f"block{i}_conv1", y, c, 8)], "0=2")
        # back to the flow's grid: half the frame (the blob for anime)
        up = s if anime else s // 2
        flow_i = p.interp(f"block{i}_up", y, float(up)) if up > 1 else y
        if acc is None:
            acc = flow_i
        else:
            top = "flow" if i == 2 else f"flowsum{i}"
            acc = p.layer("BinaryOp", f"flowadd{i}", [acc, flow_i], [top],
                          "0=0")[0]
        if i == 2:
            break
        acc, fl = p.split(acc, 2)
        fl = p.split(fl if anime else p.up2x2(f"flowx2_{i}", fl), 3)
        img0 = p.crop(f"Slice_img{i}_0", x[1 + 2 * i], 0, 3)
        img1 = p.crop(f"Slice_img{i}_1", x[2 + 2 * i], 3, 6)
        neg = p.neg(f"flowneg{i}", fl[1])
        warped = [p.one("rife.Warp", f"warp{i}_0", [img0, fl[0]]),
                  p.one("rife.Warp", f"warp{i}_1", [img1, neg])]
        cat = p.one("Concat", f"cat{i + 1}", [*warped, fl[2]], "0=0")
        s_next = scales[i + 1]
        entry = p.interp(f"interp{i + 1}", cat, 1.0 / s_next) if s_next > 1 \
            else cat
        cin = 8
    return p.text()


def contextnet_param_text(widths: Sequence[int] = V1_WIDTHS,
                          variant: str = "rife") -> str:
    _check(widths, variant)
    c = widths[3]
    p = _Writer()
    for name in ("input.1", "flow.1"):
        p.layer("Input", name, [], [name])
    p.layer("UnaryOp", "flow_neg", ["flow.1"], ["flow.0"], "0=1")
    x, flow = "input.1", "flow.0"
    chans = (3, c, 2 * c, 4 * c, 8 * c)
    for k in range(1, 5):
        x = p.se_resblock(f"conv{k}", x, chans[k - 1], chans[k], stride=2)
        if k > 1:
            flow = p.binop(f"flowhalf{k}_mul",
                           [p.interp(f"flowhalf{k}_down", flow, 0.5)], 2, 0.5)
        if k < 4:
            x, xw = p.split(x, 2)
            flow, fw = p.split(flow, 2)
        else:
            xw, fw = x, flow
        p.layer("rife.Warp", f"warp_f{k}", [xw, fw], [f"f{k}"])
    return p.text()


def fusionnet_param_text(widths: Sequence[int] = V1_WIDTHS,
                         variant: str = "rife") -> str:
    _check(widths, variant)
    c = widths[3]
    p = _Writer()
    ctx = [str(3 + i) for i in range(8)]  # c0[0..3], then c1[0..3]
    for name in ("img0", "img1", "flow", *ctx):
        p.layer("Input", name, [], [name])
    big = p.split(p.up2x2("flowx2", "flow"), 3)
    neg = p.neg("flow_neg", big[1])
    w0 = p.split(p.one("rife.Warp", "warp_img0", ["img0", big[0]]), 2)
    w1 = p.split(p.one("rife.Warp", "warp_img1", ["img1", neg]), 2)
    s0 = p.se_resblock("down0", p.one("Concat", "cat0",
                                      [w0[0], w1[0], big[2]], "0=0"),
                       8, 2 * c, stride=2)
    s1 = p.split(p.se_resblock("down1", p.one("Concat", "cat1",
                                              [s0, ctx[0], ctx[4]], "0=0"),
                               4 * c, 4 * c, stride=2), 2)
    s2 = p.split(p.se_resblock("down2", p.one("Concat", "cat2",
                                              [s1[0], ctx[1], ctx[5]], "0=0"),
                               8 * c, 8 * c, stride=2), 2)
    s3 = p.se_resblock("down3", p.one("Concat", "cat3",
                                      [s2[0], ctx[2], ctx[6]], "0=0"),
                       16 * c, 16 * c, stride=2)
    y = p.one("Concat", "cat4", [s3, ctx[3], ctx[7]], "0=0")
    for k, (skip, cin, cout) in enumerate(((None, 32 * c, 8 * c),
                                           (s2[1], 16 * c, 4 * c),
                                           (s1[1], 8 * c, c))):
        if skip is not None:
            y = p.one("Concat", f"cat{4 + k}", [y, skip], "0=0")
        y = p.one("Deconvolution", f"up{k}", [y],
                  f"0={cout} 1=4 3=2 4=1 5=1 6={cout * cin * 16}")
        y = p.prelu(f"up{k}_prelu", y, cout)
    head = p.conv("head", y, c, 16)
    refine = p.split(p.one("PixelShuffle", "head_ps", [head], "0=2"), 2)
    res = p.binop("res_sub", [p.binop("res_mul", [p.one(
        "Sigmoid", "res_sigmoid", [p.crop("Slice_res", refine[0], 0, 3)])],
        2, 2.0)], 1, 1.0)
    m, m2 = p.split(p.one("Sigmoid", "mask_sigmoid",
                          [p.crop("Slice_mask", refine[1], 3, 4)]), 2)
    inv = p.binop("mask_rsub", [m2], 7, 1.0)
    merged = p.binop("blend_add", [p.binop("blend_mul0", [w0[1], m], 2),
                                   p.binop("blend_mul1", [w1[1], inv], 2)], 0)
    out = p.binop("out_add", [merged, res], 0)
    p.layer("Clip", "out_clip", [out], ["output"], f"0={0.0:e} 1={1.0:e}")
    return p.text()


_TEXT = {"flownet": flownet_param_text, "contextnet": contextnet_param_text,
         "fusionnet": fusionnet_param_text}


def write_v1_params(out_dir, widths: Sequence[int] = V1_WIDTHS,
                    variant: str = "rife") -> Path:
    """Write ``<out_dir>/<variant>/{flownet,contextnet,fusionnet}.param`` and
    return the model dir (``variant``: ``"rife"`` or ``"rife-anime"``).

    The directory name makes ``models.zoo.sniff_family`` pick the v1
    pipeline and ``synthesize_weights`` apply the calibrated scales of that
    model; both packages load the dir with ``load_model``.  ``widths`` is the
    three flownet block widths followed by the contextnet/fusionnet base
    width."""
    _check(widths, variant)
    model_dir = Path(out_dir) / variant
    model_dir.mkdir(parents=True, exist_ok=True)
    for net in NETS:
        text = _TEXT[net](widths, variant)
        path = model_dir / f"{net}.param"
        if not path.exists() or path.read_text() != text:
            tmp = path.with_suffix(".param.tmp")
            tmp.write_text(text)
            tmp.replace(path)
    return model_dir
