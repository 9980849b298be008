"""In-repo reconstruction of the rife-v2.3 graphs as ncnn ``.param`` text
(a frozen copy of the program's ``models/v23_arch.py`` writer, so that the
graphs the benchmark measures belong to the benchmark).

The real ``rife-v2.3/{flownet,contextnet,fusionnet}.param`` files are not in
the repository.  Until they are, the port runs on this reconstruction of the
public RIFE v2.x "HDv2" model (``model/IFNet_HDv2.py`` and
``model/RIFE_HDv2.py`` of hzwer/arXiv2020-RIFE) at its published widths,
written as the ncnn layers the converter emits and held to every invariant
the repo records about the real files (SURVEY.md §2.3,
tests/test_param_parser.py, tests/test_graph_executor.py,
tests/test_bin_weights.py, tests/test_rewrite.py).  Weights are the
synthetic ones (``portbench/weights.py``, at the calibrated scales of
rife-v2.3), so every number printed from it belongs to the "v2.3-architecture
graphs (in-repo reconstruction, synthetic weights)", never to rife-v2.3.

* **flownet** (inputs ``input0``/``input1``, output ``flow``: 4 channels at
  half resolution).  ``x = Concat(input0, input1)``; four IFBlocks at scales
  8, 4, 2, 1 with widths c = 192, 128, 96, 48.  A block enters through
  ``Interp`` 1/scale (none at scale 1), runs two 3x3 stride-2 convs to c and
  2c and six 3x3 convs at 2c (each conv followed by a ``PReLU``: 8 per block,
  32 in all), then a 4x4 stride-2 ``Deconvolution`` to 4 channels and an
  ``Interp`` x scale back to half resolution.  The flows accumulate with
  ``BinaryOp`` adds.  Between blocks the flow is upsampled x2 and multiplied
  by 2, and the six ``rife.Warp`` nodes warp ``Crop`` copies of ``x`` by its
  channel crops; the next block takes ``Concat(warp0, warp1, flow_x2)``.
* **contextnet** (inputs ``input.1`` and ``flow.0`` at half resolution,
  outputs ``f1..f4``).  Five two-conv stages 3->c->c, c->c->c, c->2c->2c,
  2c->4c->4c and 4c->8c->8c (c = 32), the first conv of each with stride 2,
  PReLU after every conv: 10 convolutions with 1,189,728 weights, 1,024
  biases and 1,024 slopes.  Each ``f_i`` warps a stage output (stages 2-5)
  by the flow downscaled by 1/2 and halved once more per stage.
* **fusionnet** (inputs ``img0``, ``img1``, half-resolution ``flow`` and the
  context features ``"3".."10"``, output ``output``).  The head upsamples the
  flow x2 (times 2) and warps ``img0``/``img1`` by its halves; a U-Net
  encoder (``Conv2`` stages 10->c, c->2c, 4c->4c, 8c->8c, 16c->16c over the
  concats with the context features) and a decoder of 4x4 stride-2 deconvs
  with PReLU (32c->8c, 16c->4c, 8c->2c, 4c->c) end in a plain 4x4 deconv to
  4 channels.  The tail is ``out = warp0*mask + warp1*(1-mask) + res`` with
  ``res = sigmoid(r)*2-1``, ``mask = sigmoid(m)``, then ``Clip`` to [0, 1].
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

from .v46_arch import _ParamWriter

# four flownet block widths, then the contextnet/fusionnet base width
V23_WIDTHS = (192, 128, 96, 48, 32)
SCALES = (8, 4, 2, 1)
MODEL_NAME = "rife-v2.3"
NETS = ("flownet", "contextnet", "fusionnet")
LABEL = "v2.3-architecture graphs (in-repo reconstruction, synthetic weights)"


class _Writer(_ParamWriter):
    def conv(self, name: str, blob: str, cin: int, cout: int, *,
             stride: int) -> str:
        """3x3 pad-1 conv with bias, then PReLU."""
        y = self.one("Convolution", name, [blob],
                     f"0={cout} 1=3 3={stride} 4=1 5=1 6={cout * cin * 9}")
        return self.one("PReLU", f"{name}_prelu", [y], f"0={cout}")

    def deconv(self, name: str, blob: str, cin: int, cout: int, *,
               prelu: bool) -> str:
        """4x4 stride-2 pad-1 transposed conv with bias."""
        y = self.one("Deconvolution", name, [blob],
                     f"0={cout} 1=4 3=2 4=1 5=1 6={cout * cin * 16}")
        return self.one("PReLU", f"{name}_prelu", [y], f"0={cout}") if prelu else y

    def conv2(self, name: str, blob: str, cin: int, cout: int) -> str:
        """RIFE ``Conv2``: stride-2 conv then stride-1 conv."""
        x = self.conv(f"{name}_0", blob, cin, cout, stride=2)
        return self.conv(f"{name}_1", x, cout, cout, stride=1)

    def binop(self, name: str, bottoms, op: int, scalar=None) -> str:
        params = f"0={op}" if scalar is None else f"0={op} 1=1 2={scalar:e}"
        return self.one("BinaryOp", name, list(bottoms), params)

    def up2x2(self, name: str, flow: str) -> str:
        """``F.interpolate(flow, scale_factor=2) * 2``."""
        return self.binop(f"{name}_mul", [self.interp(f"{name}_up", flow, 2.0)],
                          2, 2.0)


def _check(widths: Sequence[int]) -> None:
    if len(widths) != 5 or any(c <= 0 for c in widths):
        raise ValueError(f"need four flownet widths and a context width, "
                         f"got {widths!r}")


def flownet_param_text(widths: Sequence[int] = V23_WIDTHS) -> str:
    _check(widths)
    p = _Writer()
    for name in ("input0", "input1"):
        p.layer("Input", name, [], [name])
    x = p.split(p.one("Concat", "cat_in", ["input0", "input1"], "0=0"), 7)
    acc = None
    entry = p.interp("interp0", x[0], 1.0 / SCALES[0])
    cin = 6
    for i, (c, s) in enumerate(zip(widths[:4], SCALES)):
        y = p.conv(f"block{i}_conv0", entry, cin, c, stride=2)
        y = p.conv(f"block{i}_conv1", y, c, 2 * c, stride=2)
        for k in range(6):
            y = p.conv(f"block{i}_body{k}", y, 2 * c, 2 * c, stride=1)
        d = p.deconv(f"block{i}_deconv", y, 2 * c, 4, prelu=False)
        flow_i = p.interp(f"block{i}_up", d, float(s)) if s > 1 else d
        if acc is None:
            acc = flow_i
        else:
            top = "flow" if i == 3 else f"flowsum{i}"
            acc = p.layer("BinaryOp", f"flowadd{i}", [acc, flow_i], [top],
                          "0=0")[0]
        if i == 3:
            break
        acc, fl = p.split(acc, 2)
        big = p.split(p.up2x2(f"flowx2_{i}", fl), 3)
        warped = []
        for k in range(2):
            img = p.crop(f"Slice_img{i}_{k}", x[1 + 2 * i + k], 3 * k, 3 * k + 3)
            fk = p.crop(f"Slice_flow{i}_{k}", big[k], 2 * k, 2 * k + 2)
            warped.append(p.one("rife.Warp", f"warp{i}_{k}", [img, fk]))
        cat = p.one("Concat", f"cat{i + 1}", [*warped, big[2]], "0=0")
        s_next = SCALES[i + 1]
        entry = p.interp(f"interp{i + 1}", cat, 1.0 / s_next) if s_next > 1 else cat
        cin = 10
    return p.text()


def contextnet_param_text(widths: Sequence[int] = V23_WIDTHS) -> str:
    _check(widths)
    c = widths[4]
    p = _Writer()
    for name in ("input.1", "flow.0"):
        p.layer("Input", name, [], [name])
    x = p.conv2("conv0", "input.1", 3, c)
    flow = "flow.0"
    chans = (c, c, 2 * c, 4 * c, 8 * c)
    for k in range(1, 5):
        x = p.conv2(f"conv{k}", x, chans[k - 1], chans[k])
        flow = p.binop(f"flowhalf{k}_mul",
                       [p.interp(f"flowhalf{k}_down", flow, 0.5)], 2, 0.5)
        if k < 4:
            x, xw = p.split(x, 2)
            flow, fw = p.split(flow, 2)
        else:
            xw, fw = x, flow
        p.layer("rife.Warp", f"warp_f{k}", [xw, fw], [f"f{k}"])
    return p.text()


def fusionnet_param_text(widths: Sequence[int] = V23_WIDTHS) -> str:
    _check(widths)
    c = widths[4]
    p = _Writer()
    ctx = [str(3 + i) for i in range(8)]  # c0[0..3], then c1[0..3]
    for name in ("img0", "img1", "flow", *ctx):
        p.layer("Input", name, [], [name])
    big = p.split(p.up2x2("flowx2", "flow"), 3)
    w0 = p.split(p.one("rife.Warp", "warp_img0",
                       ["img0", p.crop("Slice_flow0", big[0], 0, 2)]), 2)
    w1 = p.split(p.one("rife.Warp", "warp_img1",
                       ["img1", p.crop("Slice_flow1", big[1], 2, 4)]), 2)
    x = p.conv2("conv0", p.one("Concat", "cat0", [w0[0], w1[0], big[2]], "0=0"),
                10, c)
    s0 = p.split(p.conv2("down0", x, c, 2 * c), 2)
    s1 = p.split(p.conv2("down1", p.one("Concat", "cat1",
                                        [s0[0], ctx[0], ctx[4]], "0=0"),
                         4 * c, 4 * c), 2)
    s2 = p.split(p.conv2("down2", p.one("Concat", "cat2",
                                        [s1[0], ctx[1], ctx[5]], "0=0"),
                         8 * c, 8 * c), 2)
    s3 = p.conv2("down3", p.one("Concat", "cat3", [s2[0], ctx[2], ctx[6]],
                                "0=0"), 16 * c, 16 * c)
    y = p.deconv("up0", p.one("Concat", "cat4", [s3, ctx[3], ctx[7]], "0=0"),
                 32 * c, 8 * c, prelu=True)
    for k, (skip, cout) in enumerate(((s2[1], 4 * c), (s1[1], 2 * c),
                                      (s0[1], c)), start=1):
        y = p.deconv(f"up{k}", p.one("Concat", f"cat{4 + k}", [y, skip], "0=0"),
                     4 * cout, cout, prelu=True)
    refine = p.split(p.deconv("head", y, c, 4, prelu=False), 2)
    res = p.binop("res_sub", [p.binop("res_mul", [p.one(
        "Sigmoid", "res_sigmoid", [p.crop("Slice_res", refine[0], 0, 3)])],
        2, 2.0)], 1, 1.0)
    m, m2 = p.split(p.one("Sigmoid", "mask_sigmoid",
                          [p.crop("Slice_mask", refine[1], 3, 4)]), 2)
    inv = p.binop("mask_rsub", [m2], 7, 1.0)
    merged = p.binop("blend_add", [p.binop("blend_mul0", [w0[1], m], 2),
                                   p.binop("blend_mul1", [w1[1], inv], 2)], 0)
    out = p.binop("out_add", [merged, res], 0)
    p.layer("Clip", "out_clip", [out], ["output"],
            f"0={0.0:e} 1={1.0:e}")
    return p.text()


_TEXT = {"flownet": flownet_param_text, "contextnet": contextnet_param_text,
         "fusionnet": fusionnet_param_text}


def write_v23_params(out_dir, widths: Sequence[int] = V23_WIDTHS) -> Path:
    """Write ``<out_dir>/rife-v2.3/{flownet,contextnet,fusionnet}.param`` and
    return the model dir.

    The directory name makes the program's model loader pick the v2
    pipeline; the benchmark writes the weights beside it
    (``portbench/weights.py``).  ``widths`` is the four
    flownet block widths followed by the contextnet/fusionnet base width."""
    model_dir = Path(out_dir) / MODEL_NAME
    model_dir.mkdir(parents=True, exist_ok=True)
    for net in NETS:
        text = _TEXT[net](widths)
        path = model_dir / f"{net}.param"
        if not path.exists() or path.read_text() != text:
            tmp = path.with_suffix(".param.tmp")
            tmp.write_text(text)
            tmp.replace(path)
    return model_dir
