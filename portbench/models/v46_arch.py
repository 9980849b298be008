"""In-repo reconstruction of the rife-v4.6 flownet graph as ncnn ``.param`` text
(a frozen copy of the program's ``models/v46_arch.py`` writer, so that the
graph the benchmark measures belongs to the benchmark).

The real ``rife-v4.6/flownet.param`` is not in the repository.  Until it is,
the port runs on this reconstruction, written from the architecture the repo
records (SURVEY.md §2.3 v4 family, ``rife_tpu/graph/rewrite.py`` and the
blob walks of ``tools/profile_prefix.py`` / ``tools/profile_b3.py``).  Its
weights are the deterministic synthetic ones every run so far has used (no
flownet ``.bin`` ever shipped), so every number printed from it belongs to
the "v4.6-architecture graph (in-repo reconstruction, synthetic weights)",
never to rife-v4.6 itself.

Structure: four IFBlocks at scales 8, 4, 2, 1 with widths c/2 -> c of
96/192, 64/128, 48/96 and 32/64.  Each block:

* entry: bilinear ``Interp`` to 1/scale, then two 3x3 stride-2
  ``Convolution`` layers to c/2 and c with fused leaky relu 0.2 (``9=2``);
* body: 8 residual units ``x + leaky(conv3x3(x))``;
* head: 4x4 stride-2 ``Deconvolution`` to 24 channels, ``PixelShuffle`` 2
  -> the 6-channel tap ``flow0..flow3`` (at 1/8, 1/4, 1/2, 1/1);
* merge: the tap is upsampled back to full resolution, ``Crop`` cuts flow
  (4 channels) and mask (1 channel), and ``Eltwise`` weighted sums
  accumulate them (coefficients (1, scale) for the flow).

Eight ``rife.Warp`` nodes read ``Split`` copies of ``in0``/``in1``:
warp_0/1 at full resolution then Concat + 1/4 Interp (block 1 entry),
warp_2/3 then Concat + 1/2 Interp (block 2 entry), warp_4/5 straight into
block 3's 12-channel concat, and warp_6/7 in the render tail
``out0 = warp_6 * m + warp_7 * (1 - m)``, ``m = sigmoid(mask)``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

V46_WIDTHS = (192, 128, 96, 64)
SCALES = (8, 4, 2, 1)
MODEL_NAME = "rife-v4.6"
LABEL = "v4.6-architecture graph (in-repo reconstruction, synthetic weights)"

_LEAKY = "9=2 -23310=1,2.000000e-01"


class _ParamWriter:
    def __init__(self):
        self.lines: List[str] = []
        self.blobs: List[str] = []

    def layer(self, kind: str, name: str, bottoms: Sequence[str],
              tops: Sequence[str], params: str = "") -> List[str]:
        fields = [kind, name, str(len(bottoms)), str(len(tops)),
                  *bottoms, *tops]
        if params:
            fields.append(params)
        self.lines.append(" ".join(fields))
        self.blobs.extend(tops)
        return list(tops)

    def one(self, kind, name, bottoms, params="") -> str:
        return self.layer(kind, name, bottoms, [name], params)[0]

    def split(self, blob: str, n: int) -> List[str]:
        return self.layer("Split", f"{blob}_split", [blob],
                          [f"{blob}_s{k}" for k in range(n)])

    def interp(self, name: str, blob: str, scale: float) -> str:
        return self.one("Interp", name, [blob],
                        f"0=2 1={scale:e} 2={scale:e}")

    def conv(self, name: str, blob: str, cin: int, cout: int, *,
             stride: int) -> str:
        return self.one(
            "Convolution", name, [blob],
            f"0={cout} 1=3 3={stride} 4=1 5=1 6={cout * cin * 9} {_LEAKY}")

    def crop(self, name: str, blob: str, start: int, end: int) -> str:
        return self.one("Crop", name, [blob],
                        f"-23309=1,{start} -23310=1,{end} -23311=1,0")

    def scale(self, name: str, blob: str, s: float) -> str:
        return self.one("BinaryOp", name, [blob], f"0=2 1=1 2={s:e}")

    def eltwise(self, name: str, a: str, b: str, cb: float) -> str:
        return self.one("Eltwise", name, [a, b],
                        f"0=1 -23301=2,{1.0:e},{cb:e}")

    def text(self) -> str:
        return (f"7767517\n{len(self.lines)} {len(self.blobs)}\n"
                + "\n".join(self.lines) + "\n")


def _ifblock(p: _ParamWriter, i: int, entry: str, cin: int, c: int) -> str:
    """Encoder, residual body and deconv+PixelShuffle head; returns the tap."""
    x = p.conv(f"conv{i}_0", entry, cin, c // 2, stride=2)
    x = p.conv(f"conv{i}_1", x, c // 2, c, stride=2)
    for k in range(8):
        a, b = p.layer("Split", f"res{i}_{k}_split", [x],
                       [f"res{i}_{k}_a", f"res{i}_{k}_b"])
        y = p.conv(f"res{i}_{k}_conv", a, c, c, stride=1)
        x = p.one("BinaryOp", f"res{i}_{k}_add", [y, b], "0=0")
    d = p.one("Deconvolution", f"deconv{i}", [x],
              f"0=24 1=4 3=2 4=1 5=1 6={c * 24 * 16}")
    return p.layer("PixelShuffle", f"pixelshuffle{i}", [d], [f"flow{i}"],
                   "0=2")[0]


def flownet_param_text(widths: Sequence[int] = V46_WIDTHS) -> str:
    """ncnn ``.param`` text of the v4.6-architecture flownet."""
    if len(widths) != 4 or any(c % 2 for c in widths):
        raise ValueError(f"need four even block widths, got {widths!r}")
    p = _ParamWriter()
    for name in ("in0", "in1", "in2"):
        p.layer("Input", name, [], [name])
    img0 = p.split("in0", 5)
    img1 = p.split("in1", 5)
    tplane = p.split("in2", 4)

    flow = mask = None
    warped = None
    for i, (c, s) in enumerate(zip(widths, SCALES)):
        if i == 0:
            cat = p.one("Concat", "cat0", [img0[0], img1[0], tplane[0]], "0=0")
            entry, cin = p.interp("interp0", cat, 1.0 / s), 7
        else:
            flow_in, flow_acc = flow[1], flow[2]
            mask_in, mask_acc = mask
            if s > 1:
                wcat = p.one("Concat", f"warpcat{i}", warped, "0=0")
                parts = [
                    p.interp(f"interp{i}_warp", wcat, 1.0 / s),
                    p.interp(f"interp{i}_t", tplane[i], 1.0 / s),
                    p.interp(f"interp{i}_mask", mask_in, 1.0 / s),
                    p.scale(f"flowscale{i}",
                            p.interp(f"interp{i}_flow", flow_in, 1.0 / s),
                            1.0 / s),
                ]
            else:
                parts = [*warped, tplane[i], mask_in, flow_in]
            entry, cin = p.one("Concat", f"cat{i}", parts, "0=0"), 12
        tap = _ifblock(p, i, entry, cin, c)

        up = p.interp(f"upsample{i}", tap, float(s)) if s > 1 else tap
        up_f, up_m = p.split(up, 2)
        dflow = p.crop(f"crop{i}_flow", up_f, 0, 4)
        dmask = p.crop(f"crop{i}_mask", up_m, 4, 5)
        if i == 0:
            f_new, m_new = p.scale("flowscale0", dflow, float(s)), dmask
        else:
            f_new = p.eltwise(f"flowacc{i}", flow_acc, dflow, float(s))
            m_new = p.eltwise(f"maskacc{i}", mask_acc, dmask, 1.0)

        if i < 3:
            flow = p.split(f_new, 3)  # warps, next entry, next accumulation
            mask = p.split(m_new, 2)  # next entry, next accumulation
            fa, fb = p.layer("Slice", f"flowslice{i}", [flow[0]],
                             [f"flowslice{i}_a", f"flowslice{i}_b"],
                             "-23300=2,2,2 1=0")
            warped = [
                p.one("rife.Warp", f"warp_{2 * i}", [img0[i + 1], fa]),
                p.one("rife.Warp", f"warp_{2 * i + 1}", [img1[i + 1], fb]),
            ]
        else:
            # render tail; the flow crops interleave with the warps as the
            # converter emits them
            fl = p.split(f_new, 2)
            wm = p.one("rife.Warp", "warp_6",
                       [img0[4], p.crop("crop_render_a", fl[0], 0, 2)])
            m, m2 = p.layer("Split", "mask_split", [p.one("Sigmoid", "sigmoid",
                                                          [m_new])],
                            ["mask_m", "mask_m2"])
            mul_a = p.one("BinaryOp", "mul_a", [wm, m], "0=2")
            wi = p.one("rife.Warp", "warp_7",
                       [img1[4], p.crop("crop_render_b", fl[1], 2, 4)])
            inv = p.one("BinaryOp", "rsub", [m2], "0=7 1=1 2=1.000000e+00")
            mul_b = p.one("BinaryOp", "mul_b", [wi, inv], "0=2")
            p.layer("BinaryOp", "add_out", [mul_a, mul_b], ["out0"], "0=0")
    return p.text()


def write_flownet_param(out_dir, widths: Sequence[int] = V46_WIDTHS) -> Path:
    """Write ``<out_dir>/rife-v4.6/flownet.param`` and return the model dir.

    The directory name makes the program's model loader pick the v4
    pipeline; the benchmark writes the weights beside it
    (``portbench/weights.py``)."""
    model_dir = Path(out_dir) / MODEL_NAME
    model_dir.mkdir(parents=True, exist_ok=True)
    text = flownet_param_text(widths)
    path = model_dir / "flownet.param"
    if not path.exists() or path.read_text() != text:
        tmp = path.with_suffix(".param.tmp")
        tmp.write_text(text)
        tmp.replace(path)
    return model_dir
