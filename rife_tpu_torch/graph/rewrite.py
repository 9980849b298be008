"""Exact graph rewrites (copy of ``rife_tpu/graph/rewrite.py``: the seven
rewrites the port's sessions run and their helpers).

Each rewrite returns a new graph (sharing the nodes it did not rewrite) that
computes bit for bit what the original computes; blobs in ``protected`` (the
ones the pipelines extract) are never consumed by a rewrite.  The docstrings
keep the TPU measurements that motivated each rewrite in the JAX package;
on the port they shape which kernels a site reaches.
"""

from __future__ import annotations

from typing import Dict, List

from .ir import Graph, LayerNode

def _rebuild(nodes: List[LayerNode], input_blobs: List[str]) -> Graph:
    producer = {}
    for idx, node in enumerate(nodes):
        for slot, top in enumerate(node.tops):
            producer[top] = (idx, slot)
    return Graph(nodes=nodes, producer=producer, input_blobs=input_blobs)


def _consumer_counts(nodes: List[LayerNode]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for node in nodes:
        for b in node.bottoms:
            counts[b] = counts.get(b, 0) + 1
    return counts


def _downscale_bilinear(node: LayerNode):
    """Scale factor (0.25 or 0.5) for a plain bilinear downscale Interp,
    else None."""
    if (
        node.type == "Interp"
        and int(node.p(0, 0)) == 2
        and int(node.p(3, 0)) == 0
        and int(node.p(4, 0)) == 0
        and len(node.bottoms) == 1
        and float(node.p(1, 0.0)) == float(node.p(2, 0.0))
    ):
        s = float(node.p(1, 0.0))
        if s in (0.25, 0.5):
            return s
    return None


def fuse_prelu_activations(
    graph: Graph, raw_weights, protected: frozenset = frozenset()
):
    """Fold single-consumer PReLU nodes into their producing Convolution/
    Deconvolution as fused activation ``ACT_PRELU_CH`` (params[9] = 100),
    the slope riding the conv's LayerWeights.

    The zoo's v1/v2/v3/v4.0 graphs express every conv activation as a
    separate PReLU node (e.g. rife-v2.3/
    flownet.param — 32 of them), i.e. one full read+write round trip over
    the activation tensor per conv; v4.6 already fuses its leaky relus into
    the conv line (flownet.param:11 ``9=2``).  On the Pallas planar conv
    path the fused form also applies the activation on the f32 accumulator
    before the storage-dtype cast (one rounding instead of two).

    Returns ``(graph, weights)``; both are new objects sharing unmodified
    entries.  Pairs whose intermediate blob is ``protected`` (extractable
    by pipelines) or has more than one consumer are left alone.
    """
    import dataclasses

    counts = _consumer_counts(graph.nodes)
    producer_idx = {}
    for idx, node in enumerate(graph.nodes):
        for top in node.tops:
            producer_idx[top] = idx
    nodes = list(graph.nodes)
    weights = dict(raw_weights)
    dead: set = set()
    for i, node in enumerate(nodes):
        if node.type != "PReLU":
            continue
        src = node.bottoms[0]
        if counts.get(src, 0) != 1 or src in protected:
            continue
        pidx = producer_idx.get(src)
        if pidx is None:
            continue
        p = nodes[pidx]
        if p.type not in ("Convolution", "Deconvolution"):
            continue
        if int(p.p(9, 0)) != 0:
            continue  # already has a fused activation
        lw = weights.get(node.name)
        plw = weights.get(p.name)
        if lw is None or lw.slope is None or plw is None:
            continue
        nodes[pidx] = LayerNode(
            p.type, p.name, list(p.bottoms), list(node.tops),
            {**p.params, 9: 100},
        )
        weights[p.name] = dataclasses.replace(plw, slope=lw.slope)
        dead.add(i)
    if not dead:
        return graph, raw_weights
    nodes = [n for i, n in enumerate(nodes) if i not in dead]
    return _rebuild(nodes, list(graph.input_blobs)), weights


def fuse_concat_into_convs(
    graph: Graph, protected: frozenset = frozenset(),
    flatten_nested: bool = False,
) -> Graph:
    """Replace ``Convolution(Concat(parts...))`` (channel-axis concat with
    a single consumer, 3x3 stride-2 conv) with one ``ConvolutionCat`` node
    whose bottoms are the parts.

    Every pyramid block of the zoo's flownets starts exactly this way —
    e.g. the v4 IFBlock encoders consume concat(warped0, warped1, timestep,
    mask, flow) (rife-v4.6/flownet.param:166) and
    the v2 blocks concat(img0, img1, flow) — and on TPU the materialized
    narrow concat is pure HBM traffic (42.7 ms of the B=24 v4.6 NHWC step
    for the 12ch one).  The planar op table feeds the parts straight into
    the direct stride-2 kernel's band slots; the NHWC table concatenates
    and delegates (identical semantics, so the rewrite is always safe).
    """
    counts = _consumer_counts(graph.nodes)
    producer_idx = {}
    for idx, node in enumerate(graph.nodes):
        for top in node.tops:
            producer_idx[top] = idx
    nodes = list(graph.nodes)
    dead: set = set()
    changed = False
    for i, node in enumerate(nodes):
        if node.type != "Convolution":
            continue
        _, k, dilation, stride, pad, _ = (
            int(node.p(0)), int(node.p(1)), int(node.p(2, 1)),
            int(node.p(3, 1)), int(node.p(4, 0)), int(node.p(5, 0)),
        )
        if (k, dilation, stride, pad) != (3, 1, 2, 1):
            continue
        src = node.bottoms[0]
        if counts.get(src, 0) != 1 or src in protected:
            continue
        pidx = producer_idx.get(src)
        if pidx is None:
            continue
        p = nodes[pidx]
        if p.type != "Concat" or int(p.p(0, 0)) != 0 or len(p.bottoms) < 2:
            continue

        # channel concat is associative: flatten nested single-consumer
        # concats so the v4 block entries' cat(cat(w0, w1, t, m), flow)
        # exposes ALL parts.  Only profitable where the consumer DMAs
        # parts directly (the planar direct-s2 band slots — the inner
        # 8-ch full-res concat then never materializes); on the NHWC
        # table the flat 5-part jnp.concatenate measured SLOWER than the
        # nested form (49.2 -> 47.8 fps on the v4.6 headline: XLA picks
        # worse layouts for the wide flat concat), so flat-mode callers
        # keep flatten_nested=False.
        inner_dead: set = set()

        def flatten(blob):
            if flatten_nested:
                bidx = producer_idx.get(blob)
                if bidx is not None:
                    q = nodes[bidx]
                    if (q.type == "Concat" and int(q.p(0, 0)) == 0
                            and counts.get(blob, 0) == 1
                            and blob not in protected):
                        inner_dead.add(bidx)
                        return [x for b in q.bottoms for x in flatten(b)]
            return [blob]

        parts = [x for b in p.bottoms for x in flatten(b)]
        nodes[i] = LayerNode(
            "ConvolutionCat", node.name, parts, list(node.tops),
            dict(node.params),
        )
        dead.add(pidx)
        dead.update(inner_dead)
        changed = True
    if not changed:
        return graph
    nodes = [n for i, n in enumerate(nodes) if i not in dead]
    return _rebuild(nodes, list(graph.input_blobs))


def fuse_pixelshuffle_into_convs(
    graph: Graph, protected: frozenset = frozenset()
) -> Graph:
    """Replace ``PixelShuffle(r=2)(Convolution|Deconvolution)`` with a single
    ``rife.ConvPS`` / ``rife.DeconvPS`` node (conv params preserved; the
    shuffle factor rides param key 25, unused by ncnn conv layers).

    Every zoo graph ends its decoder this way — the v4 block tails
    ``Deconvolution(4x4 s2, 24ch) -> PixelShuffle(2) -> flow``
    (rife-v4.6/flownet.param:45-46) and the v1-family
    ``Convolution(3x3, 8-16ch) -> PixelShuffle(2)``
    (rife/flownet.param:77-78).  On the NHWC table the
    fused node just composes the two ops (identical semantics, so the rewrite
    is always safe); on the planar table the shuffle's channel regrouping is
    baked into the conv's OUTPUT-CHANNEL ORDER (a weight permutation, done
    once), which turns the H interleave into a free BHCW reshape and
    collapses the deconv phase interleave + full-res PixelShuffle relayout
    into one lane interleave (ops/conv_planar.py deconv_ps_planar).
    """
    counts = _consumer_counts(graph.nodes)
    producer_idx = {}
    for idx, node in enumerate(graph.nodes):
        for top in node.tops:
            producer_idx[top] = idx
    nodes = list(graph.nodes)
    dead: set = set()
    changed = False
    for i, node in enumerate(nodes):
        if node.type != "PixelShuffle" or int(node.p(0, 1)) != 2:
            continue
        src = node.bottoms[0]
        if counts.get(src, 0) != 1 or src in protected:
            continue
        pidx = producer_idx.get(src)
        if pidx is None:
            continue
        p = nodes[pidx]
        if p.type == "Convolution":
            fused = "rife.ConvPS"
        elif p.type == "Deconvolution":
            _, k, _, stride, pad, _ = (
                int(p.p(0)), int(p.p(1)), int(p.p(2, 1)),
                int(p.p(3, 1)), int(p.p(4, 0)), int(p.p(5, 0)),
            )
            if (k, stride, pad) != (4, 2, 1):
                continue  # planar phase decomposition assumes this geometry
            fused = "rife.DeconvPS"
        else:
            continue
        if int(p.p(0, 0)) % 4:
            continue  # out channels must split into r*r groups
        nodes[pidx] = LayerNode(
            fused, p.name, list(p.bottoms), list(node.tops),
            {**p.params, 25: 2},
        )
        dead.add(i)
        changed = True
    if not changed:
        return graph
    nodes = [n for i, n in enumerate(nodes) if i not in dead]
    return _rebuild(nodes, list(graph.input_blobs))


def fuse_render_blend(
    graph: Graph, protected: frozenset = frozenset()
) -> Graph:
    """Fuse the final render ``warp_a*mask + warp_b*(1-mask)`` into one
    ``rife.RenderBlend`` node.

    Every v4 flownet ends with exactly this pattern
    (rife-v4.6/flownet.param:208-217):

        Sigmoid -> Split -> m, m2
        inv   = BinaryOp(rsub, scalar 1.0)(m2)       # 1 - mask
        w_a   = rife.Warp(img_a, flow_a)
        w_b   = rife.Warp(img_b, flow_b)
        out0  = w_a * m + w_b * inv

    On TPU the unfused tail is the single most lane-padded stretch of the
    graph: the two warp results, both muls and the add are C=3 tensors at
    full resolution that XLA stores feature-minor padded to 128 lanes
    (42x their true bytes; measured 44 ms of the 506 ms B=24 1080p step
    beyond the warps' own cost).  The fused node blends per-channel PLANES
    (the Pallas warp kernels produce planes natively) and hands the result
    to ``frame.postprocess_planar``, so no lane-padded NHWC tensor ever
    materializes on the render path.  The blend algebra (bf16 mul/add,
    same operand order) is bit-identical — elementwise math is layout-
    independent.

    The fused node's bottoms are ``[img_a, flow_a, img_b, flow_b, mask]``
    with semantics ``warp(img_a, flow_a)*mask + warp(img_b, flow_b)*
    (1-mask)``.  Fires only when every intermediate blob has a single
    consumer and none is ``protected``.
    """
    counts = _consumer_counts(graph.nodes)
    producer_idx = {}
    for idx, node in enumerate(graph.nodes):
        for top in node.tops:
            producer_idx[top] = idx

    def single(blob):
        return counts.get(blob, 0) == 1 and blob not in protected

    def producer(blob):
        i = producer_idx.get(blob)
        return None if i is None else graph.nodes[i]

    nodes = list(graph.nodes)
    changed = False
    for i, node in enumerate(nodes):
        # out = add(mul_a, mul_b)
        if node.type != "BinaryOp" or int(node.p(0, 0)) != 0 \
                or int(node.p(1, 0)) == 1 or len(node.bottoms) != 2:
            continue
        muls = [producer(b) for b in node.bottoms]
        if any(
            m is None or m.type != "BinaryOp" or int(m.p(0, 0)) != 2
            or int(m.p(1, 0)) == 1 or len(m.bottoms) != 2
            or not single(m.tops[0])
            for m in muls
        ):
            continue

        def warp_and_mask(m):
            """Split a mul's bottoms into (warp node, mask blob)."""
            for k in (0, 1):
                p = producer(m.bottoms[k])
                if p is not None and p.type == "rife.Warp" \
                        and len(p.bottoms) == 2 and single(m.bottoms[k]):
                    return p, m.bottoms[1 - k]
            return None, None

        wa, ma = warp_and_mask(muls[0])
        wb, mb = warp_and_mask(muls[1])
        if wa is None or wb is None:
            continue
        # one mask operand must be 1-x of a sibling copy of the other
        def inv_source(blob):
            p = producer(blob)
            if p is not None and p.type == "BinaryOp" \
                    and int(p.p(0, 0)) == 7 and int(p.p(1, 0)) == 1 \
                    and float(p.p(2, 0.0)) == 1.0 and single(blob):
                return p.bottoms[0]
            return None

        def same_value(x, y):
            if x == y:
                return True
            px, py = producer_idx.get(x), producer_idx.get(y)
            return (px is not None and px == py
                    and nodes[px].type == "Split")

        direct, inv = (wa, ma, wb, mb), inv_source(mb)
        if inv is None or not same_value(ma, inv):
            inv = inv_source(ma)
            if inv is None or not same_value(mb, inv):
                continue
            direct = (wb, mb, wa, ma)
        w_m, mask, w_inv, _ = direct
        nodes[i] = LayerNode(
            "rife.RenderBlend", f"{node.name}__render",
            [w_m.bottoms[0], w_m.bottoms[1],
             w_inv.bottoms[0], w_inv.bottoms[1], mask],
            list(node.tops), {},
        )
        changed = True
        # the dead warps/muls/rsub stay in the node list: the executor's
        # demand-driven traversal never runs them
    if not changed:
        return graph
    return _rebuild(nodes, list(graph.input_blobs))


def fuse_quarter_downscaled_warps(
    graph: Graph, protected: frozenset = frozenset(),
    fuse_half: bool = True,
) -> Graph:
    """Apply R1 + R2 until fixpoint.  Returns a new Graph (shares nodes that
    were not rewritten); no weighted layer is added or removed.

    ``protected`` is the set of blob names callers may extract from the
    rewritten graph (flow taps, net outputs): a rewrite that would consume
    one of those blobs is skipped, so extraction stays safe by construction
    instead of by the convention that pipelines only pull taps/outputs."""
    nodes = list(graph.nodes)
    changed = True
    n_rewrites = 0
    while changed:
        changed = False
        counts = _consumer_counts(nodes)
        producer = {}
        for idx, node in enumerate(nodes):
            for top in node.tops:
                producer[top] = idx
        for i, node in enumerate(nodes):
            scale = _downscale_bilinear(node)
            if scale is None:
                continue
            src = node.bottoms[0]
            if src not in producer or counts.get(src, 0) != 1:
                continue
            if src in protected:
                continue
            p = nodes[producer[src]]
            if p.type == "Concat" and len(p.tops) == 1 and int(
                p.p(0, 0)
            ) == 0 and any(  # channel-axis concat only: resize is channelwise
                b in producer
                and nodes[producer[b]].type == "rife.Warp"
                and counts.get(b, 0) == 1
                for b in p.bottoms
            ):
                # R1: split the downscale across the concat inputs
                new: List[LayerNode] = []
                parts = []
                for k, x in enumerate(p.bottoms):
                    blob = f"{node.tops[0]}__part{k}"
                    new.append(LayerNode(
                        "Interp", f"{node.name}__part{k}", [x], [blob],
                        dict(node.params),
                    ))
                    parts.append(blob)
                new.append(LayerNode(
                    "Concat", f"{node.name}__cat", parts, [node.tops[0]],
                    dict(p.params),
                ))
                nodes[i : i + 1] = new
                # drop the now-dead original Concat: leaving it in would keep
                # counting it as a consumer of the warp blobs and block R2's
                # single-consumer guard forever.  Its top (``src``) loses its
                # producer — legal because this rewrite only fired when that
                # blob had exactly one consumer (the Interp just replaced).
                idx_p = producer[src]
                assert idx_p < i  # param files are topological
                del nodes[idx_p]
                n_rewrites += 1
                changed = True
                break
            if (p.type == "rife.Warp" and len(p.bottoms) == 2
                    and (scale == 0.25 or (scale == 0.5 and fuse_half))):
                # R2: 1/4 -> compacted tap-grid warp (rife.WarpDs4 — the
                # downsample reads only rows/cols {4i+1,4i+2}, so half the
                # gathers disappear); 1/2 -> phase-accumulated warp
                # (rife.WarpDs2 — every pixel is read, but the full-res
                # warped tensor never materializes in HBM and the separate
                # resize pass disappears)
                ttype = "rife.WarpDs4" if scale == 0.25 else "rife.WarpDs2"
                nodes[i] = LayerNode(
                    ttype, f"{node.name}__fused",
                    list(p.bottoms), list(node.tops), {},
                )
                n_rewrites += 1
                changed = True
                break
    if n_rewrites == 0:
        return graph
    return _rebuild(nodes, list(graph.input_blobs))


def fuse_sibling_warps(graph: Graph) -> Graph:
    """Pair independent same-type warp nodes into one two-warp node.

    The v4 flownet warps BOTH input frames at every refinement scale
    (warp_2+warp_3, warp_4+warp_5 in rife-v4.6,
    rife-v4.6/flownet.param — each block consumes
    the warped frame PAIR).  On TPU each Pallas warp call pays a Mosaic
    per-grid-cell fixed cost (~6 us x B*H/8 cells — the measured
    empty-range floor, ops/warp_pallas.py); one pallas_call that runs both
    warps back-to-back over shared scratch pays it once.  This rewrite
    turns two ``rife.Warp`` nodes into ``rife.WarpPair`` (and two
    ``rife.WarpDs4`` into ``rife.WarpDs4Pair``) with bottoms
    ``[img_a, flow_a, img_b, flow_b]`` and tops ``[out_a, out_b]``.

    Exactness: the pair kernels run the identical accumulate body per
    image (ops/warp_pallas.py::warp_pallas_pair — bit-identical to two
    calls); the op handler falls back to two single-warp lowerings when
    the fused kernel's gates don't hold.

    Safety: both tops survive (no blob disappears), so extraction needs no
    protected set.  A pair only forms when (a) both warps are LIVE (their
    tops have a consumer — pairing a dead warp with a live one would
    resurrect it: the executor is demand-driven and a demanded pair runs
    both bodies), and (b) the SECOND node's inputs are all produced before
    the FIRST node (the pair executes at the first node's position), or
    symmetrically nothing between them consumes the first node's tops (the
    pair executes at the second node's position)."""
    nodes = list(graph.nodes)
    counts = _consumer_counts(nodes)
    produced_at: Dict[str, int] = {}
    for idx, node in enumerate(nodes):
        for top in node.tops:
            produced_at[top] = idx

    PAIRABLE = {"rife.Warp": "rife.WarpPair",
                "rife.WarpDs4": "rife.WarpDs4Pair"}

    def live(node: LayerNode) -> bool:
        return all(counts.get(t, 0) > 0 for t in node.tops)

    candidates = [
        i for i, n in enumerate(nodes)
        if n.type in PAIRABLE and len(n.bottoms) == 2 and live(n)
    ]
    taken: set = set()
    pairs = []  # (i, j, position)
    for a_pos, i in enumerate(candidates):
        if i in taken:
            continue
        for j in candidates[a_pos + 1:]:
            if j in taken or nodes[j].type != nodes[i].type:
                continue
            if all(produced_at.get(b, -1) < i for b in nodes[j].bottoms):
                pairs.append((i, j, i))
            else:
                tops_i = set(nodes[i].tops)
                # Include node j itself: a warp consuming its sibling's
                # output would otherwise fuse into a self-dependent pair
                # whose own top appears among its bottoms (executor
                # KeyError at run time).
                between = nodes[i + 1 : j + 1]
                if any(b in tops_i for n in between for b in n.bottoms):
                    continue
                pairs.append((i, j, j))
            taken.add(i)
            taken.add(j)
            break
    if not pairs:
        return graph

    replaced: Dict[int, LayerNode] = {}
    dropped: set = set()
    for i, j, pos in pairs:
        a, b = nodes[i], nodes[j]
        replaced[pos] = LayerNode(
            PAIRABLE[a.type], f"{a.name}+{b.name}",
            list(a.bottoms) + list(b.bottoms),
            list(a.tops) + list(b.tops), {},
        )
        dropped.add(i if pos == j else j)
    out: List[LayerNode] = []
    for idx, node in enumerate(nodes):
        if idx in dropped:
            continue
        out.append(replaced.get(idx, node))
    return _rebuild(out, list(graph.input_blobs))


def push_concat_through_interp(
    graph: Graph, protected: frozenset = frozenset()
) -> Graph:
    """Swap ``Interp(Concat(parts...))`` into ``Concat(Interp(parts)...)``
    when the channel-axis concat's ONLY consumer is the Interp.

    Why: the v3.x flownets enter each pyramid level by bilinearly
    DOWNSCALING the concat of (warped frame pair, flow)
    (rife-v3.1/flownet.param Concat_133 ->
    Resize_135), unlike v2.x whose block entries are stride-2 convs (those
    concats are absorbed by fuse_concat_into_convs).  On TPU, XLA's layout
    assignment puts the CONCAT axis of that full-resolution axis-2
    (planar) / axis-3 (NHWC) concatenate on the 128-wide lane dimension,
    lane-padding every 1-channel operand copy 128x — measured 1.99 GB per
    plane at B=4 1080p (round-5 OOM analysis, BASELINE.md): the v3.1 step
    exceeded HBM by ~9.8 GB of pure padding.  Resizing the parts FIRST
    shrinks any badly-laid tensor by the scale factor squared and leaves
    the full-res planes consumed only by layout-agnostic elementwise
    chains.

    Exactness: both nearest and half-pixel bilinear resizes (and the
    jax.image.resize fallback) are strictly PER-CHANNEL — resize and
    channel-concat commute element-for-element, so outputs are
    bit-identical.

    Only scale-factor DOWNSCALE Interps (params 1/2 < 1, no fixed output
    size 3/4) are rewritten.  Upsample sites are deliberately left fused:
    splitting v4.6's x2 flow upsamples measured a 1-LSB u8 drift on 0.01%
    of pixels (XLA re-contracts the lerp FMAs across the new fusion
    boundary), and the memory pathology this rewrite exists for is
    specific to FULL-RESOLUTION concats, which only the downscale sites
    consume.
    """
    counts = _consumer_counts(graph.nodes)
    producer_idx: Dict[str, int] = {}
    for idx, node in enumerate(graph.nodes):
        for top in node.tops:
            producer_idx[top] = idx

    nodes = list(graph.nodes)
    out: List[LayerNode] = []
    rewritten = 0
    for idx, node in enumerate(nodes):
        if node.type != "Interp":
            out.append(node)
            continue
        src = node.bottoms[0]
        pidx = producer_idx.get(src)
        cat = nodes[pidx] if pidx is not None else None
        if (
            cat is None
            or cat.type != "Concat"
            or int(cat.p(0, 0)) != 0  # channel-axis concats only
            or counts.get(src, 0) != 1
            or src in protected
            # scale-factor resizes only (fixed sizes don't commute with
            # per-part rounding of output dims)
            or float(node.p(3, 0)) != 0
            or float(node.p(4, 0)) != 0
            # downscales only (see docstring)
            or not 0 < float(node.p(1, 0)) < 1
            or not 0 < float(node.p(2, 0)) < 1
        ):
            out.append(node)
            continue
        # replace: per-part Interp -> Concat at the resized resolution
        part_tops = []
        for k, part in enumerate(cat.bottoms):
            t = f"{node.name}__part{k}"
            out.append(LayerNode("Interp", f"{node.name}__p{k}", [part],
                                 [t], dict(node.params)))
            part_tops.append(t)
        out.append(LayerNode("Concat", node.name, part_tops,
                             list(node.tops), dict(cat.params)))
        rewritten += 1
    if not rewritten:
        return graph
    # drop concats that lost their only consumer
    counts2 = _consumer_counts(out)
    out = [
        n for n in out
        if not (n.type == "Concat"
                and all(counts2.get(t, 0) == 0 and t not in protected
                        for t in n.tops))
    ]
    return _rebuild(out, list(graph.input_blobs))
