"""What a frame, a V2 sample or a training step of a configuration must
compute, counted from the configuration's shapes alone: the products for
`mfu.*` and the cost of each layer's calls for the roofline shares.

Products are counted as 2 FLOP per multiply-add: every convolution (the
DCN's offset convolution and its contraction included), every linear
layer, the decoder's attention products (Q K^T and A V) and the deformable
attention's weighted sums (4 corners per sample and channel). A training
step adds, for the trained frame, the weight- and input-gradient products
of every layer that trains: none for the frozen stem and first stage, no
input gradient into the first block of the second stage (nothing below it
needs one), none for the history frames, which run without gradient.

The roofline costs are those of `roofline` (a frozen copy of the port's
tool), with every contraction at 3xTF32 against 495 TFLOP/s (165 TFLOP/s of
fp32-accurate multiply-adds), every other operation against 67 TFLOP/s
fp32 and the bytes against 3.35 TB/s. The DCN layer is each
`ModulatedDeformConv`: its offset convolution and the DCN (K2; backward K5,
the two products, K6). The msda layer is each deformable attention module
(TSA, SCA's inner attention, the decoder's cross attention): its
projections and the msda call (K1; backward K3/K4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from portbench.yardstick import roofline
from portbench.yardstick.roofline import F32, TF32_PRODUCTS, Cost

PEAK_FP32_ACCURATE_FLOPS = roofline.TF32_FLOPS / TF32_PRODUCTS  # 165 TFLOP/s
DEPTHS = {10: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


@dataclass(frozen=True)
class Product:
    macs: float  # multiply-adds of one forward call
    part: str
    # backward products: the weight's (or, for an attention product, the
    # second operand's) gradient, and the input's
    weight_grad: bool = False
    input_grad: bool = False


def out_size(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def img_size(c) -> Tuple[int, int]:
    d = c.data.size_divisor
    h, w = int(c.data.raw_size[0] * c.data.scale), int(c.data.raw_size[1] * c.data.scale)
    return (h + d - 1) // d * d, (w + d - 1) // d * d


def backbone(c, images: int, h: int, w: int):
    """(products, DCN calls [(b, h, w, c, cout)], stage outputs [(c, h, w)])
    of the ResNet over `images` images of h x w."""
    prods: List[Product] = []
    dcns = []
    frozen = c.optim.frozen_stages

    def conv(cin, cout, k, s, p, hh, ww, stage, first_conv=False, part="backbone"):
        oh, ow = out_size(hh, k, s, p), out_size(ww, k, s, p)
        trains = stage > frozen
        prods.append(Product(images * oh * ow * cin * cout * k * k, part, trains,
                             trains and not (stage == frozen + 1 and first_conv)))
        return oh, ow

    hh, ww = conv(3, 64, 7, 2, 3, h, w, stage=0, first_conv=True)
    hh, ww = out_size(hh, 3, 2, 1), out_size(ww, 3, 2, 1)
    cin, planes, outs = 64, 64, []
    for stage, n in enumerate(DEPTHS[c.backbone_depth], start=1):
        stride = 1 if stage == 1 else 2
        s1, s2 = (stride, 1) if c.backbone_style == "caffe" else (1, stride)
        for b in range(n):
            bin_ = cin if b == 0 else planes * 4
            h1, w1 = conv(bin_, planes, 1, s1 if b == 0 else 1, 0, hh, ww, stage, b == 0)
            if stage - 1 in c.backbone_dcn_stages:
                oh, ow = out_size(h1, 3, s2 if b == 0 else 1, 1), out_size(w1, 3, s2 if b == 0 else 1, 1)
                trains = stage > frozen
                prods.append(Product(images * oh * ow * planes * 27 * 9, "dcn", trains, trains))
                prods.append(Product(images * oh * ow * 9 * planes * planes, "dcn", trains, trains))
                dcns.append((images, h1, w1, planes, planes))
                h2, w2 = oh, ow
            else:
                h2, w2 = conv(planes, planes, 3, s2 if b == 0 else 1, 1, h1, w1, stage)
            conv(planes, planes * 4, 1, 1, 0, h2, w2, stage)
            if b == 0:
                conv(bin_, planes * 4, 1, stride, 0, hh, ww, stage, True)
            hh, ww = h2, w2
        outs.append((planes * 4, hh, ww))
        cin, planes = planes * 4, planes * 2
    return prods, dcns, outs


def neck(c, images: int, stage_outs):
    """(products, level sizes [(h, w)]) of the FPN."""
    used = [stage_outs[i] for i in c.backbone_out_indices]
    e = c.embed_dims
    prods, levels = [], []
    for cin, hh, ww in used:
        prods.append(Product(images * hh * ww * cin * e, "neck", True, True))
        prods.append(Product(images * hh * ww * e * e * 9, "neck", True, True))
        levels.append((hh, ww))
    hh, ww = levels[-1]
    for _ in range(len(used), max(c.num_mono_levels, c.num_feature_levels)):
        hh, ww = out_size(hh, 3, 2, 1), out_size(ww, 3, 2, 1)
        prods.append(Product(images * hh * ww * e * e * 9, "neck", True, True))
        levels.append((hh, ww))
    return prods, levels[: c.num_feature_levels]


def sca_rows(c) -> int:
    q = c.bev_h * c.bev_w
    r = c.sca_capacity_ratio
    return q if not r or r >= 1.0 else min((int(q * r) + 127) // 128 * 128, q)


def linear(rows: float, cin: int, cout: int, part: str) -> Product:
    return Product(rows * cin * cout, part, True, True)


def linear_cost(rows: float, cin: int, cout: int) -> Cost:
    return Cost(F32 * (rows * cin + cin * cout + cout + rows * cout), 0.0,
                TF32_PRODUCTS * 2 * rows * cin * cout)


def msda_sums(b, q, h, d, levels, p) -> float:
    return b * q * h * len(levels) * p * 4 * d


def encoder(c, levels) -> Tuple[List[Product], List[Cost]]:
    """One encoder pass (batch 1): products, and the msda layer's forward
    costs."""
    e, hd, q = c.embed_dims, c.num_heads, c.bev_h * c.bev_w
    d = e // hd
    cams, cap = c.data.num_cams, sca_rows(c)
    k = sum(hh * ww for hh, ww in levels)
    bev = ((c.bev_h, c.bev_w),)
    nl, tp, sp = len(levels), c.tsa_num_points, c.sca_num_points
    prods: List[Product] = []
    costs: List[Cost] = []
    for _ in range(c.encoder_layers):
        tsa = [(2 * q, e, e), (q, 2 * e, 2 * hd * tp * 2), (q, 2 * e, 2 * hd * tp), (q, e, e)]
        sca = [(cams * k, e, e), (cams * cap, e, hd * nl * sp * 2), (cams * cap, e, hd * nl * sp)]
        for rows, ci, co in tsa + sca:
            prods.append(linear(rows, ci, co, "msda"))
            costs.append(linear_cost(rows, ci, co))
        prods.append(Product(msda_sums(2, q, hd, d, bev, tp), "msda", True, True))
        prods.append(Product(msda_sums(cams, cap, hd, d, levels, sp), "msda", True, True))
        costs.append(roofline.msda_fwd(2, q, hd, d, bev, tp))
        costs.append(roofline.msda_fwd(cams, cap, hd, d, levels, sp))
        prods += [linear(q, e, e, "encoder"), linear(q, e, c.feedforward_channels, "encoder"),
                  linear(q, c.feedforward_channels, e, "encoder")]
    return prods, costs


def decoder_and_head(c) -> Tuple[List[Product], List[Cost]]:
    e, hd, nq, q = c.embed_dims, c.num_heads, c.num_query, c.bev_h * c.bev_w
    d = e // hd
    bev = ((c.bev_h, c.bev_w),)
    prods = [linear(nq, e, 3, "decoder")]
    costs: List[Cost] = []
    for _ in range(c.decoder_layers):
        prods += [linear(nq, e, 3 * e, "decoder"), linear(nq, e, e, "decoder"),
                  Product(2 * hd * nq * nq * d, "decoder", True, True)]
        cross = [(q, e, e), (nq, e, hd * 4 * 2), (nq, e, hd * 4), (nq, e, e)]
        for rows, ci, co in cross:
            prods.append(linear(rows, ci, co, "msda"))
            costs.append(linear_cost(rows, ci, co))
        prods.append(Product(msda_sums(1, nq, hd, d, bev, 4), "msda", True, True))
        costs.append(roofline.msda_fwd(1, nq, hd, d, bev, 4))
        prods += [linear(nq, e, c.feedforward_channels, "decoder"),
                  linear(nq, c.feedforward_channels, e, "decoder")]
        for _ in range(c.num_reg_fcs):
            prods += [linear(nq, e, e, "head"), linear(nq, e, e, "head")]
        prods += [linear(nq, e, c.num_classes, "head"), linear(nq, e, c.code_size, "head")]
    return prods, costs


def fusion(c) -> List[Product]:
    e, q = c.embed_dims, c.bev_h * c.bev_w
    cin = len(c.frames) * e
    inter = c.inter_channels or cin
    prods = []
    for i in range(c.num_fusion):
        a = cin if i == 0 else inter
        prods += [Product(q * a * inter * 9, "fusion"), Product(q * inter * inter * 9, "fusion")]
        if a != inter:
            prods.append(Product(q * a * inter * 9, "fusion"))
    return prods + [linear(q, inter, e, "fusion")]


def dcn_fwd_costs(calls) -> List[Cost]:
    out = []
    for b, h, w, ch, cout in calls:
        out.append(roofline.dcn_conv(b, h, w, ch, cout))
        out.append(Cost(F32 * (b * h * w * ch + 27 * 9 * ch + 27 + b * h * w * 27), 0.0,
                        TF32_PRODUCTS * 2 * b * h * w * ch * 27 * 9))
    return out


def dcn_bwd_costs(calls) -> List[Cost]:
    out = []
    for b, h, w, ch, cout in calls:
        pix = b * h * w
        product = Cost(F32 * (pix * 9 * ch + pix * cout + 9 * ch * cout), 0.0,
                       TF32_PRODUCTS * 2 * pix * 9 * ch * cout)
        offset_conv = Cost(2 * F32 * (pix * ch + 27 * 9 * ch + pix * 27), 0.0,
                           2 * TF32_PRODUCTS * 2 * pix * ch * 27 * 9)
        out += [roofline.dcn_im2col(b, h, w, ch), product, product,
                roofline.dcn_col2im(b, h, w, ch), offset_conv]
    return out


def msda_bwd_costs(c, levels, trained_decoder: bool) -> List[Cost]:
    """The msda layer's backward over the trained frame: K3/K4 per call and
    two products per projection."""
    e, hd = c.embed_dims, c.num_heads
    d, q, cams, cap = e // hd, c.bev_h * c.bev_w, c.data.num_cams, sca_rows(c)
    bev = ((c.bev_h, c.bev_w),)
    enc, dec = encoder(c, levels)[1], decoder_and_head(c)[1]
    out = []
    for cost in enc + (dec if trained_decoder else []):
        if cost.tf32_flops:
            out.append(Cost(2 * cost.bytes, 0.0, 2 * cost.tf32_flops))
    for _ in range(c.encoder_layers):
        out += [roofline.msda_bwd(2, q, hd, d, bev, c.tsa_num_points),
                roofline.msda_bwd(cams, cap, hd, d, levels, c.sca_num_points)]
    if trained_decoder:
        out += [roofline.msda_bwd(1, c.num_query, hd, d, bev, 4)] * c.decoder_layers
    return out


@dataclass
class Unit:
    """One frame, V2 sample or training step: FLOP of its products, and the
    least milliseconds of the DCN and msda layers' calls."""

    flops: float
    dcn_bound_ms: float
    msda_bound_ms: float


def bound_ms(costs: Sequence[Cost]) -> float:
    return sum(cost.bound_ms for cost in costs)


def fwd_flops(prods: Sequence[Product]) -> float:
    return 2.0 * sum(p.macs for p in prods)


def bwd_flops(prods: Sequence[Product]) -> float:
    return 2.0 * sum(p.macs * (p.weight_grad + p.input_grad) for p in prods)


def frame(c) -> Unit:
    """A v1 frame, or a V2 sample over `c.frames` (batch 1)."""
    h, w = img_size(c)
    cams = c.data.num_cams
    frames = len(c.frames) if c.version == "v2" else 1
    bb, dcns, outs = backbone(c, cams, h, w)
    nk, levels = neck(c, cams, outs)
    enc, enc_costs = encoder(c, levels)
    dec, dec_costs = decoder_and_head(c)
    per_frame = bb + nk + enc
    prods = per_frame * frames + dec + (fusion(c) if frames > 1 else [])
    return Unit(fwd_flops(prods), frames * bound_ms(dcn_fwd_costs(dcns)),
                frames * bound_ms(enc_costs) + bound_ms(dec_costs))


def train_step(c) -> Unit:
    """A v1 training step: `queue_length - 1` history frames (one backbone
    pass over all their images, then an encoder pass each) without
    gradient, then the trained frame forward and backward."""
    h, w = img_size(c)
    cams, hist = c.data.num_cams, c.data.queue_length - 1
    bb_h, dcn_h, outs = backbone(c, cams * hist, h, w)
    nk_h, levels = neck(c, cams * hist, outs)
    enc, enc_costs = encoder(c, levels)
    bb, dcns, _ = backbone(c, cams, h, w)
    nk, _ = neck(c, cams, outs)
    dec, dec_costs = decoder_and_head(c)
    trained = bb + nk + enc + dec
    flops = fwd_flops(bb_h + nk_h + enc * hist) + fwd_flops(trained) + bwd_flops(trained)
    dcn_ms = bound_ms(dcn_fwd_costs(dcn_h) + dcn_fwd_costs(dcns) + dcn_bwd_costs(dcns))
    msda_ms = (bound_ms(enc_costs) * (hist + 1) + bound_ms(dec_costs)
               + bound_ms(msda_bwd_costs(c, levels, True)))
    return Unit(flops, dcn_ms, msda_ms)


def unit_work(c, unit: str) -> Unit:
    """The work of one unit of a cell: a training `step`, else a frame (a
    V2 sample)."""
    return train_step(c) if unit == "step" else frame(c)
