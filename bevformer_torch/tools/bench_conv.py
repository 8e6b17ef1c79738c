"""The dense convolutions of the backbone and the neck on the card, one
shape at a time: the kernel `conv_fwd` (`kernels.conv.conv2d_nhwc`, with
the site's norm, residual and ReLU in its epilogue) against the present
path (cuDNN fp32 by its heuristics with TF32 off, then the norm's, the
add's and the ReLU's own kernels), both through `models.resnet.conv_norm`
on seeded weights and N(0, 1) inputs in channels-last memory, each timed
by `common.time_ms` (an L2 flush before each call). Each output is held to
F.conv2d in fp64 (the same affine, residual and ReLU after it): the error
is the largest absolute difference over the output's largest magnitude.

    python3 -m bevformer_torch.tools.bench_conv [config ...] [--reps 10]

Configs default to bevformer_base and bevformerv2-r50-t8 at their cells'
sizes (the six cameras of one frame). One JSON line per distinct shape
(`models.conv_sites`: Cin, Cout, kernel, stride, input size and epilogue;
`calls` a frame), with both times, TFLOP/s, the bound
(`tools.roofline.conv_fwd`: FLOP at 165 TFLOP/s, three TF32 products a
multiply-add, or bytes at 3.35 TB/s, the larger) and each path's share of
it; then one line per config with the sums a frame.
Without a card it raises.
"""

from __future__ import annotations

import argparse
import collections
import json
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from bevformer_torch.configs import get_config
from bevformer_torch.models import resnet
from bevformer_torch.models.conv_sites import conv_sites
from bevformer_torch.tools import roofline
from bevformer_torch.tools.common import card_line, require_cuda, time_ms

CONFIGS = ("bevformer_base", "bevformerv2-r50-t8")


def shape_key(site: dict) -> tuple:
    return tuple(site[k] for k in ("cin", "cout", "k", "stride", "b", "h", "w", "norm", "relu",
                                   "residual"))


def cost(site: dict) -> Dict[str, float]:
    """The site's FLOP (2 a multiply-add), and the bytes and least time of
    `tools.roofline.conv_fwd`."""
    flop = 2.0 * site["b"] * site["oh"] * site["ow"] * site["cout"] * site["cin"] * site["k"] ** 2
    c = roofline.conv_fwd(site["b"], site["h"], site["w"], site["cin"], site["oh"], site["ow"],
                          site["cout"], site["k"], site["residual"])
    return dict(flop=flop, bytes=c.bytes, bound_ms=c.bound_ms, bound_by=c.bound_by)


def build_site(site: dict, device, seed: int = 0):
    """The site's conv, its norm (seeded statistics, eval mode) and inputs:
    x and the residual NCHW in channels-last memory."""
    gen = torch.Generator().manual_seed(seed)
    conv = nn.Conv2d(site["cin"], site["cout"], site["k"], site["stride"], site["pad"],
                     bias=site["norm"] is None)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                          * (2.0 / (site["cin"] * site["k"] ** 2)) ** 0.5)
        if conv.bias is not None:
            conv.bias.copy_(torch.randn(site["cout"], generator=gen) * 0.1)
    norm = None
    if site["norm"] is not None:
        norm = resnet.make_norm(site["norm"], site["cout"]).eval()
        c = site["cout"]
        for name, v in (("weight", 1 + 0.1 * torch.randn(c, generator=gen)),
                        ("bias", 0.1 * torch.randn(c, generator=gen)),
                        ("running_mean", 0.1 * torch.randn(c, generator=gen)),
                        ("running_var", 0.5 + torch.rand(c, generator=gen))):
            getattr(norm, name).data.copy_(v)
    conv, norm = conv.to(device), None if norm is None else norm.to(device)
    x = torch.randn(site["b"], site["h"], site["w"], site["cin"], generator=gen)
    res = None
    if site["residual"]:
        res = torch.randn(site["b"], site["oh"], site["ow"], site["cout"], generator=gen)
        res = res.to(device).permute(0, 3, 1, 2)
    return conv, norm, x.to(device).permute(0, 3, 1, 2), res


def fp64_reference(conv, norm, x, res, relu: bool) -> torch.Tensor:
    """The site in fp64: F.conv2d, then the norm's affine, the residual, the
    ReLU (NCHW)."""
    scale, shift = resnet._norm_affine(conv, norm)
    y = F.conv2d(x.double(), conv.weight.double(), None, conv.stride, conv.padding)
    y = y * scale.double()[:, None, None] + shift.double()[:, None, None]
    if res is not None:
        y = y + res.double()
    return F.relu(y) if relu else y


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def fallback(conv, norm, x, res, relu: bool) -> torch.Tensor:
    """The present path, as `conv_norm` takes it where the kernel does not
    engage."""
    out = conv(x)
    if norm is not None:
        out = norm(out)
    if res is not None:
        out = out + res
    return F.relu(out) if relu else out


def measure(site: dict, calls: int, device, reps: int) -> dict:
    conv, norm, x, res = build_site(site, device)
    relu = site["relu"]
    with torch.no_grad():
        ref = fp64_reference(conv, norm, x, res, relu)
        kernel_ms, out = time_ms(lambda: resnet.conv_norm(x, conv, norm, relu, res), reps)
        cudnn_ms, base = time_ms(lambda: fallback(conv, norm, x, res, relu), reps)
        kernel_err, cudnn_err = rel_err(out, ref), rel_err(base, ref)
    c = cost(site)
    rec = dict(tool="bench_conv", case=site["name"], calls=calls,
               **{k: site[k] for k in ("cin", "cout", "k", "stride", "b", "h", "w", "oh", "ow",
                                       "norm", "relu", "residual")},
               engaged=site["engaged"], kernel_ms=kernel_ms, cudnn_ms=cudnn_ms,
               speedup=cudnn_ms / kernel_ms, kernel_tflops=c["flop"] / kernel_ms / 1e9,
               cudnn_tflops=c["flop"] / cudnn_ms / 1e9, **c,
               kernel_share=c["bound_ms"] / kernel_ms, cudnn_share=c["bound_ms"] / cudnn_ms,
               kernel_err=kernel_err, cudnn_err=cudnn_err, card=card_line())
    print(json.dumps(rec), flush=True)
    del conv, norm, x, res, ref, out, base
    torch.cuda.empty_cache()
    return rec


def run(config: str, device, reps: int) -> List[dict]:
    cfg = get_config(config)
    sites = conv_sites(cfg)
    shapes = collections.OrderedDict()
    for site in sites:
        shapes.setdefault(shape_key(site), []).append(site)
    recs = [measure(group[0], len(group), device, reps) for group in shapes.values()]
    total = {k: sum(r[k] * r["calls"] for r in recs) for k in ("kernel_ms", "cudnn_ms", "flop",
                                                                "bound_ms")}
    slower = [r["case"] for r in recs if r["engaged"] and r["kernel_ms"] >= r["cudnn_ms"]]
    print(json.dumps(dict(tool="bench_conv", case=f"{config}.frame", sites=len(sites),
                          shapes=len(recs), engaged=sum(r["calls"] for r in recs if r["engaged"]),
                          **total, kernel_tflops=total["flop"] / total["kernel_ms"] / 1e9,
                          cudnn_tflops=total["flop"] / total["cudnn_ms"] / 1e9,
                          slower_than_cudnn=slower, card=card_line())), flush=True)
    return recs


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    for config in args.configs:
        run(config, device, args.reps)


if __name__ == "__main__":
    main()
