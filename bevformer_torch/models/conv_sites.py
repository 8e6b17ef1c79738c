"""Every dense conv of a detector's backbone and neck (each
`resnet.conv_norm` call) as one pass over the cameras' images runs it, and
whether the card gives it the kernel.

The detector is built on the meta device and its backbone and neck run
once over meta images under the path's modes, with `resnet.record_calls`
keeping each call: nothing is allocated or computed. The DCN
(`ModulatedDeformConv`, no `conv_norm` call) gives only its output's
shape there. `engaged` is `kernels.conv.engage_rule` on the call's own
`rule_inputs`, with the device read as the card and autocast as
`cfg.dtype` runs the model.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from bevformer_torch.kernels.conv import engage_rule, out_size
from bevformer_torch.models import resnet
from bevformer_torch.models.detector import BEVFormer
from bevformer_torch.models.detector_v2 import BEVFormerV2
from bevformer_torch.runtime.optim import FROZEN, label_params


def _dcn_shape(dcn: resnet.ModulatedDeformConv, x: torch.Tensor) -> torch.Tensor:
    """A meta tensor of the DCN's output shape, recording a gradient where
    x or the DCN's weight does."""
    om = dcn.conv_offset(x)  # [b, 27, oh, ow]
    return (om[:, :1] * dcn.weight.sum()).expand(-1, dcn.weight.shape[0], -1, -1)


def _norm_kind(norm) -> Optional[str]:
    return next((kind for kind, cls in resnet.NORMS.items() if isinstance(norm, cls)), None)


def conv_sites(cfg, batch: Optional[int] = None, size: Optional[Tuple[int, int]] = None,
               train: bool = False) -> List[dict]:
    """Each `conv_norm` call of `cfg`'s backbone and neck over `batch`
    images (default the cameras) of `size` (default the network input),
    in the order the pass makes them: the conv's name in the detector, Cin,
    Cout, kernel, stride, padding, the input [b, h, w] and output [oh, ow],
    the norm ("frozen", "bn" or None), the ReLU, the residual, and
    `engaged`. A frame, or a training step's history frame: eval mode, no
    gradient. With `train`, a training step's trained frame: train mode,
    a gradient recorded, the parameters `runtime.optim` freezes frozen."""
    h, w = size or cfg.data.img_size
    b = batch or cfg.data.num_cams
    with torch.device("meta"):
        model = (BEVFormerV2 if cfg.version == "v2" else BEVFormer)(cfg)
    labels = label_params(model, cfg.optim.frozen_stages)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != FROZEN)
    model.train(train)
    for m in model.modules():
        if isinstance(m, resnet.ModulatedDeformConv):
            m.forward = functools.partial(_dcn_shape, m)
    names = {m: n for n, m in model.named_modules()}
    x = torch.empty(b, 3, h, w, device="meta")
    with resnet.record_calls() as calls, torch.set_grad_enabled(train):
        model.img_neck(model.img_backbone(x))
    sites = []
    for call in calls:
        conv = call["conv"]
        (kh, kw), s, p = conv.kernel_size, conv.stride[0], conv.padding[0]
        _, _, ih, iw = call["shape"]
        card = dict(call["inputs"], device_type="cuda", autocast=cfg.dtype != "float32")
        sites.append(dict(name=names[conv], cin=conv.in_channels, cout=conv.out_channels, k=kh,
                          stride=s, pad=p, b=b, h=ih, w=iw, oh=out_size(ih, kh, s, p),
                          ow=out_size(iw, kw, s, p), norm=_norm_kind(call["norm"]),
                          relu=call["relu"], residual=call["residual"],
                          engaged=engage_rule(**card)))
    return sites
