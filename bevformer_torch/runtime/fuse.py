"""Fold each BatchNorm that follows a conv into the conv, for inference
(port of `bevformer_tpu/runtime/fuse.py`, the reference's
`tools/misc/fuse_conv_bn.py`): the v1 backbone's FrozenBNs, and V2's
`nn.BatchNorm2d`s (the backbone's and `ResNetFusion`'s) with their running
statistics, which must be in eval mode.

A BN in eval mode computes x * mul + add per channel, with
mul = weight / sqrt(running_var + eps) and add = bias - running_mean * mul.
After a plain conv both fold into it: the conv's weight times mul, and add
as its bias; the BN goes. After a DCN conv2 the multiply folds into the DCN
weight (its output channels), and the add stays behind as a per-channel
`ChannelAdd`: K2 computes the DCN as it always does. The folded model gives
the unfolded one's outputs up to fp32 rounding. It is for inference only:
the folded model no longer has the reference's state-dict keys, and a V2
model's DD3D head (`fcos3d_bbox_head`, which only training runs; its
per-level BatchNorms share one conv and do not fold) leaves it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from bevformer_torch.models.resnet import FrozenBN, ModulatedDeformConv

# (conv, BN) child names: the stem and each block's convs (`ResNet`,
# `Bottleneck`, `ResNetFusion`'s `BasicBlock`) and a block's downsample
# (`nn.Sequential`)
PAIRS = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"), ("0", "1"))


class ChannelAdd(nn.Module):
    """x + bias per channel of an NCHW tensor, in x's dtype (as FrozenBN):
    what is left of a FrozenBN after its multiply folded into the DCN
    weight before it."""

    def __init__(self, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias.to(x.dtype)[:, None, None]


@torch.no_grad()
def _fold(conv: nn.Module, bn: nn.Module) -> nn.Module:
    """Fold `bn` into `conv` in place; returns what replaces `bn`."""
    mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    add = bn.bias - bn.running_mean * mul
    conv.weight.mul_(mul[:, None, None, None])
    if isinstance(conv, ModulatedDeformConv):
        return ChannelAdd(add)
    if conv.bias is not None:
        add = add + conv.bias * mul
    conv.bias = nn.Parameter(add)
    return nn.Identity()


def fuse_conv_bn(model: nn.Module) -> nn.Module:
    """Fold every FrozenBN or BatchNorm2d that follows a conv (`PAIRS`) into
    it, in place; returns the model. A BatchNorm2d in train mode (batch
    statistics) raises."""
    for parent in list(model.modules()):
        for conv_name, bn_name in PAIRS:
            conv = getattr(parent, conv_name, None)
            bn = getattr(parent, bn_name, None)
            if isinstance(bn, (FrozenBN, nn.BatchNorm2d)) and isinstance(
                    conv, (nn.Conv2d, ModulatedDeformConv)):
                if bn.training and isinstance(bn, nn.BatchNorm2d):
                    raise ValueError("fuse_conv_bn folds running statistics: put the model "
                                     "in eval mode first")
                setattr(parent, bn_name, _fold(conv, bn))
    if hasattr(model, "fcos3d_bbox_head"):
        del model.fcos3d_bbox_head
    return model
