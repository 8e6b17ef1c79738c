"""Fold each frozen BatchNorm of the backbone into the conv before it, for
inference (port of `bevformer_tpu/runtime/fuse.py`, the reference's
`tools/misc/fuse_conv_bn.py`).

A FrozenBN computes x * mul + add per channel, with
mul = weight / sqrt(running_var + eps) and add = bias - running_mean * mul.
After a plain conv both fold into it: the conv's weight times mul, and add
as its bias; the BN goes. After a DCN conv2 the multiply folds into the DCN
weight (its output channels), and the add stays behind as a per-channel
`ChannelAdd`: K2 computes the DCN as it always does. The folded model gives
the unfolded one's outputs up to fp32 rounding. It is for inference only:
the folded model no longer has the reference's state-dict keys.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from bevformer_torch.models.resnet import FrozenBN, ModulatedDeformConv

# (conv, BN) child names: the stem and each block's three convs
# (`ResNet`, `Bottleneck`) and a block's downsample (`nn.Sequential`)
PAIRS = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"), ("0", "1"))


class ChannelAdd(nn.Module):
    """x + bias per channel of an NCHW tensor: what is left of a FrozenBN
    after its multiply folded into the DCN weight before it."""

    def __init__(self, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias[:, None, None]


@torch.no_grad()
def _fold(conv: nn.Module, bn: FrozenBN) -> nn.Module:
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
    """Fold every FrozenBN that follows a conv (`PAIRS`) into it, in place;
    returns the model."""
    for parent in list(model.modules()):
        for conv_name, bn_name in PAIRS:
            conv = getattr(parent, conv_name, None)
            bn = getattr(parent, bn_name, None)
            if isinstance(bn, FrozenBN) and isinstance(conv, (nn.Conv2d, ModulatedDeformConv)):
                setattr(parent, bn_name, _fold(conv, bn))
    return model
