"""Fold each BatchNorm that follows a conv into the conv, for inference
(port of `bevformer_tpu/runtime/fuse.py`, the reference's
`tools/misc/fuse_conv_bn.py`): the v1 backbone's FrozenBNs, V2's
`nn.BatchNorm2d`s (the backbone's and `ResNetFusion`'s) with their running
statistics, which must be in eval mode, and VoVNet's `ConvNorm`s.

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

`folded_state_dict` writes the same folding into the reference layout, as
JAX's `fuse_conv_bn` writes its variables: each conv's weight times mul,
and its BN an identity that adds (weight 1, bias add, running mean 0,
running variance 1 - eps), so that the folded weights load into the
unfolded model and give its outputs up to fp32 rounding.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from bevformer_torch.models.resnet import FrozenBN, ModulatedDeformConv

# (conv, BN) child names: the stem and each block's convs (`ResNet`,
# `Bottleneck`, `ResNetFusion`'s `BasicBlock`), a block's downsample
# (`nn.Sequential`) and VoVNet's `ConvNorm`
PAIRS = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"), ("0", "1"), ("conv", "bn"))


class ChannelAdd(nn.Module):
    """x + bias per channel of an NCHW tensor, in x's dtype (as FrozenBN):
    what is left of a FrozenBN after its multiply folded into the DCN
    weight before it."""

    def __init__(self, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias.to(x.dtype)[:, None, None]


def _pairs(model: nn.Module):
    """(prefix, parent, conv name, BN name) of every (conv, BN) pair of
    `PAIRS` in `model`: a FrozenBN or BatchNorm2d after a conv or DCN. A
    BatchNorm2d in train mode (batch statistics) raises."""
    for prefix, parent in list(model.named_modules()):
        for conv_name, bn_name in PAIRS:
            conv = getattr(parent, conv_name, None)
            bn = getattr(parent, bn_name, None)
            if isinstance(bn, (FrozenBN, nn.BatchNorm2d)) and isinstance(
                    conv, (nn.Conv2d, ModulatedDeformConv)):
                if bn.training and isinstance(bn, nn.BatchNorm2d):
                    raise ValueError("folding takes the running statistics: put the model "
                                     "in eval mode first")
                yield prefix, parent, conv_name, bn_name


def _mul_add(bn: nn.Module):
    """The BN in eval mode as x * mul + add per channel."""
    mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return mul, bn.bias - bn.running_mean * mul


@torch.no_grad()
def _fold(conv: nn.Module, bn: nn.Module) -> nn.Module:
    """Fold `bn` into `conv` in place; returns what replaces `bn`."""
    mul, add = _mul_add(bn)
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
    for _, parent, conv_name, bn_name in _pairs(model):
        setattr(parent, bn_name, _fold(getattr(parent, conv_name), getattr(parent, bn_name)))
    if hasattr(model, "fcos3d_bbox_head"):
        del model.fcos3d_bbox_head
    return model


@torch.no_grad()
def folded_state_dict(model: nn.Module) -> dict:
    """`model`'s state dict (on the CPU) with every (conv, BN) pair of
    `PAIRS` folded in the reference layout: the conv's weight (a DCN's too)
    times the BN's mul, its bias (where it has one) zero, and the BN the
    identity plus the folded add. A BatchNorm2d in train mode raises."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for prefix, parent, conv_name, bn_name in _pairs(model):
        c, b = (f"{prefix}.{n}" if prefix else n for n in (conv_name, bn_name))
        bn = getattr(parent, bn_name)
        mul, add = (t.cpu() for t in _mul_add(bn))
        sd[f"{c}.weight"] = sd[f"{c}.weight"] * mul[:, None, None, None]
        if f"{c}.bias" in sd:
            add = add + sd[f"{c}.bias"] * mul
            sd[f"{c}.bias"] = torch.zeros_like(sd[f"{c}.bias"])
        sd[f"{b}.weight"] = torch.ones_like(mul)
        sd[f"{b}.bias"] = add
        sd[f"{b}.running_mean"] = torch.zeros_like(mul)
        sd[f"{b}.running_var"] = torch.full_like(mul, 1.0 - bn.eps)
    return sd
