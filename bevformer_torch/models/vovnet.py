"""VoVNet V2-99 backbone (NCHW).

Port of `bevformer_tpu/models/vovnet.py` (reference
`models/backbones/vovnet.py:269`, the backbone of the reference's test-set
submissions with DD3D-pretrained weights): One-Shot Aggregation blocks with
effective squeeze-excitation and identity residuals, a stem of 3 convs, and
stages of [1, 3, 9, 3] blocks. Submodules carry the JAX module names
(`stem1`, `stage2_block0.layer0.conv`, `.concat`, `.ese.fc`, ...), which the
weight bridge (`runtime.checkpoint.vovnet_state_dict`) maps one to one; the
norm is the port's `resnet.make_norm` ("frozen" or "bn").

On the card its convolutions run outside cuDNN, forward and backward
(`NativeConv2d`): cuDNN's fp32 algorithms for the 3x3 convs of 160 and 192
channels ran at 0.24-2.2 TFLOP/s with a 42.6 GiB workspace, and PyTorch's
own convolution (im2col and a cuBLAS product) took a 6 x 640 x 1600
forward from 3961 ms to 157 ms, its peak from 42.6 to 3.7 GiB
(`tools/bench_vovnet.py` on an H100; PERF.md).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bevformer_torch.models.resnet import make_norm

# V2-99: stem 64/64/128; per stage (stage_ch, concat_ch), 5 layers a block
V2_99 = dict(
    stem=(64, 64, 128),
    stage_ch=(128, 160, 192, 224),
    concat_ch=(256, 512, 768, 1024),
    layer_per_block=5,
    block_per_stage=(1, 3, 9, 3),
)


class _NativeConv(torch.autograd.Function):
    """conv2d whose forward and backward both run with cuDNN off. Autograd's
    own conv backward picks its backend from the global flags when the
    backward runs, not from those of its forward."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv):
        ctx.save_for_backward(x, weight)
        ctx.conv, ctx.has_bias = conv, bias is not None
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv2d(x, weight, bias, conv.stride, conv.padding, conv.dilation,
                            conv.groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        conv = ctx.conv
        need = ctx.needs_input_grad
        with torch.backends.cudnn.flags(enabled=False):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if ctx.has_bias else None,
                list(conv.stride), list(conv.padding), list(conv.dilation), False, [0, 0],
                conv.groups, [need[0], need[1], ctx.has_bias and need[2]])
        return gx, gw, gb, None


class NativeConv2d(nn.Conv2d):
    """`nn.Conv2d` (the same parameters and state-dict keys) computed outside
    cuDNN, forward and backward (`_NativeConv`); see the module's docstring."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _NativeConv.apply(x, self.weight, self.bias, self)


class ConvNorm(nn.Module):
    """Bias-free conv ("same" padding), norm, ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 norm: str = "frozen"):
        super().__init__()
        self.conv = NativeConv2d(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.bn = make_norm(norm, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class ESE(nn.Module):
    """Effective squeeze-excitation: global average pool, a 1x1 conv, and
    the hard-sigmoid gate clip(g + 3, 0, 6) / 6."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = NativeConv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * F.hardsigmoid(self.fc(x.mean(dim=(2, 3), keepdim=True)))


class OSABlock(nn.Module):
    """`layer_per_block` 3x3 ConvNorms in a chain, their outputs and the
    input concatenated, a 1x1 ConvNorm to `concat_ch`, the eSE gate, and
    with `identity` the input added."""

    def __init__(self, cin: int, stage_ch: int, concat_ch: int, layer_per_block: int,
                 identity: bool = False, norm: str = "frozen"):
        super().__init__()
        self.identity = identity
        self.num_layers = layer_per_block
        ch = cin
        for i in range(layer_per_block):
            self.add_module(f"layer{i}", ConvNorm(ch, stage_ch, 3, norm=norm))
            ch = stage_ch
        self.concat = ConvNorm(cin + layer_per_block * stage_ch, concat_ch, 1, norm=norm)
        self.ese = ESE(concat_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outputs, h = [x], x
        for i in range(self.num_layers):
            h = getattr(self, f"layer{i}")(h)
            outputs.append(h)
        h = self.ese(self.concat(torch.cat(outputs, dim=1)))
        return h + x if self.identity else h


class VoVNet(nn.Module):
    """V2-99; returns the stages in `out_indices` (0: stage 2, strides 4,
    8, 16, 32 for stages 2-5), each NCHW."""

    def __init__(self, out_indices: Tuple[int, ...] = (1, 2, 3), norm: str = "frozen"):
        super().__init__()
        cfg = V2_99
        self.out_indices = tuple(out_indices)
        s1, s2, s3 = cfg["stem"]
        self.stem1 = ConvNorm(3, s1, 3, 2, norm)
        self.stem2 = ConvNorm(s1, s2, 3, 1, norm)
        self.stem3 = ConvNorm(s2, s3, 3, 2, norm)
        self.blocks: List[List[str]] = []
        ch = s3
        for stage in range(4):
            names = []
            for blk in range(cfg["block_per_stage"][stage]):
                name = f"stage{stage + 2}_block{blk}"
                self.add_module(name, OSABlock(
                    ch, cfg["stage_ch"][stage], cfg["concat_ch"][stage],
                    cfg["layer_per_block"], identity=blk > 0, norm=norm))
                ch = cfg["concat_ch"][stage]
                names.append(name)
            self.blocks.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem3(self.stem2(self.stem1(x)))
        outs = []
        for stage, names in enumerate(self.blocks):
            if stage > 0:
                # pads with -inf, as flax's max_pool
                x = F.max_pool2d(x, 3, 2, 1)
            for name in names:
                x = getattr(self, name)(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs
