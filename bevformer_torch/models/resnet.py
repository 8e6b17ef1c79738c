"""ResNet backbone, caffe or pytorch style, with frozen BatchNorm (v1) or
BatchNorm with running statistics (V2), and DCNv2 (NCHW tensors; the
detector feeds them in channels-last memory order, which the DCN kernel
reads without a copy).

Port of `bevformer_tpu/models/resnet.py` (mmdet ResNet with
`norm_eval=True`, `bevformer_base.py:45-60`, `bevformer_tiny.py:41-51`; V2's
trainable SyncBN, `bevformerv2-r50-t1-24ep.py:164-180`, is
`layers.SyncBatchNorm2d` here: nn.BatchNorm2d, with running statistics in
eval mode, whose batch statistics span every rank in train mode).
Submodules carry the reference `.pth` names (`conv1`, `bn1`,
`layer{i}.{j}.conv2.conv_offset`, ...), the same in both styles and with
both norms. With `use_remat`, every block after the first of each stage is
recomputed in backward (`layers.remat`), as JAX's `nn.remat` of its
scanned blocks (`resnet.py:440-452`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bevformer_torch.kernels.dcn import dcn_conv
from bevformer_torch.models.layers import SyncBatchNorm2d, remat

ARCH_SETTINGS = {
    10: (1, 1, 1, 1),  # toy depth for tests
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


class FrozenBN(nn.Module):
    """BatchNorm with statistics and affine parameters frozen (buffers). The
    folded multiply and add are cast to the input's dtype, as the JAX
    package's are, so a bf16 conv output stays bf16 (fp32 buffers would
    promote it back to fp32)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        add = self.bias - self.running_mean * mul
        return x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None]


class ModulatedDeformConv(nn.Module):
    """DCNv2 3x3: a regular 3x3 conv predicts 18 offsets ((y, x) per tap) and
    9 mask logits; the sampling and the contraction with `weight` run in
    `kernels.dcn.dcn_conv`.

    Under bf16 autocast (the JAX package's bf16 mode, `resnet.py:113-128`)
    the offset conv runs in bf16 and its output is widened to fp32 before
    the split and the sigmoid; x goes in as bf16 and the output is bf16.
    The weight goes in as the fp32 parameter in its [9C, Cout] layout:
    `dcn_conv` rounds it to bf16 once for the product (the kernel's prep
    pass, or the plain version), so its gradient comes back fp32."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        nn.init.kaiming_normal_(self.weight)
        self.conv_offset = nn.Conv2d(in_channels, 27, 3, stride, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [b, c, h, w]
        om = self.conv_offset(x).float().permute(0, 2, 3, 1)  # [b, oh, ow, 27]
        off_y = om[..., 0:18:2].contiguous()
        off_x = om[..., 1:18:2].contiguous()
        mask = om[..., 18:].sigmoid().contiguous()
        c = self.weight.shape[1]
        # [cout, c, 3, 3] -> [9c, cout], rows (ky, kx, c)
        w = self.weight.permute(2, 3, 1, 0).reshape(9 * c, -1).contiguous()
        x_nhwc = x.permute(0, 2, 3, 1).contiguous()
        if torch.is_autocast_enabled(x.device.type):
            x_nhwc = x_nhwc.to(torch.get_autocast_dtype(x.device.type))
        out = dcn_conv(x_nhwc, off_y, off_x, mask, w, self.stride)
        return out.permute(0, 3, 1, 2)


def _conv(cin, cout, k, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


NORMS = {"frozen": FrozenBN, "bn": SyncBatchNorm2d}  # eps 1e-5 both


def make_norm(norm: str, features: int) -> nn.Module:
    """The backbone's norm layer: "frozen" (v1) or "bn" (V2)."""
    if norm not in NORMS:
        raise ValueError(f"backbone norm {norm!r}: one of {sorted(NORMS)}")
    return NORMS[norm](features)


class Bottleneck(nn.Module):
    """Caffe style: the stride sits in the 1x1 conv1, so conv2 (and every
    DCN) has stride 1. Pytorch style: it sits in the 3x3 conv2."""

    def __init__(
        self, inplanes: int, planes: int, stride: int = 1,
        downsample: bool = False, use_dcn: bool = False, style: str = "caffe",
        norm: str = "frozen",
    ):
        super().__init__()
        if style not in ("caffe", "pytorch"):
            raise ValueError(f"backbone style {style!r}: 'caffe' or 'pytorch'")
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = _conv(inplanes, planes, 1, s1)
        self.bn1 = make_norm(norm, planes)
        if use_dcn:
            self.conv2 = ModulatedDeformConv(planes, planes, s2)
        else:
            self.conv2 = _conv(planes, planes, 3, s2, padding=1)
        self.bn2 = make_norm(norm, planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = make_norm(norm, planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                _conv(inplanes, planes * 4, 1, stride), make_norm(norm, planes * 4)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-10/50/101; returns the stages in `out_indices` (0 -> C2 ..
    3 -> C5)."""

    def __init__(
        self,
        depth: int = 50,
        out_indices: Tuple[int, ...] = (3,),
        dcn_stages: Tuple[int, ...] = (),
        style: str = "caffe",
        norm: str = "frozen",
        use_remat: bool = False,
    ):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.use_remat = use_remat
        self.conv1 = _conv(3, 64, 7, 2, padding=3)
        self.bn1 = make_norm(norm, 64)
        inplanes, planes = 64, 64
        for stage, num_blocks in enumerate(ARCH_SETTINGS[depth]):
            stride = 1 if stage == 0 else 2
            use_dcn = stage in dcn_stages
            blocks = [Bottleneck(inplanes, planes, stride, True, use_dcn, style, norm)]
            blocks += [
                Bottleneck(planes * 4, planes, 1, False, use_dcn, style, norm)
                for _ in range(num_blocks - 1)
            ]
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            inplanes, planes = planes * 4, planes * 2
        self.num_stages = len(ARCH_SETTINGS[depth])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.max_pool2d(out, 3, stride=2, padding=1)
        outputs = []
        recompute = self.use_remat and torch.is_grad_enabled()
        for stage in range(self.num_stages):
            layer = getattr(self, f"layer{stage + 1}")
            if recompute:
                for i, block in enumerate(layer):
                    out = remat(block, out) if i > 0 else block(out)
            else:
                out = layer(out)
            if stage in self.out_indices:
                outputs.append(out)
        return outputs
