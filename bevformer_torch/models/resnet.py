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

Each dense conv runs with the norm after it, and where there is one the
residual add and the ReLU, through `conv_norm`: on the kernel
`kernels.conv.conv2d_nhwc` (span `conv`) where `kernels.conv.engage_rule`
allows it, as before (cuDNN, then the norm, the add and the ReLU; span
`conv_fallback`) elsewhere: on the CPU, under autocast, where a gradient is
recorded, with a BatchNorm in train mode, or at a Cin not a multiple of 32
(the stem) or a Cout not a multiple of 64. The DCN layer is not one of
them.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bevformer_torch.kernels.conv import cached, conv2d_nhwc, engage_rule, out_size
from bevformer_torch.kernels.dcn import dcn_conv
from bevformer_torch.models.layers import SyncBatchNorm2d, remat
from bevformer_torch.utils.profiler import span

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


def _norm_affine(conv: nn.Conv2d, norm: Optional[nn.Module]):
    """(scale, shift) [Cout] of `norm(conv(x))` as conv(x) without its bias
    times scale plus shift: a FrozenBN's or an eval-mode BatchNorm's
    running statistics, or none (the identity a folded model leaves), and
    the conv's bias."""
    bias = conv.bias
    if norm is None or isinstance(norm, nn.Identity):
        scale = torch.ones(conv.out_channels, device=conv.weight.device)
        shift = torch.zeros_like(scale) if bias is None else bias.detach().clone()
        return scale, shift
    weight = 1.0 if norm.weight is None else norm.weight.detach()
    scale = weight * torch.rsqrt(norm.running_var + norm.eps)
    shift = (0 if norm.bias is None else norm.bias.detach()) - norm.running_mean * scale
    if bias is not None:
        shift = shift + bias.detach() * scale
    return scale.float().contiguous(), shift.float().contiguous()


def _norm_tensors(conv: nn.Conv2d, norm: Optional[nn.Module]):
    tensors = [conv.bias]
    if norm is not None and not isinstance(norm, nn.Identity):
        tensors += [norm.weight, norm.bias, norm.running_mean, norm.running_var]
    return tensors


def rule_inputs(x: torch.Tensor, conv: nn.Conv2d, norm: Optional[nn.Module] = None,
                residual: Optional[torch.Tensor] = None) -> dict:
    """`kernels.conv.engage_rule`'s arguments for `conv` on x, then `norm`
    (a FrozenBN, a BatchNorm, nn.Identity or None), then the residual."""
    grads = [x, conv.weight, conv.bias, residual]
    norm_training = False
    if isinstance(norm, nn.BatchNorm2d):
        grads += [norm.weight, norm.bias]
        norm_training = norm.training or norm.running_mean is None
    plain = (conv.groups == 1 and conv.dilation == (1, 1) and conv.padding_mode == "zeros"
             and isinstance(conv.padding, tuple) and conv.padding[0] == conv.padding[1]
             and conv.stride[0] == conv.stride[1] and conv.weight.dtype == torch.float32)
    elements = x.numel()
    if plain:
        (b, _, h, w), (kh, kw), s, p = x.shape, conv.kernel_size, conv.stride[0], conv.padding[0]
        elements = max(elements, b * conv.out_channels * out_size(h, kh, s, p)
                       * out_size(w, kw, s, p))
    return dict(
        device_type=x.device.type, dtype=x.dtype,
        autocast=x.device.type != "meta" and torch.is_autocast_enabled(x.device.type),
        records_grad=torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in grads),
        norm_training=norm_training, cin=conv.in_channels, cout=conv.out_channels,
        plain=plain, elements=elements)


_CALLS: Optional[list] = None  # conv_norm's calls while `record_calls` keeps them


@contextmanager
def record_calls():
    """Keep each `conv_norm` call made inside in the list this yields: its
    conv and norm, x's shape, the ReLU, whether a residual is added, and
    its `rule_inputs`."""
    global _CALLS
    saved, _CALLS = _CALLS, []
    try:
        yield _CALLS
    finally:
        _CALLS = saved


def conv_norm(x: torch.Tensor, conv: nn.Conv2d, norm: Optional[nn.Module] = None,
              relu: bool = False, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(norm(conv(x)) + residual), each part where given, on NCHW
    tensors: on the kernel where `engage_rule` allows it (its output
    channels-last in memory), else as the modules compute it."""
    inputs = rule_inputs(x, conv, norm, residual)
    if _CALLS is not None:
        _CALLS.append(dict(conv=conv, norm=norm, shape=tuple(x.shape), relu=relu,
                           residual=residual is not None, inputs=inputs))
    if not engage_rule(**inputs):
        with span("conv_fallback"):
            out = conv(x)
            if norm is not None:
                out = norm(out)
            if residual is not None:
                out = out + residual
            return F.relu(out) if relu else out
    with span("conv"):
        weight = conv.weight
        scale, shift = cached(weight, "affine", _norm_tensors(conv, norm),
                              lambda: _norm_affine(conv, norm))
        res = None if residual is None else residual.permute(0, 2, 3, 1).contiguous()
        out = conv2d_nhwc(x.permute(0, 2, 3, 1).contiguous(), weight, conv.stride[0],
                          conv.padding[0], scale, shift, res, relu)
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
        out = conv_norm(x, self.conv1, self.bn1, relu=True)
        if isinstance(self.conv2, ModulatedDeformConv):
            out = F.relu(self.bn2(self.conv2(out)))
        else:
            out = conv_norm(out, self.conv2, self.bn2, relu=True)
        if self.downsample is None:
            identity = x
        else:
            identity = conv_norm(x, self.downsample[0], self.downsample[1])
        return conv_norm(out, self.conv3, self.bn3, relu=True, residual=identity)


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
        out = conv_norm(x, self.conv1, self.bn1, relu=True)
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
