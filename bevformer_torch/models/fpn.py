"""FPN neck (mmdet semantics): lateral 1x1 convs, nearest top-down
upsampling, 3x3 output convs, and stride-2 extra convs on the last output
(`add_extra_convs='on_output'`, a ReLU before every extra conv after the
first). Port of `bevformer_tpu/models/fpn.py` (`bevformer_base.py:61-70`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvModule(nn.Module):
    """mmcv ConvModule without norm or activation: the reference keys are
    `<name>.conv.weight` / `<name>.conv.bias`."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(
        self,
        in_channels: Tuple[int, ...],
        out_channels: int = 256,
        num_outs: int = 4,
    ):
        super().__init__()
        used = len(in_channels)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1) for c in in_channels
        )
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1)
            for _ in range(used)
        )
        for _ in range(used, num_outs):
            self.fpn_convs.append(
                ConvModule(out_channels, out_channels, 3, stride=2, padding=1)
            )

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        used = len(self.lateral_convs)
        assert len(inputs) == used
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(used - 1, 0, -1):
            # 'nearest-exact' is the half-pixel nearest rule of
            # jax.image.resize; both give i // 2 at the factor-2 sizes
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[-2:], mode="nearest-exact"
            )
        outs = [self.fpn_convs[i](laterals[i]) for i in range(used)]
        src = outs[-1]
        for i in range(used, len(self.fpn_convs)):
            if i > used:
                src = F.relu(src)
            src = self.fpn_convs[i](src)
            outs.append(src)
        return outs
