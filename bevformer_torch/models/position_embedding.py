"""Relative position embedding over a feature grid.

Port of `bevformer_tpu/models/position_embedding.py` (reference
`models/utils/position_embedding.py:5-33`): per grid cell, (cos, sin) of the
row and of the column angle (index / (size - 1) times pi), a bias-free
linear lift to `num_pos_feats` channels, then an optional LayerNorm.
Registered but unused by every shipped BEVFormer config; provided for
parity. Parameter names are the JAX module's (`fc`, `norm`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from bevformer_torch.models.layers import layer_norm


class RelPositionEmbedding(nn.Module):
    """`forward(h, w)` -> [h * w, num_pos_feats], row-major over the grid
    (the reference takes a [B, C, H, W] tensor and uses only H and W)."""

    def __init__(self, num_pos_feats: int = 64, pos_norm: bool = True):
        super().__init__()
        self.fc = nn.Linear(4, num_pos_feats, bias=False)
        self.norm = layer_norm(num_pos_feats) if pos_norm else None

    def forward(self, h: int, w: int) -> torch.Tensor:
        dev = self.fc.weight.device
        y = torch.arange(h, dtype=torch.float32, device=dev) / max(float(h - 1), 1.0)
        x = torch.arange(w, dtype=torch.float32, device=dev) / max(float(w - 1), 1.0)
        y_axis = torch.stack([torch.cos(y * math.pi), torch.sin(y * math.pi)], 1)  # [h, 2]
        x_axis = torch.stack([torch.cos(x * math.pi), torch.sin(x * math.pi)], 1)  # [w, 2]
        pos = torch.cat([y_axis[:, None, :].expand(h, w, 2),
                         x_axis[None, :, :].expand(h, w, 2)], -1).reshape(h * w, 4)
        pos = self.fc(pos)
        return self.norm(pos) if self.norm is not None else pos
