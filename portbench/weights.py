"""Seeded weights for both sides, made on the device in two large draws.

The recipe is that of `bevformer_torch/runtime/checkpoint.py::init_state_dict`
at commit 05c7fb4: convolutions He-normal, linears N(0, 1/fan_in),
embeddings N(0, 1), norms near identity with each bottleneck's last scaled
to 0.1-0.3, LayerNorms identity, and the offset layers (`conv_offset`,
`sampling_offsets`) small and nonzero around the deformable-DETR grid, so
the kernels sample off the grid. The keys and shapes come from the
reference model, which carries the program's state-dict names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from portbench.reference import model as ref
from portbench.traffic import generator

WEIGHT_SALT = 7


def grid_init_bias(heads: int, levels: int, points: int) -> np.ndarray:
    """Deformable DETR's sampling-offset bias: per head a direction on the
    unit square's border, point i at (i + 1) times it, flat (h, l, p, 2)."""
    thetas = np.arange(heads, dtype=np.float32) * (2.0 * math.pi / heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, levels, points, 1))
    for i in range(points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


def _recipe(model: nn.Module, c) -> Tuple[List[tuple], List[tuple], Dict[str, np.ndarray]]:
    """(normal draws [(key, std, mean)], uniform draws [(key, lo, hi)],
    constants {key: array}) for every key of the model's state dict."""
    sd = model.state_dict()
    normal, uniform, const = [], [], {}

    def fan_in(k):
        return int(np.prod(sd[k].shape[1:]))

    offsets = {}
    for name, m in model.named_modules():
        if isinstance(m, ref.TemporalSelfAttention):
            offsets[f"{name}.sampling_offsets"] = grid_init_bias(m.h, m.l * m.nq, m.p)
        elif isinstance(m, (ref.MSDeformableAttention3D, ref.CustomMSDeformableAttention)):
            offsets[f"{name}.sampling_offsets"] = grid_init_bias(m.h, m.l, m.p)
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, (ref.FrozenBN, ref.BatchNorm)):
            lo, hi = (0.1, 0.3) if name.endswith("bn3") else (0.8, 1.2)
            uniform += [(pre + "weight", lo, hi), (pre + "bias", -0.1, 0.1),
                        (pre + "running_mean", -0.1, 0.1), (pre + "running_var", 0.8, 1.2)]
            if isinstance(m, ref.BatchNorm):
                const[pre + "num_batches_tracked"] = np.zeros((), np.int64)
        elif isinstance(m, ref.DeformConv):
            normal.append((pre + "weight", math.sqrt(2.0 / fan_in(pre + "weight")), 0.0))
        elif isinstance(m, nn.Conv2d):
            k = pre + "weight"
            if name.endswith("conv_offset"):
                normal += [(k, 0.01 / math.sqrt(fan_in(k)), 0.0), (pre + "bias", 0.5, 0.0)]
            else:
                normal.append((k, math.sqrt(2.0 / fan_in(k)), 0.0))
                if m.bias is not None:
                    normal.append((pre + "bias", 0.02, 0.0))
        elif isinstance(m, nn.LayerNorm):
            const[pre + "weight"] = np.ones(m.normalized_shape, np.float32)
            const[pre + "bias"] = np.zeros(m.normalized_shape, np.float32)
        elif isinstance(m, nn.Embedding):
            normal.append((pre + "weight", 1.0, 0.0))
        elif isinstance(m, ref._Packed):
            k = pre + "in_proj_weight"
            normal += [(k, 1.0 / math.sqrt(sd[k].shape[1]), 0.0), (pre + "in_proj_bias", 0.02, 0.0)]
        elif isinstance(m, nn.Linear):
            k = pre + "weight"
            std = 1.0 / math.sqrt(fan_in(k))
            if name in offsets:
                normal.append((k, 0.5 * std, 0.0))
                const[pre + "bias"] = offsets[name].astype(np.float32)
            else:
                normal += [(k, std, 0.0), (pre + "bias", 0.02, 0.0)]
    tr = "pts_bbox_head.transformer"
    normal += [(f"{tr}.level_embeds", 1.0, 0.0), (f"{tr}.cams_embeds", 1.0, 0.0)]
    prior = -math.log((1.0 - 0.01) / 0.01)
    for lid in range(c.decoder_layers):
        key = f"pts_bbox_head.cls_branches.{lid}.{3 * c.num_reg_fcs}.bias"
        normal = [n for n in normal if n[0] != key]
        const[key] = np.full(sd[key].shape, prior, np.float32)
    return normal, uniform, const


def reference_skeleton(c) -> ref.Detector:
    with torch.device("meta"):
        return ref.Detector(c)


def make(c, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every key of the state dict, on `device`, from `seed`: one normal and
    one uniform draw, sliced and scaled."""
    skeleton = reference_skeleton(c)
    shapes = {k: tuple(v.shape) for k, v in skeleton.state_dict().items()}
    normal, uniform, const = _recipe(skeleton, c)
    gen = generator(seed, WEIGHT_SALT, device)
    sd: Dict[str, torch.Tensor] = {}
    for draws, fill in ((normal, "normal"), (uniform, "uniform")):
        total = sum(math.prod(shapes[k]) for k, _, _ in draws)
        flat = (torch.randn if fill == "normal" else torch.rand)(total, generator=gen,
                                                                   device=device)
        at = 0
        for k, a, b in draws:
            n = math.prod(shapes[k])
            x = flat[at:at + n].view(shapes[k])
            sd[k] = x * a + b if fill == "normal" else x * (b - a) + a
            at += n
    for k, v in const.items():
        sd[k] = torch.as_tensor(v, device=device)
    missing = set(shapes) - set(sd)
    if missing:
        raise RuntimeError(f"no recipe for {sorted(missing)[:5]}")
    return sd
