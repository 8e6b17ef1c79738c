"""The system under test: `bevformer_torch`, built from a configuration
file and the benchmark's weights, and driven only through its public
entries (`VideoEvaluator.step`, `VideoEvaluatorV2.step`, `Trainer.step`).

This module and the drivers are the only parts of the benchmark that import
the program; the reference, the traffic, the weights and the yardstick do
not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def port_config(d: Dict):
    """The port's `BEVFormerConfig` holding every field of the file (its
    `about` says where it comes from)."""
    from bevformer_torch.configs.config import BEVFormerConfig, DataConfig, OptimConfig

    def build(cls, fields):
        known = {f.name: f for f in dataclasses.fields(cls)}
        unknown = set(fields) - set(known)
        if unknown:
            raise KeyError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})

    top = {k: v for k, v in d.items() if k not in ("about", "data", "optim")}
    return dataclasses.replace(build(BEVFormerConfig, top), data=build(DataConfig, d["data"]),
                               optim=build(OptimConfig, d["optim"]))


def build_model(cfg, weights: Dict[str, torch.Tensor], device):
    """The port's detector on `device` holding `weights`. Only a V2 DD3D
    head, which inference does not run, may lack weights; its parameters
    are zeroed."""
    from bevformer_torch.models import BEVFormer, BEVFormerV2

    with torch.device("meta"):
        model = (BEVFormerV2 if cfg.version == "v2" else BEVFormer)(cfg)
    model.to_empty(device=device)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    stray = [k for k in missing if not k.startswith("fcos3d_bbox_head.")]
    if stray or unexpected:
        raise RuntimeError(f"weights do not fit the port: missing {stray[:5]}, "
                           f"unexpected {unexpected[:5]}")
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if name in missing:
                t.zero_()
    return model


def video_evaluator(cfg, model):
    from bevformer_torch.runtime.eval import VideoEvaluator, VideoEvaluatorV2

    return (VideoEvaluatorV2 if cfg.version == "v2" else VideoEvaluator)(model)


def trainer(model, total_steps: int, seed: int):
    from bevformer_torch.runtime.train import Trainer

    return Trainer(model, total_steps, seed=seed)


def train_batch(**tensors):
    from bevformer_torch.runtime.train import Batch

    return Batch(**tensors)
