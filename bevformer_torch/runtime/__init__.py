"""The port's runtime: checkpoints, evaluation, training, the process group.

Its names load on first use (PEP 562), so that model code can import
`runtime.distributed` and `runtime.parallel` (the mesh over the ranks)
without first loading the runtime's modules that import the models.
"""

import importlib

_HOMES = {
    "build_model": "checkpoint", "init_state_dict": "checkpoint",
    "load_reference_pth": "checkpoint", "restore_checkpoint": "checkpoint",
    "save_checkpoint": "checkpoint", "state_dict_from_jax": "checkpoint",
    "state_dict_from_jax_v2": "checkpoint",
    "VideoEvaluator": "eval", "VideoEvaluatorV2": "eval",
    "fuse_conv_bn": "fuse",
    "label_params": "optim", "make_optimizer": "optim",
    "Batch": "train", "Trainer": "train", "collate": "train", "history_bev": "train",
    "loss_fn": "train", "train_step": "train",
    "BatchV2": "train_v2", "collate_v2": "train_v2", "history_bevs": "train_v2",
    "loss_fn_v2": "train_v2",
}

__all__ = sorted(_HOMES)


def __getattr__(name):
    if name not in _HOMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_HOMES[name]}"), name)
    globals()[name] = value
    return value
