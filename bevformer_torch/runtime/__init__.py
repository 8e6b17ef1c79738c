from bevformer_torch.runtime.checkpoint import (
    build_model,
    init_state_dict,
    load_reference_pth,
    restore_checkpoint,
    save_checkpoint,
    state_dict_from_jax,
    state_dict_from_jax_v2,
)
from bevformer_torch.runtime.eval import VideoEvaluator, VideoEvaluatorV2
from bevformer_torch.runtime.fuse import fuse_conv_bn
from bevformer_torch.runtime.optim import label_params, make_optimizer
from bevformer_torch.runtime.train import (
    Batch,
    Trainer,
    collate,
    history_bev,
    loss_fn,
    train_step,
)
from bevformer_torch.runtime.train_v2 import BatchV2, collate_v2, history_bevs, loss_fn_v2

__all__ = [
    "Batch", "BatchV2", "Trainer", "VideoEvaluator", "VideoEvaluatorV2", "build_model", "collate",
    "collate_v2", "history_bevs", "loss_fn_v2",
    "fuse_conv_bn", "history_bev",
    "init_state_dict", "label_params", "load_reference_pth", "loss_fn", "make_optimizer",
    "restore_checkpoint", "save_checkpoint", "state_dict_from_jax", "state_dict_from_jax_v2",
    "train_step",
]
