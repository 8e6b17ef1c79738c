from bevformer_torch.runtime.checkpoint import (
    build_model,
    init_state_dict,
    load_reference_pth,
    restore_checkpoint,
    save_checkpoint,
    state_dict_from_jax,
)
from bevformer_torch.runtime.eval import VideoEvaluator
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

__all__ = [
    "Batch", "Trainer", "VideoEvaluator", "build_model", "collate", "fuse_conv_bn", "history_bev",
    "init_state_dict", "label_params", "load_reference_pth", "loss_fn", "make_optimizer",
    "restore_checkpoint", "save_checkpoint", "state_dict_from_jax", "train_step",
]
