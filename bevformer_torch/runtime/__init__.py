from bevformer_torch.runtime.checkpoint import (
    build_model,
    init_state_dict,
    state_dict_from_jax,
)
from bevformer_torch.runtime.eval import VideoEvaluator
from bevformer_torch.runtime.optim import label_params, make_optimizer
from bevformer_torch.runtime.train import Batch, Trainer, history_bev, loss_fn, train_step

__all__ = [
    "Batch", "Trainer", "VideoEvaluator", "build_model", "history_bev",
    "init_state_dict", "label_params", "loss_fn", "make_optimizer",
    "state_dict_from_jax", "train_step",
]
