from bevformer_torch.runtime.checkpoint import (
    build_model,
    init_state_dict,
    state_dict_from_jax,
)
from bevformer_torch.runtime.eval import VideoEvaluator

__all__ = ["VideoEvaluator", "build_model", "init_state_dict", "state_dict_from_jax"]
