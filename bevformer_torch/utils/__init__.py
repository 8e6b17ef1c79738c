from bevformer_torch.utils.profiler import run_time, trace
from bevformer_torch.utils.visual import save_tensor

__all__ = ["run_time", "save_tensor", "trace"]
