from bevformer_torch.models.detector import BEVFormer
from bevformer_torch.models.detector_v2 import BEVFormerV2

__all__ = ["BEVFormer", "BEVFormerV2"]
