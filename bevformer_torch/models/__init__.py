from bevformer_torch.models.detector import BEVFormer

__all__ = ["BEVFormer"]
