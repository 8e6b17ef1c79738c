from bevformer_torch.core import boxes, coder, geometry

__all__ = ["boxes", "coder", "geometry"]
