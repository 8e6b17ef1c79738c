from bevformer_torch.core import assigner, boxes, coder, geometry, losses

__all__ = ["assigner", "boxes", "coder", "geometry", "losses"]
