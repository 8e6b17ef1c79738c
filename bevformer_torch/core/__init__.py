from bevformer_torch.core import assigner, boxes, coder, evaluation, geometry, losses

__all__ = ["assigner", "boxes", "coder", "evaluation", "geometry", "losses"]
