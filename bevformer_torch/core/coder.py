"""NMS-free box decoding: flat top-k over (queries x classes) sigmoid
scores, gather and denormalise the boxes, and mark those inside the
post-centre range. Port of `bevformer_tpu/core/coder.py`
(reference `core/bbox/coders/nms_free_coder.py:10-122`) without the
score-threshold loop, which no v1 config sets.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from bevformer_torch.core.boxes import denormalize_bbox


def decode_single(
    cls_scores: torch.Tensor,  # [Q, C] logits of the last decoder layer
    bbox_preds: torch.Tensor,  # [Q, 10]
    *,
    max_num: int = 300,
    num_classes: int = 10,
    post_center_range: Sequence[float] = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
) -> Dict[str, torch.Tensor]:
    scores_all = cls_scores.float().sigmoid().reshape(-1)
    scores, idx = torch.topk(scores_all, min(max_num, scores_all.shape[0]))
    labels = idx % num_classes
    boxes = denormalize_bbox(bbox_preds[idx // num_classes])
    pcr = boxes.new_tensor(post_center_range)
    valid = (boxes[:, :3] >= pcr[:3]).all(dim=1) & (boxes[:, :3] <= pcr[3:]).all(dim=1)
    return {"bboxes": boxes, "scores": scores, "labels": labels, "valid": valid}


def decode_batch(preds: Dict[str, torch.Tensor], **kw) -> Dict[str, torch.Tensor]:
    """Decode the last decoder layer of every sample in the batch."""
    outs = [
        decode_single(c, b, **kw)
        for c, b in zip(preds["all_cls_scores"][-1], preds["all_bbox_preds"][-1])
    ]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
