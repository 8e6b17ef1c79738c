"""Video inference loop with the prev-BEV carry.

Port of `bevformer_tpu/runtime/eval.py::VideoEvaluator` (reference
`BEVFormer.forward_test`, `detectors/bevformer.py:236-269`): the scene
reset, the CAN-bus deltas between consecutive frames and the `prev_bev`
carry are host-side state; every frame runs the same model call.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bevformer_torch.core import coder
from bevformer_torch.models import BEVFormer


class VideoEvaluator:
    def __init__(self, model: BEVFormer, max_num: Optional[int] = None):
        self.model = model.eval()
        self.cfg = model.cfg
        self.max_num = max_num or model.cfg.max_num
        self.device = next(model.parameters()).device
        self.reset()

    def reset(self):
        c = self.cfg
        self._prev_bev = torch.zeros(
            (1, c.bev_h * c.bev_w, c.embed_dims), dtype=torch.float32,
            device=self.device,
        )
        self._scene_token = None
        self._prev_pos = None
        self._prev_angle = None
        self._has_prev = False

    @torch.no_grad()
    def step(self, images, can_bus, lidar2img, prev_bev, has_prev):
        """One frame: model forward and top-k decode. Returns (bev_embed,
        decoded batch)."""
        c = self.cfg
        preds = self.model(images, can_bus, lidar2img, prev_bev, has_prev)
        dec = coder.decode_batch(
            preds,
            max_num=self.max_num,
            num_classes=c.num_classes,
            post_center_range=c.post_center_range,
        )
        return preds["bev_embed"], dec

    def infer_frame(self, sample: Dict) -> Dict[str, np.ndarray]:
        """sample: images [cams, H, W, 3] (normalised), can_bus [18]
        (absolute pose packing), lidar2img [cams, 4, 4], scene_token, token."""
        if sample["scene_token"] != self._scene_token:
            self._has_prev = False
        self._scene_token = sample["scene_token"]

        can_bus = np.array(sample["can_bus"], np.float64).copy()
        tmp_pos = can_bus[:3].copy()
        tmp_angle = float(can_bus[-1])
        if self._has_prev:
            can_bus[:3] -= self._prev_pos
            can_bus[-1] -= self._prev_angle
        else:
            can_bus[:3] = 0
            can_bus[-1] = 0

        dev = self.device
        images = torch.as_tensor(sample["images"], dtype=torch.float32, device=dev)[None]
        can = torch.as_tensor(can_bus, dtype=torch.float32, device=dev)[None]
        l2i = torch.as_tensor(sample["lidar2img"], dtype=torch.float32, device=dev)[None]
        has = torch.tensor([self._has_prev], device=dev)
        bev, dec = self.step(images, can, l2i, self._prev_bev, has)
        self._prev_bev = bev.float()
        self._prev_pos = tmp_pos
        self._prev_angle = tmp_angle
        self._has_prev = True

        valid = dec["valid"][0].cpu().numpy()
        boxes = dec["bboxes"][0].cpu().numpy().copy()
        # gravity-centre z -> bottom z (`bevformer_head.py:500`)
        boxes[:, 2] -= 0.5 * boxes[:, 5]
        return {
            "token": sample["token"],
            "boxes_3d": boxes[valid],
            "scores_3d": dec["scores"][0].cpu().numpy()[valid],
            "labels_3d": dec["labels"][0].cpu().numpy()[valid],
        }

    def run(self, dataset, indices=None, progress_every: int = 50) -> List[Dict]:
        results = []
        idxs = indices if indices is not None else range(len(dataset))
        for i in idxs:
            results.append(self.infer_frame(dataset.get_test_sample(i)))
            if progress_every and len(results) % progress_every == 0:
                print(f"eval {len(results)} frames", flush=True)
        return results
