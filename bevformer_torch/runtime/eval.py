"""Inference loops.

`VideoEvaluator`, port of `bevformer_tpu/runtime/eval.py::VideoEvaluator`
(reference `BEVFormer.forward_test`, `detectors/bevformer.py:236-269`): the
scene reset, the CAN-bus deltas between consecutive frames and the
`prev_bev` carry are host-side state; every frame runs the same model call.

`VideoEvaluatorV2`, port of the JAX `VideoEvaluatorV2` (reference
`BEVFormerV2.forward_test`/`simple_test`, `detectors/bevformerV2.py:226-266`):
no state across samples; each sample encodes its history frames
(`bev_only`), then runs its current frame with their BEVs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bevformer_torch.core import coder
from bevformer_torch.device import precision
from bevformer_torch.models import BEVFormer, BEVFormerV2


def decoded_result(token: str, dec: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The valid boxes of a decoded batch of one, with bottom z."""
    valid = dec["valid"][0].cpu().numpy()
    boxes = dec["bboxes"][0].cpu().numpy().copy()
    # gravity-centre z -> bottom z (`bevformer_head.py:500`)
    boxes[:, 2] -= 0.5 * boxes[:, 5]
    return {
        "token": token,
        "boxes_3d": boxes[valid],
        "scores_3d": dec["scores"][0].cpu().numpy()[valid],
        "labels_3d": dec["labels"][0].cpu().numpy()[valid],
    }


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
        """One frame: model forward and top-k decode, in the config's dtype
        whatever the caller's TF32 flags. Returns (bev_embed, decoded
        batch)."""
        c = self.cfg
        with precision(c.dtype, self.device.type):
            preds = self.model(images, can_bus, lidar2img, prev_bev, has_prev)
        dec = coder.decode_batch(
            preds,
            max_num=self.max_num,
            num_classes=c.num_classes,
            post_center_range=c.post_center_range,
        )
        return preds["bev_embed"], dec

    def infer_frame(self, sample: Dict) -> Dict[str, np.ndarray]:
        """sample: images [cams, H, W, 3] (normalised; a float32 tensor on
        the model's device, as the dataset hands it over, is used as it is,
        without a copy), can_bus [18] (absolute pose packing), lidar2img
        [cams, 4, 4], scene_token, token."""
        if sample["scene_token"] != self._scene_token or not self.cfg.video_test_mode:
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

        return decoded_result(sample["token"], dec)

    def run(self, dataset, indices=None, progress_every: int = 50) -> List[Dict]:
        results = []
        idxs = indices if indices is not None else range(len(dataset))
        for i in idxs:
            results.append(self.infer_frame(dataset.get_test_sample(i)))
            if progress_every and len(results) % progress_every == 0:
                print(f"eval {len(results)} frames", flush=True)
        return results


class VideoEvaluatorV2:
    """BEVFormerV2 inference, sample by sample, in eval mode and in the
    config's dtype (`device.precision`) whatever the caller's TF32 flags."""

    def __init__(self, model: BEVFormerV2, max_num: Optional[int] = None):
        self.model = model.eval()
        self.cfg = model.cfg
        self.max_num = max_num or model.cfg.max_num
        self.device = next(model.parameters()).device
        self.cur = self.cfg.frames.index(0)

    @torch.no_grad()
    def step(self, images, lidar2img, flip, bda_mat):
        """images [1, T, cams, H, W, 3] and lidar2img [1, T, cams, 4, 4] for
        the T offsets of `cfg.frames`: each history frame's BEV, then the
        current frame's head outputs and their top-k decode. Returns
        (head outputs, decoded batch)."""
        c, m = self.cfg, self.model
        with precision(c.dtype, self.device.type):
            prev = [None if off == 0 else m.bev_only(images[:, i], lidar2img[:, i], flip, bda_mat)
                    for i, off in enumerate(c.frames)]
            preds = m(images[:, self.cur], lidar2img[:, self.cur], prev, flip, bda_mat)
        dec = coder.decode_batch(
            preds,
            max_num=self.max_num,
            num_classes=c.num_classes,
            post_center_range=c.post_center_range,
        )
        return preds, dec

    def infer_sample(self, sample: Dict) -> Dict[str, np.ndarray]:
        """sample (`NuScenesTemporalDatasetV2.get_test_sample_v2`): images
        [T, cams, H, W, 3] (normalised; a float32 tensor on the model's
        device is used without a copy), lidar2img [T, cams, 4, 4], flip,
        bda_mat [2, 2] (the identity where absent), token."""
        dev = self.device
        images = torch.as_tensor(sample["images"], dtype=torch.float32, device=dev)[None]
        l2i = torch.as_tensor(sample["lidar2img"], dtype=torch.float32, device=dev)[None]
        flip = torch.tensor([bool(sample.get("flip", False))], device=dev)
        bda = torch.as_tensor(sample.get("bda_mat", np.eye(2)), dtype=torch.float32,
                              device=dev)[None]
        _, dec = self.step(images, l2i, flip, bda)
        return decoded_result(sample["token"], dec)

    def run(self, dataset, indices=None, progress_every: int = 50) -> List[Dict]:
        results = []
        idxs = indices if indices is not None else range(len(dataset))
        for i in idxs:
            results.append(self.infer_sample(dataset.get_test_sample_v2(i)))
            if progress_every and len(results) % progress_every == 0:
                print(f"eval {len(results)} samples", flush=True)
        return results
