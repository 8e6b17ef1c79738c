"""nuScenes temporal dataset: the infos reader, queue sampling and the
per-sample records the training and test loops take.

Port of `bevformer_tpu/data/dataset.py` (reference
`datasets/nuscenes_dataset.py:19-182`, CustomNuScenesDataset):
  * reads `nuscenes_infos_temporal_{train,val}.pkl` (the converter's format,
    or `bevformer_torch.tools.create_data synth`);
  * packs the CAN-bus slots as `get_data_info` does (`:156-165`): [0:3]
    global translation, [3:7] rotation quaternion, [-2] yaw in radians,
    [-1] in degrees;
  * builds lidar2img = viewpad @ lidar2cam (`:126-142`);
  * train: the random queue window with shuffle-drop-1 (`prepare_train_data`,
    `:31-55`) and union2one's relative CAN bus (`:58-84`).

Samples keep the JAX package's keys and shapes. The images come back as
normalised float32 tensors on the dataset's `device` (the card unless the
caller asks for another); every other field is numpy.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bevformer_torch.core.boxes import CLASS_NAMES
from bevformer_torch.core.geometry import quat_yaw
from bevformer_torch.data.image_io import read_image
from bevformer_torch.data.pipeline import preprocess_images
from bevformer_torch.device import DEFAULT as DEFAULT_DEVICE
from bevformer_torch.device import resolve as resolve_device

CAM_ORDER = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_FRONT_LEFT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_BACK_RIGHT",
)


def load_infos(path: str) -> Tuple[List[dict], dict]:
    """The infos of a `nuscenes_infos_temporal_*.pkl`, sorted by timestamp,
    and its metadata. The file is unpickled: read only infos files this
    program or the nuScenes converter wrote."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    infos = sorted(data["infos"], key=lambda e: e["timestamp"])
    return infos, data.get("metadata", {})


def lidar2img_from_cam_info(cam_info: dict) -> np.ndarray:
    """viewpad @ lidar2cam (`nuscenes_dataset.py:126-142`)."""
    l2c_r = np.linalg.inv(cam_info["sensor2lidar_rotation"])
    l2c_t = cam_info["sensor2lidar_translation"] @ l2c_r.T
    rt = np.eye(4)
    rt[:3, :3] = l2c_r.T
    rt[3, :3] = -l2c_t
    intrinsic = np.asarray(cam_info["cam_intrinsic"])
    viewpad = np.eye(4)
    viewpad[: intrinsic.shape[0], : intrinsic.shape[1]] = intrinsic
    return viewpad @ rt.T


class NuScenesTemporalDataset:
    def __init__(
        self,
        ann_file: str,
        cfg,
        load_images: bool = True,
        data_root: str = "",
        seed: int = 0,
        device=DEFAULT_DEVICE,
    ):
        self.cfg = cfg
        self.dcfg = cfg.data
        self.load_images = load_images
        self.data_root = data_root
        self.device = resolve_device(device)
        self.infos, self.metadata = load_infos(ann_file)
        self.rng = np.random.RandomState(seed)
        self.class_to_idx = {n: i for i, n in enumerate(CLASS_NAMES)}

    def __len__(self) -> int:
        return len(self.infos)

    # ------------------------------------------------------------------
    # per-frame raw record
    # ------------------------------------------------------------------
    def frame_record(self, index: int) -> Dict:
        info = self.infos[index]
        cams = info["cams"]
        names = [c for c in CAM_ORDER if c in cams] or list(cams)
        lidar2img = np.stack([lidar2img_from_cam_info(cams[c]) for c in names])
        img_paths = [cams[c]["data_path"] for c in names]

        can_bus = np.array(info["can_bus"], np.float64).copy()
        rotation = np.asarray(info["ego2global_rotation"], np.float64)
        translation = np.asarray(info["ego2global_translation"], np.float64)
        can_bus[:3] = translation
        can_bus[3:7] = rotation
        patch_angle = quat_yaw(rotation) / np.pi * 180.0
        if patch_angle < 0:
            patch_angle += 360.0
        can_bus[-2] = patch_angle / 180.0 * np.pi
        can_bus[-1] = patch_angle

        rec = dict(
            token=info["token"],
            scene_token=info.get("scene_token", ""),
            prev=info.get("prev", ""),
            next=info.get("next", ""),
            can_bus=can_bus,
            lidar2img=lidar2img,
            img_paths=img_paths,
            timestamp=info["timestamp"] / 1e6,
        )
        if "gt_boxes" in info:
            rec.update(self._annotations(info))
        return rec

    def _annotations(self, info: dict) -> Dict:
        boxes = np.asarray(info["gt_boxes"], np.float32).reshape(-1, 7)
        names = list(info["gt_names"])
        vel = np.asarray(
            info.get("gt_velocity", np.zeros((len(names), 2))), np.float32
        ).reshape(-1, 2)
        if "valid_flag" in info:
            valid = np.asarray(info["valid_flag"], bool)
        else:
            valid = np.asarray(info.get("num_lidar_pts", np.ones(len(names)))) > 0
        labels = np.array([self.class_to_idx.get(n, -1) for n in names], np.int64)
        attrs = np.asarray(
            info.get("gt_attrs", np.array([""] * len(names), dtype=object)), dtype=object
        )
        keep = valid & (labels >= 0)
        boxes, vel, labels, attrs = boxes[keep], np.nan_to_num(vel[keep]), labels[keep], attrs[keep]
        # ObjectRangeFilter: the BEV range on (x, y)
        pcr = self.cfg.pc_range
        in_range = ((boxes[:, 0] >= pcr[0]) & (boxes[:, 0] <= pcr[3])
                    & (boxes[:, 1] >= pcr[1]) & (boxes[:, 1] <= pcr[4]))
        boxes, vel, labels = boxes[in_range], vel[in_range], labels[in_range]
        attrs = attrs[in_range]
        # 9-dim metric box with gravity-centre z (the loss convention)
        out = np.concatenate(
            [boxes[:, :2], (boxes[:, 2] + 0.5 * boxes[:, 5])[:, None], boxes[:, 3:7], vel],
            axis=1,
        ).astype(np.float32)
        return dict(gt_boxes=out, gt_labels=labels.astype(np.int32), gt_attrs=attrs)

    def gt_by_token(self, indices) -> Dict[str, Dict[str, np.ndarray]]:
        """token -> {boxes [G, 9] with bottom z, labels, attrs}: the ground
        truth `core.evaluation.evaluate_detections` takes (`tools/test.py`)."""
        gt = {}
        for i in indices:
            ann = self._annotations(self.infos[i])
            boxes = ann["gt_boxes"].copy()
            if len(boxes):
                boxes[:, 2] -= 0.5 * boxes[:, 5]  # gravity -> bottom z
            gt[self.infos[i]["token"]] = dict(
                boxes=boxes, labels=ann["gt_labels"], attrs=ann["gt_attrs"])
        return gt

    # ------------------------------------------------------------------
    # temporal queue (train)
    # ------------------------------------------------------------------
    def sample_queue_indices(self, index: int) -> List[int]:
        """`prepare_train_data` (`nuscenes_dataset.py:39-43`): take the
        window [i-Q, i), shuffle, drop one, sort, append i."""
        q = self.dcfg.queue_length
        idx_list = list(range(index - q, index))
        self.rng.shuffle(idx_list)
        idx_list = sorted(idx_list[1:])
        idx_list.append(index)
        return [max(0, i) for i in idx_list]

    def _load_frame_images(self, rec: Dict, train: bool) -> Tuple[torch.Tensor, np.ndarray]:
        imgs = np.stack([
            read_image(os.path.join(self.data_root, p))
            for p in rec["img_paths"]
        ])
        imgs = torch.from_numpy(imgs).to(self.device)
        return preprocess_images(imgs, rec["lidar2img"], self.dcfg, rng=self.rng, train=train)

    def get_train_sample(self, index: int) -> Optional[Dict]:
        """The union2one'd temporal sample, or None where the trained frame
        has no ground truth (`filter_empty_gt`)."""
        idxs = self.sample_queue_indices(index)
        recs = [self.frame_record(i) for i in idxs]
        if "gt_boxes" in recs[-1] and len(recs[-1]["gt_boxes"]) == 0:
            return None

        t = len(recs)
        cams = len(recs[-1]["img_paths"])
        h, w = self.dcfg.img_size
        images = torch.zeros((t, cams, h, w, 3), dtype=torch.float32, device=self.device)
        l2i = np.zeros((t, cams, 4, 4), np.float32)
        can_bus = np.zeros((t, 18), np.float32)
        prev_exists = np.zeros((t,), bool)

        # union2one relative CAN bus (`nuscenes_dataset.py:58-84`)
        prev_scene, prev_pos, prev_angle = None, None, None
        for i, rec in enumerate(recs):
            cb = rec["can_bus"].copy()
            if rec["scene_token"] != prev_scene:
                prev_exists[i] = False
                prev_scene = rec["scene_token"]
                prev_pos = cb[:3].copy()
                prev_angle = cb[-1]
                cb[:3] = 0
                cb[-1] = 0
            else:
                prev_exists[i] = True
                tmp_pos, tmp_angle = cb[:3].copy(), cb[-1]
                cb[:3] -= prev_pos
                cb[-1] -= prev_angle
                prev_pos, prev_angle = tmp_pos, tmp_angle
            can_bus[i] = cb.astype(np.float32)
            if self.load_images:
                images[i], l2i[i] = self._load_frame_images(rec, train=True)
            else:
                l2i[i] = rec["lidar2img"]

        g = self.cfg.max_gt
        gt_boxes = np.zeros((g, 9), np.float32)
        gt_labels = np.zeros((g,), np.int32)
        boxes = recs[-1].get("gt_boxes", np.zeros((0, 9), np.float32))
        labels = recs[-1].get("gt_labels", np.zeros((0,), np.int32))
        n = min(len(boxes), g)
        gt_boxes[:n] = boxes[:n]
        gt_labels[:n] = labels[:n]

        return dict(
            images=images,
            can_bus=can_bus,
            lidar2img=l2i,
            prev_exists=prev_exists,
            gt_boxes=gt_boxes,
            gt_labels=gt_labels,
            num_gt=np.int32(n),
            token=recs[-1]["token"],
        )

    # ------------------------------------------------------------------
    # eval (sequential video, state handled by the caller)
    # ------------------------------------------------------------------
    def get_test_sample(self, index: int) -> Dict:
        rec = self.frame_record(index)
        if self.load_images:
            images, l2i = self._load_frame_images(rec, train=False)
        else:
            h, w = self.dcfg.img_size
            images = torch.zeros((len(rec["img_paths"]), h, w, 3), device=self.device)
            l2i = rec["lidar2img"].astype(np.float32)
        return dict(
            images=images,
            can_bus=rec["can_bus"].astype(np.float64),
            lidar2img=l2i,
            scene_token=rec["scene_token"],
            token=rec["token"],
            timestamp=rec["timestamp"],
        )
