"""BEVFormerV2's samples: every offset of `cfg.frames` around the sample,
all through one set of augmentation parameters; for training also the
GlobalRotScaleTrans'd ground truth and the DD3D head's per-camera targets.

Port of `bevformer_tpu/data/dataset_v2.py::NuScenesTemporalDatasetV2`
(reference `datasets/nuscenes_dataset_v2.py`):
  * `_aug_params` (:60-87): the crop window reconstructed from `raw_size`,
    the post-crop size; in training a height of `v2_resize_ladder`, the
    flip and GlobalRotScaleTrans's four draws, in that order, from the
    dataset's `RandomState` (the test setting draws nothing);
  * a frame's cameras (:89-136): in training the photometric distortion
    per frame as it loads (before the crop, the current frame first, then
    the others in `frames` order), then the crop, PIL's resize and the flip
    (`pipeline_v2.crop_resize_flip`), normalised and padded on the
    dataset's device. The pad is each axis's larger of `img_size` and the
    resized size rounded up to `size_divisor`: JAX pads into `img_size`,
    which raises for the ladder's heights above 640 rows; the port follows
    the reference's `PadMultiViewImage(size_divisor=32)` there;
  * a history frame's `lidar2img` maps the current frame's lidar
    coordinates: cam2img @ lidar2cam @ inv(rel), with rel the adjacent
    lidar frame in the current one through both ego poses and the current
    frame's lidar2ego on both sides (`union2one`);
  * a frame across a scene boundary or past either end of the infos takes
    the current frame's images and matrices, and its `frame_valid` is
    False (:189-194, :336-338);
  * `get_train_sample_v2` (:138-234): None without ground truth; the GT
    boxes taken from gravity to bottom z, through GlobalRotScaleTrans and
    back, then filtered to the BEV range again (None if none is left);
  * `mono_targets` (JAX `_mono_targets` :236-293): per camera, up to
    `MAX_MONO_BOXES` of the un-augmented GT in front of the camera whose
    projected centre falls in the resized image, with a square 2D box from
    the projected 3D extent, the camera-frame orientation
    (`yaw_to_quat_cam`), projected centre, depth, size, speed and a moving /
    not-moving attribute.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bevformer_torch.core.geometry import quat_to_rot
from bevformer_torch.data import pipeline_v2
from bevformer_torch.data.dataset import CAM_ORDER, NuScenesTemporalDataset
from bevformer_torch.data.image_io import read_image
from bevformer_torch.data.pipeline import photometric_distortion, preprocess_images
from bevformer_torch.models.dd3d import MAX_NUM_ATTRIBUTES

# per-camera DD3D targets a sample carries (JAX `dataset_v2.py:55`)
MAX_MONO_BOXES = 32


def _pose(rotation, translation) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = quat_to_rot(np.asarray(rotation))
    m[:3, 3] = np.asarray(translation)
    return m


def yaw_to_quat_cam(yaw_lidar: float, lidar2cam_r: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of the camera-frame orientation of a lidar box of yaw
    `yaw_lidar`: the rotation's trace branch, else the largest diagonal's."""
    c, s = np.cos(yaw_lidar), np.sin(yaw_lidar)
    r = lidar2cam_r @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    tr = np.trace(r)
    if tr > 0:
        w = np.sqrt(max(1 + tr, 1e-12)) / 2
        return np.array([w, (r[2, 1] - r[1, 2]) / (4 * w), (r[0, 2] - r[2, 0]) / (4 * w),
                         (r[1, 0] - r[0, 1]) / (4 * w)])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s2 = np.sqrt(max(1 + r[i, i] - r[j, j] - r[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (r[k, j] - r[j, k]) / s2
    q[1 + i] = s2 / 4
    q[1 + j] = (r[j, i] + r[i, j]) / s2
    q[1 + k] = (r[k, i] + r[i, k]) / s2
    return q


def pad_size(dcfg, ida: Dict) -> Tuple[int, int]:
    """(H, W) the images resized by `ida` are padded to: per axis the larger
    of `img_size` and the resized size rounded up to `size_divisor`."""
    rw, rh = ida["resize_dims"]
    d = dcfg.size_divisor
    ph, pw = dcfg.img_size
    return max(ph, -(-rh // d) * d), max(pw, -(-rw // d) * d)


def mono_targets(boxes: np.ndarray, labels: np.ndarray, lidar2cam: np.ndarray,
                 cam2img: np.ndarray, resize_dims: Tuple[int, int], cams: int
                 ) -> Dict[str, np.ndarray]:
    """Per-camera DD3D targets (JAX `_mono_targets` :236-293) from the
    un-augmented lidar-frame GT (`boxes` [G, 9] gravity-centre z), each
    camera's lidar2cam and augmented cam2img, padded to `MAX_MONO_BOXES`."""
    g = MAX_MONO_BOXES
    rw, rh = resize_dims
    out = {
        "mono_boxes2d": np.zeros((cams, g, 4), np.float32),
        "mono_classes": np.zeros((cams, g), np.int32),
        "mono_num_gt": np.zeros((cams,), np.int32),
        "mono_img_valid": np.ones((cams,), bool),
        "mono_quat": np.zeros((cams, g, 4), np.float32),
        "mono_ctr": np.zeros((cams, g, 2), np.float32),
        "mono_depth": np.zeros((cams, g), np.float32),
        "mono_size": np.zeros((cams, g, 3), np.float32),
        "mono_attributes": np.full((cams, g), MAX_NUM_ATTRIBUTES, np.int32),
        "mono_speeds": np.zeros((cams, g), np.float32),
        "inv_intrinsics": np.zeros((cams, 3, 3), np.float32),
    }
    for ci in range(min(cams, len(lidar2cam))):
        k = cam2img[ci][:3, :3]
        out["inv_intrinsics"][ci] = np.linalg.inv(k).astype(np.float32)
        m = 0
        for b, lbl in zip(boxes, labels):
            if m >= g:
                break
            ctr_cam = lidar2cam[ci][:3, :3] @ b[:3] + lidar2cam[ci][:3, 3]
            if ctr_cam[2] < 0.5:
                continue
            uvw = k @ ctr_cam
            u, v = uvw[0] / uvw[2], uvw[1] / uvw[2]
            if not (0 <= u < rw and 0 <= v < rh):
                continue
            radius = 0.5 * np.linalg.norm(b[3:6]) / ctr_cam[2] * k[0, 0]
            box2d = np.clip(np.array([u - radius, v - radius, u + radius, v + radius]),
                            0, [rw, rh, rw, rh])
            if box2d[2] - box2d[0] < 2 or box2d[3] - box2d[1] < 2:
                continue
            speed = float(np.linalg.norm(b[7:9]))
            out["mono_boxes2d"][ci, m] = box2d
            out["mono_classes"][ci, m] = lbl
            out["mono_quat"][ci, m] = yaw_to_quat_cam(b[6], lidar2cam[ci][:3, :3])
            out["mono_ctr"][ci, m] = (u, v)
            out["mono_depth"][ci, m] = ctr_cam[2]
            out["mono_size"][ci, m] = b[3:6]
            out["mono_speeds"][ci, m] = speed
            out["mono_attributes"][ci, m] = 0 if speed > 0.2 else 1
            m += 1
        out["mono_num_gt"][ci] = m
    return out


class NuScenesTemporalDatasetV2(NuScenesTemporalDataset):
    def _aug_params(self, train: bool = False) -> Dict:
        """The sample's `ida` (crop, resize, flip) and `bda`
        (GlobalRotScaleTrans) parameters: the nuScenes crop window below
        row 260, of `raw_size`; at test time the ladder's 640 rows, no flip
        and no GlobalRotScaleTrans, with nothing drawn."""
        d = self.dcfg
        h, w = d.raw_size
        ida = pipeline_v2.sample_crop_resize_flip(
            self.rng, resize_ladder=tuple(d.v2_resize_ladder) if train else (640,),
            crop=(0, 260, w, h + 260), rand_flip=train and d.v2_rand_flip, training=train)
        bda = (pipeline_v2.sample_global_rot_scale_flip(self.rng) if train and d.v2_use_grst
               else dict(pipeline_v2.NO_BDA))
        return dict(ida=ida, bda=bda)

    def _load_frame(self, index: int, ida: Dict, train: bool
                    ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray, np.ndarray]:
        """One frame's cameras through the augmentation, normalised and
        padded on the dataset's device ([cams, *pad_size, 3] float32), its
        lidar2img [cams, 4, 4] float32, lidar2cam and the augmented cam2img
        (float64)."""
        cams = self.infos[index]["cams"]
        names = [c for c in CAM_ORDER if c in cams] or list(cams)
        imgs, cam2img, lidar2cam = [], [], []
        for name in names:
            ci = cams[name]
            imgs.append(read_image(os.path.join(self.data_root, ci["data_path"])))
            l2c_r = np.linalg.inv(ci["sensor2lidar_rotation"])
            rt = np.eye(4)
            rt[:3, :3] = l2c_r
            rt[:3, 3] = -(ci["sensor2lidar_translation"] @ l2c_r.T)
            lidar2cam.append(rt)
            intr = np.asarray(ci["cam_intrinsic"])
            viewpad = np.eye(4)
            viewpad[: intr.shape[0], : intr.shape[1]] = intr
            cam2img.append(viewpad)
        imgs = np.stack(imgs)
        if train and self.dcfg.use_photometric:
            # in float32 on the dataset's device, the images sent as uint8
            # (chip_smoke.py phase 12 times it on the host and on the
            # card); the crop takes it back to the host as uint8, clipped
            # and truncated as np.uint8 does
            dist = photometric_distortion(torch.from_numpy(imgs).to(self.device).float(),
                                          self.rng)
            imgs = dist.clamp_(0, 255).to(torch.uint8).cpu().numpy()
        lidar2cam = np.stack(lidar2cam)
        imgs, cam2img, lidar2img = pipeline_v2.crop_resize_flip(
            imgs, np.stack(cam2img), lidar2cam, ida)
        images, _ = preprocess_images(torch.from_numpy(imgs).to(self.device), lidar2img,
                                      self.dcfg, pad_to=pad_size(self.dcfg, ida))
        return images, lidar2img.astype(np.float32), lidar2cam, cam2img

    def _load_frames(self, index: int, ida: Dict, train: bool):
        """Every offset of `cfg.frames`: (images [T, cams, *pad_size, 3] on
        the dataset's device, lidar2img [T, cams, 4, 4] float32,
        frame_valid [T], the current frame's lidar2cam and cam2img)."""
        frames = self.cfg.frames
        t, cams = len(frames), self.dcfg.num_cams
        images = torch.zeros((t, cams, *pad_size(self.dcfg, ida), 3), dtype=torch.float32,
                             device=self.device)
        l2i = np.zeros((t, cams, 4, 4), np.float32)
        frame_valid = np.zeros((t,), bool)
        cur_i = frames.index(0)
        cur = self.infos[index]
        images[cur_i], l2i[cur_i], l2c, c2i = self._load_frame(index, ida, train)
        frame_valid[cur_i] = True

        l2e = _pose(cur.get("lidar2ego_rotation", [1, 0, 0, 0]),
                    cur.get("lidar2ego_translation", [0, 0, 0]))
        e2g_cur = _pose(cur["ego2global_rotation"], cur["ego2global_translation"])
        for ti, off in enumerate(frames):
            j = index + off
            if (off == 0 or j < 0 or j >= len(self.infos)
                    or self.infos[j]["scene_token"] != cur["scene_token"]):
                continue
            imgs_j, l2i_j, _, _ = self._load_frame(j, ida, train)
            adj = self.infos[j]
            e2g_adj = _pose(adj["ego2global_rotation"], adj["ego2global_translation"])
            rel = np.linalg.inv(l2e) @ np.linalg.inv(e2g_cur) @ e2g_adj @ l2e
            l2i[ti] = np.stack([m @ np.linalg.inv(rel) for m in l2i_j]).astype(np.float32)
            images[ti] = imgs_j
            frame_valid[ti] = True
        for ti in np.flatnonzero(~frame_valid):
            images[ti], l2i[ti] = images[cur_i], l2i[cur_i]
        return images, l2i, frame_valid, l2c, c2i

    def get_test_sample_v2(self, index: int) -> Dict:
        """images [T, cams, *img_size, 3] on the dataset's device, lidar2img
        [T, cams, 4, 4], frame_valid [T] (False where the current frame
        filled in), flip, bda_mat (the identity), scene_token, token."""
        aug = self._aug_params(train=False)
        images, l2i, frame_valid, _, _ = self._load_frames(index, aug["ida"], train=False)
        cur = self.infos[index]
        return dict(images=images, lidar2img=l2i, frame_valid=frame_valid, flip=np.bool_(False),
                    bda_mat=np.eye(2, dtype=np.float32), scene_token=cur["scene_token"],
                    token=cur["token"])

    def get_train_sample_v2(self, index: int) -> Optional[Dict]:
        """The training sample, or None where the current frame has no
        ground truth, before or after GlobalRotScaleTrans's range filter.
        The keys of `get_test_sample_v2` (images padded to `pad_size`; no
        scene_token) with the drawn flip and `bda_mat` [2, 2], the padded
        GT (`gt_boxes` [max_gt, 9] gravity-centre z, `gt_labels`, `num_gt`)
        and the DD3D targets (`MONO_KEYS`, `inv_intrinsics`)."""
        cur = self.infos[index]
        ann = self._annotations(cur)
        if len(ann["gt_boxes"]) == 0:
            return None
        aug = self._aug_params(train=True)
        images, l2i, frame_valid, l2c, c2i = self._load_frames(index, aug["ida"], train=True)

        boxes = ann["gt_boxes"].copy()
        boxes[:, 2] -= 0.5 * boxes[:, 5]  # gravity -> bottom for the aug ops
        boxes = pipeline_v2.global_rot_scale_trans_gt(boxes, aug["bda"])
        boxes[:, 2] += 0.5 * boxes[:, 5]
        pcr = self.cfg.pc_range
        keep = ((boxes[:, 0] >= pcr[0]) & (boxes[:, 0] <= pcr[3])
                & (boxes[:, 1] >= pcr[1]) & (boxes[:, 1] <= pcr[4]))
        boxes, labels = boxes[keep], ann["gt_labels"][keep]
        if len(boxes) == 0:
            return None
        g = self.cfg.max_gt
        gt_boxes = np.zeros((g, 9), np.float32)
        gt_labels = np.zeros((g,), np.int32)
        n = min(len(boxes), g)
        gt_boxes[:n] = boxes[:n]
        gt_labels[:n] = labels[:n]
        return dict(images=images, lidar2img=l2i, frame_valid=frame_valid,
                    flip=np.bool_(aug["ida"]["flip"]),
                    bda_mat=aug["bda"]["bda_mat"][:2, :2].astype(np.float32),
                    gt_boxes=gt_boxes, gt_labels=gt_labels, num_gt=np.int32(n),
                    token=cur["token"],
                    **mono_targets(ann["gt_boxes"], ann["gt_labels"], l2c, c2i,
                                   aug["ida"]["resize_dims"], self.dcfg.num_cams))
