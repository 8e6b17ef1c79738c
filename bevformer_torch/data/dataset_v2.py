"""BEVFormerV2's test samples: every offset of `cfg.frames` around the
sample, all through one set of augmentation parameters.

Port of `bevformer_tpu/data/dataset_v2.py::NuScenesTemporalDatasetV2.
get_test_sample_v2` (:295-347; reference `datasets/nuscenes_dataset_v2.py`):
  * the crop window reconstructed from `raw_size`, the post-crop size
    (:60-66);
  * a history frame's `lidar2img` maps the current frame's lidar
    coordinates: cam2img @ lidar2cam @ inv(rel), with rel the adjacent
    lidar frame in the current one through both ego poses and the current
    frame's lidar2ego on both sides (:318-334, `union2one`);
  * a frame across a scene boundary or past either end of the infos takes
    the current frame's images and matrices (:336-338);
  * normalise, then pad (the v1 pipeline's steps, on the dataset's device).
The training samples (mono targets, GlobalRotScaleTrans, the resize
ladder) are not ported yet (ROADMAP.md §1 item 7).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from bevformer_torch.core.geometry import quat_to_rot
from bevformer_torch.data import pipeline_v2
from bevformer_torch.data.dataset import CAM_ORDER, NuScenesTemporalDataset
from bevformer_torch.data.image_io import read_image
from bevformer_torch.data.pipeline import preprocess_images


def _pose(rotation, translation) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = quat_to_rot(np.asarray(rotation))
    m[:3, 3] = np.asarray(translation)
    return m


class NuScenesTemporalDatasetV2(NuScenesTemporalDataset):
    def _aug_params(self) -> Dict:
        """The test setting's crop, resize and flip: the nuScenes crop
        window below row 260, of `raw_size`, at the ladder's 640 rows."""
        h, w = self.dcfg.raw_size
        crop = (0, 260, w, h + 260)
        return pipeline_v2.sample_crop_resize_flip(
            self.rng, resize_ladder=(640,), crop=crop, rand_flip=False, training=False)

    def _load_frame(self, index: int, aug: Dict) -> Tuple[torch.Tensor, np.ndarray]:
        """One frame's cameras through the augmentation, normalised and
        padded on the dataset's device ([cams, *img_size, 3] float32), and
        its lidar2img [cams, 4, 4] float32."""
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
        imgs, _, lidar2img = pipeline_v2.crop_resize_flip(
            np.stack(imgs), np.stack(cam2img), np.stack(lidar2cam), aug)
        images, _ = preprocess_images(torch.from_numpy(imgs).to(self.device), lidar2img,
                                      self.dcfg)
        return images, lidar2img.astype(np.float32)

    def get_test_sample_v2(self, index: int) -> Dict:
        """images [T, cams, *img_size, 3] on the dataset's device, lidar2img
        [T, cams, 4, 4], frame_valid [T] (False where the current frame
        filled in), flip, bda_mat (the identity), scene_token, token."""
        aug = self._aug_params()
        frames = self.cfg.frames
        t, cams = len(frames), self.dcfg.num_cams
        ph, pw = self.dcfg.img_size
        images = torch.zeros((t, cams, ph, pw, 3), dtype=torch.float32, device=self.device)
        l2i = np.zeros((t, cams, 4, 4), np.float32)
        frame_valid = np.zeros((t,), bool)
        cur_i = frames.index(0)
        cur = self.infos[index]
        images[cur_i], l2i[cur_i] = self._load_frame(index, aug)
        frame_valid[cur_i] = True

        l2e = _pose(cur.get("lidar2ego_rotation", [1, 0, 0, 0]),
                    cur.get("lidar2ego_translation", [0, 0, 0]))
        e2g_cur = _pose(cur["ego2global_rotation"], cur["ego2global_translation"])
        for ti, off in enumerate(frames):
            j = index + off
            if (off == 0 or j < 0 or j >= len(self.infos)
                    or self.infos[j]["scene_token"] != cur["scene_token"]):
                continue
            imgs_j, l2i_j = self._load_frame(j, aug)
            adj = self.infos[j]
            e2g_adj = _pose(adj["ego2global_rotation"], adj["ego2global_translation"])
            rel = np.linalg.inv(l2e) @ np.linalg.inv(e2g_cur) @ e2g_adj @ l2e
            l2i[ti] = np.stack([m @ np.linalg.inv(rel) for m in l2i_j]).astype(np.float32)
            images[ti] = imgs_j
            frame_valid[ti] = True
        for ti in np.flatnonzero(~frame_valid):
            images[ti], l2i[ti] = images[cur_i], l2i[cur_i]
        return dict(
            images=images,
            lidar2img=l2i,
            frame_valid=frame_valid,
            flip=np.bool_(False),
            bda_mat=np.eye(2, dtype=np.float32),
            scene_token=cur["scene_token"],
            token=cur["token"],
        )
