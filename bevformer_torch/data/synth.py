"""Synthetic video frames for the inference path.

Camera rigs and `lidar2img` are ports of
`bevformer_tpu/data/synth.py::_camera_rigs` and
`bevformer_tpu/data/dataset.py::lidar2img_from_cam_info`. The frames are
seeded noise images, already normalised as the data pipeline would
(caffe-style mean subtraction), with CAN-bus poses along a smooth ego
trajectory packed as the dataset packs them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

CAM_ORDER = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_FRONT_LEFT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_BACK_RIGHT",
)


def camera_rigs(img_w=1600, img_h=900) -> Dict[str, dict]:
    """Six cameras looking out radially, nuScenes-style naming."""
    f = 0.8 * img_w
    intrinsic = np.array(
        [[f, 0, img_w / 2], [0, f, img_h / 2], [0, 0, 1]], np.float64
    )
    yaws = dict(zip(CAM_ORDER, (0.0, -np.pi / 3, np.pi / 3, np.pi,
                                2 * np.pi / 3, -2 * np.pi / 3)))
    # columns: the camera axes (x right, y down, z forward) in lidar
    # coordinates for a camera heading along +x
    cam_axes_in_lidar = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
    rigs = {}
    for name, yaw in yaws.items():
        cy, sy = np.cos(yaw), np.sin(yaw)
        lidar_from_heading = np.array(
            [[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float64
        )
        rigs[name] = dict(
            rotation=lidar_from_heading @ cam_axes_in_lidar,
            translation=np.array([1.5 * cy, 1.5 * sy, 1.6]),
            intrinsic=intrinsic,
        )
    return rigs


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


def rig_lidar2img(img_w=1600, img_h=900) -> np.ndarray:
    """[6, 4, 4] lidar2img of the six rigs, in CAM_ORDER."""
    return np.stack([
        lidar2img_from_cam_info(dict(
            sensor2lidar_rotation=r["rotation"],
            sensor2lidar_translation=r["translation"],
            cam_intrinsic=r["intrinsic"],
        ))
        for r in camera_rigs(img_w, img_h).values()
    ])


def can_bus_pose(pos: Sequence[float], yaw: float, speed: float) -> np.ndarray:
    """CAN-bus vector as the dataset packs it: [0:3] translation, [3:7]
    rotation quaternion (about z), [7:10] velocity, [-2] yaw in radians
    and [-1] in degrees, both in [0, 360)."""
    can_bus = np.zeros(18)
    can_bus[:3] = pos
    can_bus[3:7] = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
    can_bus[7:10] = [speed * np.cos(yaw), speed * np.sin(yaw), 0.0]
    angle = math.degrees(math.atan2(math.sin(yaw), math.cos(yaw)))
    if angle < 0:
        angle += 360.0
    can_bus[-2] = math.radians(angle)
    can_bus[-1] = angle
    return can_bus


class SyntheticVideo:
    """Frames of `scene_lengths[i]` consecutive frames per scene, served by
    `get_test_sample` like the dataset's test samples.

    Images are uniform noise in [0, 255] per pixel minus the config's mean,
    divided by its std, made on `device` from `seed`; the rigs are those
    of `camera_rigs` at the raw image size (padding to `img_size` adds
    rows at the bottom and leaves the projection as it is)."""

    def __init__(self, cfg, scene_lengths: Sequence[int] = (3, 1), seed: int = 0,
                 device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.seed = seed
        rng = np.random.RandomState(seed)
        raw_h, raw_w = cfg.data.resized_size
        self.lidar2img = rig_lidar2img(raw_w, raw_h)[: cfg.data.num_cams]
        self.frames: List[dict] = []
        for s, n in enumerate(scene_lengths):
            yaw0 = rng.uniform(-np.pi, np.pi)
            speed = rng.uniform(3, 8)
            for t in range(n):
                dt = 0.5 * t
                yaw = yaw0 + 0.05 * t
                pos = [100.0 * s + speed * dt * np.cos(yaw), speed * dt * np.sin(yaw), 0.0]
                self.frames.append(dict(
                    token=f"scene_{s:04d}_f{t:03d}",
                    scene_token=f"scene_{s:04d}",
                    can_bus=can_bus_pose(pos, yaw, speed),
                ))

    def __len__(self) -> int:
        return len(self.frames)

    def images(self, index: int) -> torch.Tensor:
        """[cams, H, W, 3] normalised float32 noise for frame `index`."""
        d = self.cfg.data
        h, w = d.img_size
        gen = torch.Generator(device=self.device).manual_seed(self.seed * 100003 + index)
        img = torch.rand((d.num_cams, h, w, 3), generator=gen, device=self.device) * 255.0
        mean = torch.tensor(d.mean, device=self.device)
        std = torch.tensor(d.std, device=self.device)
        return (img - mean) / std

    def get_test_sample(self, index: int) -> dict:
        f = self.frames[index]
        return dict(
            token=f["token"],
            scene_token=f["scene_token"],
            can_bus=f["can_bus"].copy(),
            lidar2img=self.lidar2img.copy(),
            images=self.images(index),
        )
