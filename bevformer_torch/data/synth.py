"""Synthetic video frames for the inference path, and synthetic training
batches.

Camera rigs and `lidar2img` are ports of
`bevformer_tpu/data/synth.py::_camera_rigs` and
`bevformer_tpu/data/dataset.py::lidar2img_from_cam_info`. The frames are
seeded noise images, already normalised as the data pipeline would
(caffe-style mean subtraction), with CAN-bus poses along a smooth ego
trajectory packed as the dataset packs them. `train_batch` makes one
training sample in the layout of `runtime.train.Batch`, with ground-truth
boxes placed as `bevformer_tpu/data/synth.py::generate` places objects.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bevformer_torch.device import DEFAULT as DEFAULT_DEVICE
from bevformer_torch.device import resolve as resolve_device
from bevformer_torch.runtime.train import Batch

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


def _noise_images(cfg, n: int, seed: int, device) -> torch.Tensor:
    """[n, cams, H, W, 3]: uniform noise in [0, 255] minus the config's
    mean, over its std."""
    d = cfg.data
    h, w = d.img_size
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.rand((n, d.num_cams, h, w, 3), generator=gen, device=device) * 255.0
    return (img - torch.tensor(d.mean, device=device)) / torch.tensor(d.std, device=device)


NUM_OBJECTS = 12  # GT boxes per training sample (`generate`'s default)


def train_batch(cfg, seed: int = 0, device=DEFAULT_DEVICE,
                scene_break_at: Optional[int] = None) -> Batch:
    """One seeded training sample (batch 1) of `cfg.data.queue_length`
    frames: noise images, the six rigs' `lidar2img`, CAN-bus deltas of one
    moving ego pose in the dataset's union2one packing, and `NUM_OBJECTS`
    GT boxes in the last frame's ego frame, padded to `cfg.max_gt`.

    Boxes lie inside `pc_range` (x, y in [-40, 40] m), with gravity-centre
    z in [-1.5, 0.5] m, w/l/h = |N(0, 1)| * 0.8 + (1.9, 4.5, 1.7) m, yaw in
    [-pi, pi), velocity N(0, 0.5^2) m/s and labels 0-9. `scene_break_at`:
    that frame starts a new scene (its `prev_exists` is false and its
    CAN-bus deltas restart from zero). Made on the card unless `device`
    says otherwise."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    t_len = cfg.data.queue_length
    raw_h, raw_w = cfg.data.resized_size
    l2i = rig_lidar2img(raw_w, raw_h)[: cfg.data.num_cams]

    can_bus = np.zeros((t_len, 18), np.float32)
    prev_exists = np.zeros((t_len,), bool)
    prev_pos = prev_angle = None
    for t in range(t_len):
        new_scene = t == 0 or t == scene_break_at
        if new_scene:
            start, yaw0, speed = t, rng.uniform(-np.pi, np.pi), rng.uniform(3, 8)
            origin = rng.uniform(-500, 500, 2)
        dt = 0.5 * (t - start)
        yaw = yaw0 + 0.05 * (t - start)
        pos = [origin[0] + speed * dt * np.cos(yaw), origin[1] + speed * dt * np.sin(yaw), 0.0]
        cb = can_bus_pose(pos, yaw, speed)
        # union2one (`nuscenes_dataset.py:58-84`)
        tmp_pos, tmp_angle = cb[:3].copy(), cb[-1]
        if new_scene:
            cb[:3] = 0
            cb[-1] = 0
        else:
            prev_exists[t] = True
            cb[:3] -= prev_pos
            cb[-1] -= prev_angle
        prev_pos, prev_angle = tmp_pos, tmp_angle
        can_bus[t] = cb

    g = cfg.max_gt
    n = min(NUM_OBJECTS, g)
    gt_boxes = np.zeros((g, 9), np.float32)
    gt_labels = np.zeros((g,), np.int64)
    gt_boxes[:n, 0:2] = rng.uniform(-40, 40, (n, 2))
    gt_boxes[:n, 2] = rng.uniform(-1.5, 0.5, n)
    gt_boxes[:n, 3:6] = np.abs(rng.randn(n, 3)) * 0.8 + np.array([1.9, 4.5, 1.7])
    gt_boxes[:n, 6] = rng.uniform(-np.pi, np.pi, n)
    gt_boxes[:n, 7:9] = rng.randn(n, 2) * 0.5
    gt_labels[:n] = rng.randint(0, 10, n)

    def dev(a, dtype=None):
        return torch.as_tensor(np.array(a)[None], dtype=dtype, device=device)

    return Batch(
        images=_noise_images(cfg, t_len, seed, device)[None],
        can_bus=dev(can_bus, torch.float32),
        lidar2img=dev(np.broadcast_to(l2i, (t_len,) + l2i.shape), torch.float32),
        prev_exists=dev(prev_exists),
        gt_boxes=dev(gt_boxes, torch.float32),
        gt_labels=dev(gt_labels),
        num_gt=torch.tensor([n], device=device),
    )


class SyntheticVideo:
    """Frames of `scene_lengths[i]` consecutive frames per scene, served by
    `get_test_sample` like the dataset's test samples.

    Images are uniform noise in [0, 255] per pixel minus the config's mean,
    divided by its std, made on `device` (the card unless the caller asks
    for another) from `seed`; the rigs are those
    of `camera_rigs` at the raw image size (padding to `img_size` adds
    rows at the bottom and leaves the projection as it is)."""

    def __init__(self, cfg, scene_lengths: Sequence[int] = (3, 1), seed: int = 0,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
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
        return _noise_images(self.cfg, 1, self.seed * 100003 + index, self.device)[0]

    def get_test_sample(self, index: int) -> dict:
        f = self.frames[index]
        return dict(
            token=f["token"],
            scene_token=f["scene_token"],
            can_bus=f["can_bus"].copy(),
            lidar2img=self.lidar2img.copy(),
            images=self.images(index),
        )
