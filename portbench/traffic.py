"""The benchmark's inputs, made from `--seed`: camera rigs, seeded noise
images on the device, ego trajectories and their CAN-bus packing, and
ground-truth boxes.

A frozen copy of `bevformer_torch/data/synth.py`'s generators at commit
05c7fb4 (`camera_rigs`, `rig_lidar2img`, `can_bus_pose`, `_noise_images`,
`_gt_boxes`, `train_batch`) and of `data/dataset.py::lidar2img_from_cam_info`
and `data/dataset_v2.py`'s history-frame projection, with the images made
in a few large calls on the device. The sizes and arrivals of a mix come
from its traffic file (`portbench/traffic/<name>.json`); the seed changes
the pixels, the poses and the boxes, never the shapes or the count.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

CAM_YAWS = (0.0, -math.pi / 3, math.pi / 3, math.pi, 2 * math.pi / 3, -2 * math.pi / 3)
NUM_CLASSES = 10


def seed32(*parts: int) -> int:
    """A 32-bit seed from any whole numbers (a seed may pass 2**32)."""
    return int(np.random.SeedSequence([int(p) % (1 << 63) for p in parts]).generate_state(1)[0])


def generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed32(seed, salt))


def camera_rigs(img_w: int, img_h: int) -> List[dict]:
    """Six cameras looking out radially from 1.5 m off the lidar, 1.6 m up
    (front, front right, front left, back, back left, back right)."""
    f = 0.8 * img_w
    intrinsic = np.array([[f, 0, img_w / 2], [0, f, img_h / 2], [0, 0, 1]], np.float64)
    # the camera axes (x right, y down, z forward) in lidar coordinates
    axes = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
    rigs = []
    for yaw in CAM_YAWS:
        cy, sy = math.cos(yaw), math.sin(yaw)
        heading = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float64)
        rigs.append(dict(rotation=heading @ axes, translation=np.array([1.5 * cy, 1.5 * sy, 1.6]),
                         intrinsic=intrinsic))
    return rigs


def lidar2img(rig: dict, crop_top: float = 0.0) -> np.ndarray:
    """viewpad @ lidar2cam of one rig; `crop_top` image rows cut off the top."""
    l2c_r = np.linalg.inv(rig["rotation"])
    l2c_t = rig["translation"] @ l2c_r.T
    rt = np.eye(4)
    rt[:3, :3] = l2c_r.T
    rt[3, :3] = -l2c_t
    viewpad = np.eye(4)
    viewpad[:3, :3] = rig["intrinsic"]
    viewpad[1, 2] -= crop_top
    return viewpad @ rt.T


def rig_lidar2img(img_w: int, img_h: int, cams: int, crop_top: float = 0.0) -> np.ndarray:
    """[cams, 4, 4] of the rigs of an img_w x img_h camera."""
    return np.stack([lidar2img(r, crop_top) for r in camera_rigs(img_w, img_h)[:cams]])


def can_bus_pose(pos: Sequence[float], yaw: float, speed: float) -> np.ndarray:
    """The dataset's CAN-bus packing: translation, quaternion about z,
    velocity, yaw in radians and in degrees in [0, 360)."""
    cb = np.zeros(18)
    cb[:3] = pos
    cb[3:7] = [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]
    cb[7:10] = [speed * math.cos(yaw), speed * math.sin(yaw), 0.0]
    angle = math.degrees(math.atan2(math.sin(yaw), math.cos(yaw)))
    if angle < 0:
        angle += 360.0
    cb[-2] = math.radians(angle)
    cb[-1] = angle
    return cb


def scene_poses(rng: np.random.RandomState, frames: int, origin=(0.0, 0.0)):
    """(pos [frames, 3], yaw [frames]) of an ego at 3-8 m/s turning 0.05 rad
    a frame, frames 0.5 s apart (nuScenes' 2 Hz keyframes)."""
    yaw0, speed = rng.uniform(-math.pi, math.pi), rng.uniform(3, 8)
    t = np.arange(frames) * 0.5
    yaw = yaw0 + 0.05 * np.arange(frames)
    pos = np.stack([origin[0] + speed * t * np.cos(yaw), origin[1] + speed * t * np.sin(yaw),
                    np.zeros(frames)], 1)
    return pos, yaw, speed


def can_bus_deltas(pos, yaw, speed) -> np.ndarray:
    """[frames, 18] CAN bus of one scene as the evaluator and the training
    queue hand it over: each frame's translation and yaw in degrees minus
    the previous frame's, zero at the scene's first frame."""
    out = np.zeros((len(yaw), 18), np.float32)
    for t in range(len(yaw)):
        cb = can_bus_pose(pos[t], yaw[t], speed)
        if t == 0:
            cb[:3] = 0
            cb[-1] = 0
        else:
            prev = can_bus_pose(pos[t - 1], yaw[t - 1], speed)
            cb[:3] -= prev[:3]
            cb[-1] -= prev[-1]
        out[t] = cb
    return out


def ego_pose(pos, yaw) -> np.ndarray:
    """4x4 ego-to-global of a planar pose."""
    m = np.eye(4)
    c, s = math.cos(yaw), math.sin(yaw)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = pos
    return m


def history_lidar2img(l2i: np.ndarray, pose_cur: np.ndarray, pose_adj: np.ndarray) -> np.ndarray:
    """A history frame's cameras in the current frame's lidar coordinates:
    l2i @ inv(rel), rel = inv(pose_cur) @ pose_adj (lidar = ego)."""
    rel = np.linalg.inv(pose_cur) @ pose_adj
    return np.stack([m @ np.linalg.inv(rel) for m in l2i])


def noise_images(n: int, cams: int, h: int, w: int, mean, std, gen: torch.Generator,
                 device) -> torch.Tensor:
    """[n, cams, h, w, 3] uniform noise in [0, 255] minus `mean`, over
    `std` (the data pipeline's normalisation), frame by frame on the
    device."""
    out = torch.empty((n, cams, h, w, 3), device=device)
    m = torch.tensor(mean, device=device)
    s = torch.tensor(std, device=device)
    for i in range(n):
        torch.rand((cams, h, w, 3), generator=gen, device=device, out=out[i])
        out[i].mul_(255.0).sub_(m).div_(s)
    return out


def gt_boxes(rng: np.random.RandomState, count: int, pad: int):
    """`count` boxes [pad, 9] (centre x, y in [-40, 40] m, gravity-centre z
    in [-1.5, 0.5] m, w/l/h |N(0, 1)| * 0.8 + (1.9, 4.5, 1.7) m, yaw,
    velocity N(0, 0.5^2) m/s) and labels [pad], zero-padded."""
    boxes = np.zeros((pad, 9), np.float32)
    labels = np.zeros((pad,), np.int64)
    n = count
    boxes[:n, 0:2] = rng.uniform(-40, 40, (n, 2))
    boxes[:n, 2] = rng.uniform(-1.5, 0.5, n)
    boxes[:n, 3:6] = np.abs(rng.randn(n, 3)) * 0.8 + np.array([1.9, 4.5, 1.7])
    boxes[:n, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[:n, 7:9] = rng.randn(n, 2) * 0.5
    labels[:n] = rng.randint(0, NUM_CLASSES, n)
    return boxes, labels


def train_queue(rng: np.random.RandomState, frames: int, scene_break_at: Optional[int]):
    """(can_bus [frames, 18], prev_exists [frames]) of a training queue;
    the frame `scene_break_at` starts a new scene."""
    can = np.zeros((frames, 18), np.float32)
    prev_exists = np.zeros((frames,), bool)
    prev = None
    for t in range(frames):
        new = t == 0 or t == scene_break_at
        if new:
            start, yaw0, speed = t, rng.uniform(-np.pi, np.pi), rng.uniform(3, 8)
            origin = rng.uniform(-500, 500, 2)
        dt = 0.5 * (t - start)
        yaw = yaw0 + 0.05 * (t - start)
        cb = can_bus_pose([origin[0] + speed * dt * math.cos(yaw),
                           origin[1] + speed * dt * math.sin(yaw), 0.0], yaw, speed)
        cur = cb[:3].copy(), cb[-1]
        if new:
            cb[:3] = 0
            cb[-1] = 0
        else:
            prev_exists[t] = True
            cb[:3] -= prev[0]
            cb[-1] -= prev[1]
        prev = cur
        can[t] = cb
    return can, prev_exists
