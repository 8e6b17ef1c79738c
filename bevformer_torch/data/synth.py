"""The synthetic nuScenes-format dataset on disk, synthetic video frames
for the inference path, and synthetic training batches.

`generate` is the port of `bevformer_tpu/data/synth.py::generate`: the
same `RandomState` draws in the same order, the same pickled infos, and
camera images written as JPEG by cv2 (`data.image_io`), as the JAX package
writes them. Camera rigs are ports of `_camera_rigs`. The frames of
`SyntheticVideo` are seeded noise images, already normalised as the data
pipeline would (caffe-style mean subtraction), with CAN-bus poses along a
smooth ego trajectory packed as the dataset packs them. `train_batch`
makes one training sample in the layout of `runtime.train.Batch`, with
ground-truth boxes placed as `generate` places objects.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bevformer_torch.core.boxes import CLASS_NAMES
from bevformer_torch.core.evaluation import predict_attribute
from bevformer_torch.data.dataset import CAM_ORDER, lidar2img_from_cam_info
from bevformer_torch.data.image_io import write_image
from bevformer_torch.device import DEFAULT as DEFAULT_DEVICE
from bevformer_torch.device import resolve as resolve_device
from bevformer_torch.runtime.train import Batch


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


def rig_lidar2img(img_w=1600, img_h=900, rigs: Optional[Dict[str, dict]] = None) -> np.ndarray:
    """[6, 4, 4] lidar2img of the six rigs (default `camera_rigs`), in
    CAM_ORDER."""
    rigs = rigs or camera_rigs(img_w, img_h)
    return np.stack([
        lidar2img_from_cam_info(dict(
            sensor2lidar_rotation=rigs[c]["rotation"],
            sensor2lidar_translation=rigs[c]["translation"],
            cam_intrinsic=rigs[c]["intrinsic"],
        ))
        for c in CAM_ORDER
    ])


def _quat_about_z(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def generate(
    out_dir: str,
    num_scenes: int = 2,
    frames_per_scene: int = 8,
    num_objects: int = 12,
    img_w: int = 1600,
    img_h: int = 900,
    seed: int = 0,
) -> str:
    """Write `nuscenes_infos_temporal_{train,val}.pkl` (the converter's
    schema) and the camera images under `out_dir/samples/`. The geometry is
    consistent: box centres project through the rigs' pinhole intrinsics
    and extrinsics, the ego moves along a smooth trajectory and the CAN bus
    records its pose. The first half of the scenes (at least one) train, the
    rest validate."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(out_dir, "samples"), exist_ok=True)
    rigs = camera_rigs(img_w, img_h)

    infos: List[dict] = []
    for s in range(num_scenes):
        scene_token = f"scene_{s:04d}"
        # world objects scattered around the scene's ego start position
        obj_xy = rng.uniform(-40, 40, (num_objects, 2)) + np.array([100.0 * s, 0.0])
        obj_z = rng.uniform(-1.5, 0.5, num_objects)
        obj_wlh = np.abs(rng.randn(num_objects, 3)) * 0.8 + np.array([1.9, 4.5, 1.7])
        obj_yaw = rng.uniform(-np.pi, np.pi, num_objects)
        obj_cls = rng.randint(0, len(CLASS_NAMES), num_objects)
        obj_vel = rng.randn(num_objects, 2) * 0.5

        ego_yaw0 = rng.uniform(-np.pi, np.pi)
        speed = rng.uniform(3, 8)
        tokens = [f"{scene_token}_f{t:03d}" for t in range(frames_per_scene)]
        for t in range(frames_per_scene):
            dt = 0.5 * t
            yaw = ego_yaw0 + 0.05 * t
            pos = np.array([100 * s + speed * dt * np.cos(yaw), speed * dt * np.sin(yaw), 0.0])
            # objects moved by their velocity, in the current ego (lidar) frame
            world_xy = obj_xy + obj_vel * dt
            rel = np.concatenate([world_xy - pos[None, :2], obj_z[:, None]], axis=1)
            c, sn = np.cos(-yaw), np.sin(-yaw)
            rot2 = np.array([[c, -sn], [sn, c]])
            rel[:, :2] = rel[:, :2] @ rot2.T
            yaw_rel = obj_yaw - yaw
            vel_rel = obj_vel @ rot2.T

            keep = (np.abs(rel[:, 0]) < 52) & (np.abs(rel[:, 1]) < 52)
            gt_boxes = np.concatenate(
                [
                    rel[keep][:, :2],
                    (rel[keep][:, 2] - 0.5 * obj_wlh[keep][:, 2])[:, None],
                    obj_wlh[keep],
                    yaw_rel[keep][:, None],
                ],
                axis=1,
            )
            gt_names = [CLASS_NAMES[i] for i in obj_cls[keep]]
            gt_velocity = vel_rel[keep]
            # attributes from the true velocity by the rule the submission
            # writer applies to predictions: a perfect detector scores mAAE 0
            gt_attrs = np.array(
                [predict_attribute(n, v) for n, v in zip(gt_names, gt_velocity)], dtype=object
            )

            cams = {}
            for cname, rig in rigs.items():
                data_path = os.path.join("samples", f"{tokens[t]}_{cname}.jpg")
                cams[cname] = dict(
                    data_path=data_path,
                    type=cname,
                    cam_intrinsic=rig["intrinsic"],
                    sensor2lidar_rotation=rig["rotation"],
                    sensor2lidar_translation=rig["translation"],
                    timestamp=int((s * 1000 + dt) * 1e6),
                )
                write_image(os.path.join(out_dir, data_path),
                            render_image(rel[keep], obj_wlh[keep], rig, img_w, img_h, rng))

            can_bus = np.zeros(18)
            can_bus[:3] = pos
            can_bus[3:7] = _quat_about_z(yaw)
            can_bus[7:10] = [speed * np.cos(yaw), speed * np.sin(yaw), 0]
            infos.append(
                dict(
                    token=tokens[t],
                    scene_token=scene_token,
                    frame_idx=t,
                    prev="" if t == 0 else tokens[t - 1],
                    next="" if t == frames_per_scene - 1 else tokens[t + 1],
                    lidar_path="",
                    sweeps=[],
                    cams=cams,
                    ego2global_translation=pos.tolist(),
                    ego2global_rotation=_quat_about_z(yaw).tolist(),
                    lidar2ego_translation=[0, 0, 0],
                    lidar2ego_rotation=[1, 0, 0, 0],
                    timestamp=int((s * 1000 + dt) * 1e6),
                    can_bus=can_bus,
                    gt_boxes=gt_boxes.astype(np.float64),
                    gt_names=np.array(gt_names),
                    gt_attrs=gt_attrs,
                    gt_velocity=gt_velocity.astype(np.float64),
                    num_lidar_pts=np.full(len(gt_names), 10, np.int64),
                    num_radar_pts=np.zeros(len(gt_names), np.int64),
                    valid_flag=np.ones(len(gt_names), bool),
                )
            )

    n_train_scenes = max(1, int(num_scenes * 0.5))
    train_infos = [i for i in infos if int(i["scene_token"].split("_")[1]) < n_train_scenes]
    val_infos = [i for i in infos if i not in train_infos]
    meta = {"version": "v1.0-synth"}
    for split, split_infos in (("train", train_infos), ("val", val_infos)):
        with open(os.path.join(out_dir, f"nuscenes_infos_temporal_{split}.pkl"), "wb") as f:
            pickle.dump({"infos": split_infos, "metadata": meta}, f)
    return out_dir


def render_image(centers, wlh, rig, img_w, img_h, rng) -> np.ndarray:
    """uint8 [img_h, img_w, 3] BGR camera image: grey with an 8-pixel block
    noise texture, and a filled rectangle of a random colour over each box
    centre in front of the camera, its corners inclusive and clipped to the
    image (`cv2.rectangle(..., thickness=-1)`). The draws are those of
    `bevformer_tpu/data/synth.py::_render_image`, in its order."""
    img = np.full((img_h, img_w, 3), 90, np.uint8)
    # noise texture so the backbone sees structure
    noise = (rng.rand(-(-img_h // 8), -(-img_w // 8), 3)
             .repeat(8, 0).repeat(8, 1) * 40).astype(np.uint8)
    img += noise[:img_h, :img_w]
    rot, tr, intr = rig["rotation"], rig["translation"], rig["intrinsic"]
    cam_pts = (centers - tr[None]) @ rot  # lidar -> camera frame
    for p, dims in zip(cam_pts, wlh):
        if p[2] < 1.0:
            continue
        uv = intr @ p
        u, v = int(uv[0] / uv[2]), int(uv[1] / uv[2])
        if not (0 <= u < img_w and 0 <= v < img_h):
            continue
        size = max(4, int(800 * dims[0] / p[2]))
        color = [int(c) for c in rng.randint(60, 255, 3)]
        x0, x1 = max(u - size // 2, 0), min(u + size // 2, img_w - 1)
        y0, y1 = max(v - size // 2, 0), min(v + size // 2, img_h - 1)
        img[y0:y1 + 1, x0:x1 + 1] = color
    return img


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


def _noise_images(cfg, n: int, seed: int, device, size=None) -> torch.Tensor:
    """[n, cams, H, W, 3] ((H, W) = `size`, default `img_size`): uniform
    noise in [0, 255] minus the config's mean, over its std."""
    d = cfg.data
    h, w = size or d.img_size
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.rand((n, d.num_cams, h, w, 3), generator=gen, device=device) * 255.0
    return (img - torch.tensor(d.mean, device=device)) / torch.tensor(d.std, device=device)


NUM_OBJECTS = 12  # GT boxes per training sample (`generate`'s default)


def _gt_boxes(rng: np.random.RandomState, g: int):
    """`NUM_OBJECTS` GT boxes [g, 9] (gravity-centre z) and labels [g],
    padded to `g`, and their count (see `train_batch`)."""
    n = min(NUM_OBJECTS, g)
    gt_boxes = np.zeros((g, 9), np.float32)
    gt_labels = np.zeros((g,), np.int64)
    gt_boxes[:n, 0:2] = rng.uniform(-40, 40, (n, 2))
    gt_boxes[:n, 2] = rng.uniform(-1.5, 0.5, n)
    gt_boxes[:n, 3:6] = np.abs(rng.randn(n, 3)) * 0.8 + np.array([1.9, 4.5, 1.7])
    gt_boxes[:n, 6] = rng.uniform(-np.pi, np.pi, n)
    gt_boxes[:n, 7:9] = rng.randn(n, 2) * 0.5
    gt_labels[:n] = rng.randint(0, 10, n)
    return gt_boxes, gt_labels, n


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

    gt_boxes, gt_labels, n = _gt_boxes(rng, cfg.max_gt)

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


def train_batch_v2(cfg, seed: int = 0, device=DEFAULT_DEVICE, rung: int = 640):
    """One seeded BEVFormerV2 training sample (batch 1, `runtime.train_v2.
    BatchV2`) at the shapes `get_train_sample_v2` gives at the ladder height
    `rung`: for every offset of `cfg.frames` noise images at the rung's
    padded size, the six rigs' lidar2img through the V2 crop of a
    `raw_size` + 260-row camera and the resize; `train_batch`'s GT boxes;
    no flip, the identity unwarp; and the boxes' DD3D targets in the rigs'
    cameras (`dataset_v2.mono_targets`). Made on the card unless `device`
    says otherwise."""
    from bevformer_torch.data import dataset_v2, pipeline_v2
    from bevformer_torch.runtime.train_v2 import collate_v2

    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    raw_h, raw_w = cfg.data.raw_size
    ida = pipeline_v2.sample_crop_resize_flip(rng, resize_ladder=(rung,),
                                              crop=(0, 260, raw_w, raw_h + 260), training=False)
    ida_3x3 = pipeline_v2.ida_matrix(ida)
    rigs = [camera_rigs(raw_w, raw_h + 260)[c] for c in CAM_ORDER[: cfg.data.num_cams]]
    lidar2cam, cam2img = [], []
    for r in rigs:
        s2l = np.eye(4)
        s2l[:3, :3], s2l[:3, 3] = r["rotation"], r["translation"]
        lidar2cam.append(np.linalg.inv(s2l))
        k = np.eye(4)
        k[:3, :3] = ida_3x3 @ r["intrinsic"]
        cam2img.append(k)
    l2i = np.stack([k @ l for k, l in zip(cam2img, lidar2cam)]).astype(np.float32)
    gt_boxes, gt_labels, n = _gt_boxes(rng, cfg.max_gt)
    t = len(cfg.frames)
    sample = dict(
        images=_noise_images(cfg, t, seed, device, dataset_v2.pad_size(cfg.data, ida)),
        lidar2img=np.broadcast_to(l2i, (t,) + l2i.shape), frame_valid=np.ones((t,), bool),
        flip=np.bool_(False), bda_mat=np.eye(2, dtype=np.float32), gt_boxes=gt_boxes,
        gt_labels=gt_labels, num_gt=np.int64(n),
        **dataset_v2.mono_targets(gt_boxes[:n], gt_labels[:n], np.stack(lidar2cam),
                                  np.stack(cam2img), ida["resize_dims"], cfg.data.num_cams))
    return collate_v2([sample], device)


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
