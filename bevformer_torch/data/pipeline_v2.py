"""BEVFormerV2's augmentation on the host: the image side (the fixed crop,
the resize to a height of the ladder and the flip, with the camera matrices
updated by the 3x3 image-augmentation matrix `ida`) and the ground-truth
side (GlobalRotScaleTrans in only_gt mode, with the BEV unwarp matrix the
network applies).

Port of `bevformer_tpu/data/pipeline_v2.py` (reference `datasets/
pipelines/augmentation.py`):
  * `sample_crop_resize_flip` (:23) and `crop_resize_flip` (:46): each
    image clipped to [0, 255] and truncated to uint8, cropped and resized by
    PIL with its default filter, flipped left-right by PIL, as the JAX
    package does. The flip is not folded into `ida`: the detector flips its
    features instead (`bevformerV2.py:102-104`);
  * `transform_box2d` (:79): a 2D box through the crop and the resize; the
    flip is ignored on purpose, as the JAX package (and the reference)
    ignore it;
  * `sample_global_rot_scale_flip` (:92) and `global_rot_scale_trans_gt`
    (:122): mmdet3d's LiDARInstance3DBoxes rotate, scale and flip on the
    GT boxes, and the inverse matrix the BEV is sampled back through.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

# the nuScenes crop (x0, y0, x1, y1) of the V2 configs
CROP = (0, 260, 1600, 900)


def sample_crop_resize_flip(
    rng: np.random.RandomState,
    resize_ladder: Sequence[int] = (512, 544, 576, 608, 640, 672, 704, 736, 768),
    crop: Tuple[int, int, int, int] = CROP,
    rand_flip: bool = True,
    training: bool = True,
) -> Dict:
    """The augmentation parameters of a sample, drawn from `rng` as the JAX
    package draws them: a height from the ladder (its first at test time)
    and a flip (never at test time)."""
    resized_h = resize_ladder[rng.randint(len(resize_ladder))] if training else resize_ladder[0]
    resize = resized_h / (crop[3] - crop[1])
    resized_w = int(resize * (crop[2] - crop[0]))
    flip = bool(training and rand_flip and rng.randint(2))
    return dict(resize=resize, resize_dims=(resized_w, int(resized_h)), crop=crop, flip=flip)


def ida_matrix(params: Dict) -> np.ndarray:
    """3x3 float64: the crop's shift, then the resize."""
    resize, crop = params["resize"], params["crop"]
    ida = np.eye(3)
    ida[0, 0] = ida[1, 1] = resize
    ida[:2, 2] = -np.asarray(crop[:2], np.float64) * resize
    return ida


def crop_resize_flip(
    imgs: np.ndarray,  # [cams, H, W, 3] BGR, uint8 or float
    cam2img: np.ndarray,  # [cams, 4, 4] (viewpad intrinsics)
    lidar2cam: np.ndarray,  # [cams, 4, 4]
    params: Dict,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(the cropped, resized and flipped images [cams, rh, rw, 3] uint8,
    cam2img with `ida` applied (float64), lidar2img = cam2img @ lidar2cam
    (float64))."""
    from PIL import Image

    x0, y0, x1, y1 = params["crop"]
    if y1 > imgs.shape[1] or x1 > imgs.shape[2]:
        raise ValueError(f"crop {params['crop']} outside images of {imgs.shape[1:3]}")
    rw, rh = params["resize_dims"]
    out = np.empty((len(imgs), rh, rw, 3), np.uint8)
    for i, im in enumerate(imgs):
        pil = Image.fromarray(np.uint8(np.clip(im, 0, 255)))
        pil = pil.crop(params["crop"]).resize((rw, rh))
        if params["flip"]:
            pil = pil.transpose(method=Image.FLIP_LEFT_RIGHT)
        out[i] = np.asarray(pil)
    ida = ida_matrix(params)
    cam2img = np.array(cam2img, np.float64)
    cam2img[:, :3, :3] = ida @ cam2img[:, :3, :3]
    lidar2img = np.stack([c @ np.asarray(l) for c, l in zip(cam2img, lidar2cam)])
    return out, cam2img, lidar2img


def transform_box2d(box_xyxy: np.ndarray, params: Dict) -> np.ndarray:
    """A 2D box (x0, y0, x1, y1) through the crop and the resize, clipped
    to the resized image; the flip is ignored (`augmentation.py:142-160`)."""
    resize, crop = params["resize"], params["crop"]
    b = np.asarray(box_xyxy, np.float64).copy()
    b[[0, 2]] = (b[[0, 2]] - crop[0]) * resize
    b[[1, 3]] = (b[[1, 3]] - crop[1]) * resize
    rw, rh = params["resize_dims"]
    return np.clip(b, 0, [rw, rh, rw, rh])


def sample_global_rot_scale_flip(
    rng: np.random.RandomState,
    rot_range=(-22.5, 22.5),
    scale_ratio_range=(0.95, 1.05),
    flip_dx_ratio=0.5,
    flip_dy_ratio=0.5,
) -> Dict:
    """GlobalRotScaleTrans's draws, in the JAX package's order (rotation,
    scale, the two flips), and `bda_mat`, the inverse of flip @ scale @
    rotation (3x3 float64)."""
    rot_angle = rng.uniform(*rot_range) / 180.0 * np.pi
    scale_ratio = rng.uniform(*scale_ratio_range)
    flip_dx = rng.uniform() < flip_dx_ratio
    flip_dy = rng.uniform() < flip_dy_ratio
    c, s = np.cos(rot_angle), np.sin(rot_angle)
    rot_mat = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    flip_mat = np.eye(3)
    if flip_dx:
        flip_mat = flip_mat @ np.diag([-1.0, 1.0, 1.0])
    if flip_dy:
        flip_mat = flip_mat @ np.diag([1.0, -1.0, 1.0])
    bda_mat = np.linalg.inv(flip_mat @ (np.eye(3) * scale_ratio) @ rot_mat)
    return dict(rot_angle=rot_angle, scale_ratio=scale_ratio, flip_dx=flip_dx,
                flip_dy=flip_dy, bda_mat=bda_mat)


# GlobalRotScaleTrans switched off (t1-base, and every test sample)
NO_BDA = dict(rot_angle=0.0, scale_ratio=1.0, flip_dx=False, flip_dy=False, bda_mat=np.eye(3))


def global_rot_scale_trans_gt(
    boxes9: np.ndarray,  # [G, 9] bottom-z lidar boxes (x, y, z, w, l, h, yaw, vx, vy)
    params: Dict,
    reverse_angle: bool = True,
) -> np.ndarray:
    """GlobalRotScaleTrans (only_gt) on the GT boxes, float32: rotate the
    centres and velocities and add the angle to the yaw, scale centres,
    sizes and velocities, then flip x (`bev_direction='vertical'`) and y
    (`'horizontal'`)."""
    b = np.array(boxes9, np.float64).copy()
    rot = params["rot_angle"] * (-1.0 if reverse_angle else 1.0)
    c, s = np.cos(rot), np.sin(rot)
    rot_mat_t = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    b[:, :3] = b[:, :3] @ rot_mat_t
    b[:, 6] += rot
    b[:, 7:9] = b[:, 7:9] @ rot_mat_t[:2, :2]
    sr = params["scale_ratio"]
    b[:, :6] *= sr
    b[:, 7:9] *= sr
    if params["flip_dx"]:
        b[:, 0] = -b[:, 0]
        b[:, 6] = -b[:, 6] - np.pi
        b[:, 7] = -b[:, 7]
    if params["flip_dy"]:
        b[:, 1] = -b[:, 1]
        b[:, 6] = -b[:, 6]
        b[:, 8] = -b[:, 8]
    return b.astype(np.float32)
