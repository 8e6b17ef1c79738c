"""BEVFormerV2's image augmentation, test setting: the fixed crop, the
resize to the ladder's height and the flip, with the camera matrices
updated by the 3x3 image-augmentation matrix `ida`.

Port of `bevformer_tpu/data/pipeline_v2.py::sample_crop_resize_flip` (:23)
and `crop_resize_flip` (:46) (reference `datasets/pipelines/
augmentation.py:162-201`). At test time the 640-row crop of a 900-row
nuScenes camera is resized to 640 rows, which is the identity: the port
crops. A resize that is not the identity raises: the JAX package resizes
with PIL, whose filter the port does not reproduce yet (ROADMAP.md §1 item
7, the V2 training slice). The flip is not folded into `ida`: the detector
flips its features instead.
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
    imgs: np.ndarray,  # [cams, H, W, 3] uint8 BGR
    cam2img: np.ndarray,  # [cams, 4, 4] (viewpad intrinsics)
    lidar2cam: np.ndarray,  # [cams, 4, 4]
    params: Dict,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(the cropped, resized and flipped images [cams, rh, rw, 3] uint8,
    cam2img with `ida` applied (float64), lidar2img = cam2img @ lidar2cam
    (float64))."""
    x0, y0, x1, y1 = params["crop"]
    rw, rh = params["resize_dims"]
    if (rw, rh) != (x1 - x0, y1 - y0):
        raise NotImplementedError(
            f"V2 resize of the {x1 - x0} x {y1 - y0} crop to {rw} x {rh}: only the identity "
            "resize of the test setting is ported (ROADMAP.md §1 item 7)")
    if y1 > imgs.shape[1] or x1 > imgs.shape[2]:
        raise ValueError(f"crop {params['crop']} outside images of {imgs.shape[1:3]}")
    out = imgs[:, y0:y1, x0:x1]
    if params["flip"]:
        out = out[:, :, ::-1]
    ida = ida_matrix(params)
    cam2img = np.array(cam2img, np.float64)
    cam2img[:, :3, :3] = ida @ cam2img[:, :3, :3]
    lidar2img = np.stack([c @ np.asarray(l) for c, l in zip(cam2img, lidar2cam)])
    return np.ascontiguousarray(out), cam2img, lidar2img
