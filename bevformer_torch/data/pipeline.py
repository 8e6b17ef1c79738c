"""Image preprocessing on the images' device (the card unless the caller
asks for another).

Port of `bevformer_tpu/data/pipeline.py`, which runs the reference
pipelines (`datasets/pipelines/transform_3d.py`) in numpy and cv2:
  * PhotoMetricDistortionMultiViewImage (train-time colour jitter): the
    random draws are numpy `RandomState` calls on the host, made in the JAX
    package's order; the arithmetic is torch, with cv2's float32
    BGR<->HSV conversions written out (`bgr_to_hsv`, `hsv_to_bgr`);
  * NormalizeMultiviewImage (mean/std, optional BGR->RGB);
  * RandomScaleImageMultiViewImage (one fixed scale, bilinear as cv2's
    INTER_LINEAR, and lidar2img scaled with it);
  * PadMultiViewImage (zeros up to `img_size`).

Images are [cams, H, W, 3] in BGR order, as cv2 loads them, and come out
normalised float32 [cams, H, W, 3].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FLT_EPSILON = float(np.finfo(np.float32).eps)
# HSV2BGR's corner table: which of (v, v(1-s), v(1-s h), v(1-s(1-h))) is
# b, g and r in each of the six sectors (cv2's `sector_data`)
SECTORS = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))
# PhotoMetricDistortionMultiViewImage's defaults, the reference configs' values
BRIGHTNESS_DELTA = 32
CONTRAST_RANGE = (0.5, 1.5)
SATURATION_RANGE = (0.5, 1.5)
HUE_DELTA = 18


def bgr_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(float32, COLOR_BGR2HSV): H in [0, 360], S and V as cv2
    computes them for any float input (no clamp): V = max, S = (V - min) /
    (|V| + FLT_EPSILON), H = 60 (.) / (V - min + FLT_EPSILON) from the
    channel that holds the max (r, then g, then b), +360 where negative."""
    b, g, r = img.unbind(-1)
    v = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = v - vmin
    s = diff / (v.abs() + FLT_EPSILON)
    k = 60.0 / (diff + FLT_EPSILON)
    h = torch.where(v == r, (g - b) * k,
                    torch.where(v == g, (b - r) * k + 120.0, (r - g) * k + 240.0))
    h = torch.where(h < 0, h + 360.0, h)
    return torch.stack([h, s, v], -1)


def hsv_to_bgr(hsv: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(float32, COLOR_HSV2BGR) for H in degrees: h / 60
    wrapped into [0, 6), its floor the sector, the fraction h picks from
    the table (v, v(1-s), v(1-s h), v(1-s(1-h)))."""
    h, s, v = hsv.unbind(-1)
    h = h * (6.0 / 360.0)
    h = h - 6.0 * torch.floor(h / 6.0)
    sector = torch.floor(h)
    h = h - sector
    tab = torch.stack([v, v * (1.0 - s), v * (1.0 - s * h), v * (1.0 - s * (1.0 - h))], -1)
    table = torch.tensor(SECTORS, device=hsv.device)
    idx = table[sector.long().clamp_(0, 5)]
    return torch.gather(tab, -1, idx)


def photometric_draws(n: int, rng: np.random.RandomState) -> dict:
    """The random draws of PhotoMetricDistortionMultiViewImage
    (`transform_3d.py:98-195`) for `n` images, in the JAX package's order
    (`pipeline.py:44-63`): per image, brightness, the contrast mode,
    contrast before HSV (mode 1), saturation, hue, contrast after HSV (mode
    0), the channel permutation. A step not drawn gets its identity value
    (0 delta, x1, the identity permutation): adding 0 and multiplying by 1
    are exact in float32, so every image can take every step."""
    out = dict(delta=np.zeros(n), alpha_before=np.ones(n), sat=np.ones(n),
               hue=np.zeros(n), alpha_after=np.ones(n),
               perm=np.tile(np.arange(3), (n, 1)))
    for i in range(n):
        if rng.randint(2):
            out["delta"][i] = rng.uniform(-BRIGHTNESS_DELTA, BRIGHTNESS_DELTA)
        mode = rng.randint(2)
        if mode == 1 and rng.randint(2):
            out["alpha_before"][i] = rng.uniform(*CONTRAST_RANGE)
        if rng.randint(2):
            out["sat"][i] = rng.uniform(*SATURATION_RANGE)
        if rng.randint(2):
            out["hue"][i] = rng.uniform(-HUE_DELTA, HUE_DELTA)
        if mode == 0 and rng.randint(2):
            out["alpha_after"][i] = rng.uniform(*CONTRAST_RANGE)
        if rng.randint(2):
            out["perm"][i] = rng.permutation(3)
    return out


def photometric_distortion(imgs: torch.Tensor, rng: np.random.RandomState) -> torch.Tensor:
    """PhotoMetricDistortionMultiViewImage on float32 BGR [n, H, W, 3]:
    independent draws per image (`photometric_draws`), the arithmetic on
    the images' device in float32, as the JAX package's numpy and cv2 do."""
    d = photometric_draws(len(imgs), rng)

    def per_image(key):
        return torch.as_tensor(d[key], dtype=torch.float32, device=imgs.device).view(-1, 1, 1)

    img = (imgs + per_image("delta")[..., None]) * per_image("alpha_before")[..., None]
    h, s, v = bgr_to_hsv(img).unbind(-1)
    s = s * per_image("sat")
    h = h + per_image("hue")
    h = torch.where(h > 360.0, h - 360.0, h)
    h = torch.where(h < 0.0, h + 360.0, h)
    img = hsv_to_bgr(torch.stack([h, s, v], -1)) * per_image("alpha_after")[..., None]
    perm = torch.as_tensor(d["perm"], device=imgs.device).view(-1, 1, 1, 3)
    return torch.gather(img, -1, perm.expand_as(img))


def imresize_bilinear(imgs: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """[n, H, W, 3] -> [n, out_h, out_w, 3], bilinear with half-pixel
    centres and edge clamping: cv2.resize's INTER_LINEAR (mmcv.imresize)."""
    x = imgs.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1)


def preprocess_images(imgs: torch.Tensor, lidar2img: np.ndarray, cfg,
                      rng: Optional[np.random.RandomState] = None,
                      train: bool = False,
                      pad_to: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, np.ndarray]:
    """The per-frame pipeline on [cams, H, W, 3] BGR images (uint8 or
    float) on any device. Returns ([cams, *pad_to, 3] normalised float32 on
    the images' device, `pad_to` defaulting to `img_size`, and the scaled
    lidar2img [cams, 4, 4] float32)."""
    imgs = imgs.to(torch.float32)
    if train and cfg.use_photometric and rng is not None:
        imgs = photometric_distortion(imgs, rng)

    # normalise before scaling, in the reference pipeline's order
    if cfg.to_rgb:
        imgs = imgs.flip(-1)
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=imgs.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=imgs.device)
    imgs = (imgs - mean) / std

    # fixed single-scale resize and the lidar2img update (`transform_3d.py:291-330`)
    if cfg.scale != 1.0:
        rh, rw = cfg.resized_size
        imgs = imresize_bilinear(imgs, rw, rh)
        scale_mat = np.eye(4)
        scale_mat[0, 0] = scale_mat[1, 1] = cfg.scale
        lidar2img = np.asarray([scale_mat @ m for m in lidar2img])

    ph, pw = pad_to or cfg.img_size
    h, w = imgs.shape[1:3]
    if h > ph or w > pw:
        raise ValueError(f"images of {h} x {w} do not fit the pad to {ph} x {pw}")
    out = F.pad(imgs, (0, 0, 0, pw - w, 0, ph - h))
    return out.contiguous(), np.asarray(lidar2img, np.float32)
