"""BEVFormerV2's training samples and `tools.train`'s V2 path in the port,
on the CPU.

A synthetic nuScenes-format root (`create_data synth`) of 4 scenes x 3
frames at 64 x 900 (the train split: two scenes of three frames), read at
`raw_size` (640, 64): the V2 crop below row 260, then the resize ladder.

* `get_train_sample_v2` equals the JAX package's (images, lidar2img,
  frame_valid, flip, bda_mat, the GlobalRotScaleTrans'd GT, the DD3D
  targets) at every index, for frames (0,) and (-1, 0), with and without
  GlobalRotScaleTrans, drawing from one `RandomState` in the same order
  (both generators end in the same state), on ladders of rungs up to 640
  rows, where JAX runs. With the photometric distortion off the images
  are bitwise JAX's; with it on, the port's float32 distortion (within
  1e-3 of cv2's on the 0-255 scale, `tests/test_torch_data.py`) truncates
  to uint8 on the other side of an integer at a few pixels: those move by
  one grey level, which PIL's bicubic resize spreads to their neighbours
  (up to 3 levels at 0-0.5% of the values, where JAX's draws were made).
* Above 640 rows JAX's pad raises; the port's images and lidar2img there
  equal JAX's `crop_resize_flip` of the same cameras, padded to each
  axis's larger of `img_size` and the resized size rounded up to 32.
* `tools.train bevformerv2-r50-t1` (R10, 8 x 8 BEV, 1 + 2 layers, 12
  queries x 11 groups, DD3D) runs 2 steps, resumes to 3, and ends on the
  weights, statistics and optimizer of an unbroken 3-step run, bitwise.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from bevformer_tpu.configs import get_config as jax_get_config
from bevformer_tpu.data import pipeline_v2 as jax_pipeline_v2
from bevformer_tpu.data.dataset_v2 import NuScenesTemporalDatasetV2 as JaxDatasetV2
from bevformer_torch.data import CAM_ORDER, NuScenesTemporalDatasetV2
from bevformer_torch.data.dataset_v2 import pad_size
from bevformer_torch.data.image_io import read_image
from bevformer_torch.tools import create_data, train as train_cli
from tests.torch_port_helpers import port_config

RAW = (640, 64)
LOW_LADDER = (512, 544, 576, 608, 640)
MINI = dict(backbone_depth=10, bev_h=8, bev_w=8, encoder_layers=1, decoder_layers=2,
            num_query=12)
OPTIONS = [f"{k}={v}" for k, v in MINI.items()] + [f"data.raw_size=({RAW[0]},{RAW[1]})"]
FLOAT_KEYS_TOL = 1e-6


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("v2_train_root"))
    create_data.main(["synth", "--out-dir", out, "--scenes", "4", "--frames", "3",
                      "--objects", "6", "--img-w", str(RAW[1]), "--img-h", "900"])
    return out


def _pair(root, frames, seed, **data):
    jcfg = jax_get_config("bevformerv2-r50-t1")
    jcfg = jcfg.replace(frames=frames, data=dataclasses.replace(jcfg.data, raw_size=RAW, **data))
    ann = os.path.join(root, "nuscenes_infos_temporal_train.pkl")
    ref = JaxDatasetV2(ann, jcfg, data_root=root, seed=seed)
    ours = NuScenesTemporalDatasetV2(ann, port_config(jcfg), data_root=root, seed=seed,
                                     device="cpu")
    return ref, ours


def _check_fields(ours, ref):
    assert sorted(ours) == sorted(ref)
    for key, val in ref.items():
        if key == "images":
            continue
        a = ours[key]
        if isinstance(val, str):
            assert a == val, key
        elif np.asarray(val).dtype.kind == "f":
            np.testing.assert_allclose(a, val, rtol=FLOAT_KEYS_TOL, atol=FLOAT_KEYS_TOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(a, val, err_msg=key)


@pytest.mark.parametrize("frames,seed,grst", [((0,), 0, True), ((-1, 0), 1, True),
                                              ((-1, 0), 2, False)],
                         ids=["t1", "t2", "t2_no_grst"])
def test_train_samples_equal_jax(root, frames, seed, grst):
    """Photometric distortion off: every field equal, the images bitwise."""
    ref_ds, ds = _pair(root, frames, seed, v2_resize_ladder=LOW_LADDER, v2_use_grst=grst,
                       use_photometric=False)
    flips, grst_flips = set(), set()
    for index in list(range(len(ds))) * 2:
        ref, ours = ref_ds.get_train_sample_v2(index), ds.get_train_sample_v2(index)
        assert (ref is None) == (ours is None)
        if ref is None:
            continue
        _check_fields(ours, ref)
        assert isinstance(ours["images"], torch.Tensor)
        assert torch.equal(ours["images"], torch.from_numpy(ref["images"]))
        flips.add(bool(ours["flip"]))
        grst_flips.add(float(ours["bda_mat"][0, 0]) < 0)
    assert flips == {False, True}
    assert grst_flips == ({False, True} if grst else {False})
    # the same draws: both generators end in the same state
    assert ref_ds.rng.randint(1 << 30) == ds.rng.randint(1 << 30)


def test_train_samples_with_photometric_distortion(root):
    """Photometric distortion on: every field but the images equal; the
    images within 3 grey levels of JAX's (the caffe normalisation divides
    by 1) at under 1% of the values, and equal elsewhere (a draw of the
    wrong size moves every pixel by up to 32 levels)."""
    ref_ds, ds = _pair(root, (-1, 0), 3, v2_resize_ladder=LOW_LADDER)
    assert ds.dcfg.use_photometric and ds.dcfg.std == (1.0, 1.0, 1.0)
    for index in range(len(ds)):
        ref, ours = ref_ds.get_train_sample_v2(index), ds.get_train_sample_v2(index)
        assert (ref is None) == (ours is None)
        if ref is None:
            continue
        _check_fields(ours, ref)
        diff = np.abs(ours["images"].numpy() - ref["images"])
        assert diff.max() <= 3.0 + 1e-4, index
        assert (diff > 1e-4).mean() < 1e-2, index
    assert ref_ds.rng.randint(1 << 30) == ds.rng.randint(1 << 30)


@pytest.mark.parametrize("rung", [672, 736, 768])
def test_rungs_above_640_rows(root, rung):
    """JAX's pad into `img_size` raises there; the port's sample holds
    JAX's `crop_resize_flip` of the cameras, normalised, padded with zeros
    to the pad rule."""
    _, ds = _pair(root, (0,), 0, v2_resize_ladder=(rung,), use_photometric=False)
    sample = ds.get_train_sample_v2(1)
    assert sample is not None
    params = dict(resize=rung / 640, resize_dims=(int(rung / 640 * RAW[1]), rung),
                  crop=(0, 260, RAW[1], 900), flip=bool(sample["flip"]))
    assert pad_size(ds.dcfg, params) == (rung, -(-params["resize_dims"][0] // 32) * 32)
    cams = ds.infos[1]["cams"]
    names = [c for c in CAM_ORDER if c in cams]
    imgs = [read_image(os.path.join(ds.data_root, cams[c]["data_path"])).astype(np.float32)
            for c in names]
    l2c, c2i = [], []
    for c in names:
        ci = cams[c]
        r = np.linalg.inv(ci["sensor2lidar_rotation"])
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = r, -(ci["sensor2lidar_translation"] @ r.T)
        l2c.append(m)
        k = np.eye(4)
        k[:3, :3] = ci["cam_intrinsic"]
        c2i.append(k)
    out, _, l2i = jax_pipeline_v2.crop_resize_flip(imgs, np.stack(c2i), np.stack(l2c), params)
    want = (np.stack(out) - np.asarray(ds.dcfg.mean, np.float32)) / np.asarray(ds.dcfg.std,
                                                                               np.float32)
    images = sample["images"][0].numpy()
    rw = params["resize_dims"][0]
    assert images.shape[1:3] == pad_size(ds.dcfg, params)
    np.testing.assert_array_equal(images[:, :rung, :rw], want)
    assert not images[:, :, rw:].any()
    np.testing.assert_allclose(sample["lidar2img"][0], l2i, rtol=1e-6, atol=1e-6)


def _train(root, work, steps, *more):
    return train_cli.main(["bevformerv2-r50-t1", "--data-root", root, "--work-dir", work,
                           "--max-iters", str(steps), "--log-interval", "1", "--device", "cpu",
                           *more, "--cfg-options", *OPTIONS])


def test_tools_train_v2_resumes_as_an_unbroken_run(root, tmp_path):
    whole = str(tmp_path / "whole")
    split = str(tmp_path / "split")
    done = _train(root, whole, 3)
    assert done["steps"] == 3 and done["last"]["step"] == 2
    assert sum(k.endswith("_mono") for k in done["last"]) == 10
    _train(root, split, 2)
    resumed = _train(root, split, 3, "--resume-from", os.path.join(split, "ckpts", "iter_2.pth"))
    assert resumed["steps"] == 1
    with open(os.path.join(split, "train_log.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1, 2]
    a = torch.load(os.path.join(whole, "ckpts", "iter_3.pth"), weights_only=True)
    b = torch.load(os.path.join(split, "ckpts", "iter_3.pth"), weights_only=True)
    assert sum(k.startswith("fcos3d_bbox_head.") for k in a["state_dict"]) > 100
    for key, val in a["state_dict"].items():
        assert torch.equal(val, b["state_dict"][key]), key
    for sa, sb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
    assert resumed["last"]["total"] == done["last"]["total"]
