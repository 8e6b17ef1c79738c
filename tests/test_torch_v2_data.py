"""BEVFormerV2's test data path and `tools.test` in the port, on the CPU.

A synthetic nuScenes-format root (`create_data synth`) of 4 scenes x 3
frames at 64 x 900 (the val split: two scenes of three frames), read at
`raw_size` (640, 64): the V2 crop below row 260 and the test setting's
resize to 640 rows, the identity.

* `get_test_sample_v2` equals the JAX package's (images, lidar2img,
  frame_valid, tokens) for frames (-1, 0) and (-2, -1, 0, 1): at index 0,
  inside a scene, and at a scene boundary, where the current frame fills
  in; a resize other than the identity raises.
* `tools.test bevformerv2-r50-t1-base` (R10, 8 x 8 BEV, 1 + 2 layers, 12
  queries) runs on the CPU over the val split with every BatchNorm in eval
  mode, writes the results, the submission and the metrics, and gives the
  same boxes with `--fuse-conv-bn`.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from bevformer_tpu.configs import get_config as jax_get_config
from bevformer_tpu.data.dataset_v2 import NuScenesTemporalDatasetV2 as JaxDatasetV2
from bevformer_torch.configs import get_config
from bevformer_torch.data import NuScenesTemporalDatasetV2, pipeline_v2
from bevformer_torch.tools import create_data, test as test_cli
from tests.test_torch_slice import _match_boxes
from tests.torch_port_helpers import port_config

RAW = (640, 64)
MINI = dict(backbone_depth=10, bev_h=8, bev_w=8, encoder_layers=1, decoder_layers=2,
            num_query=12)
OPTIONS = [f"{k}={v}" for k, v in MINI.items()] + [f"data.raw_size=({RAW[0]},{RAW[1]})"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("v2_root"))
    create_data.main(["synth", "--out-dir", out, "--scenes", "4", "--frames", "3",
                      "--objects", "6", "--img-w", str(RAW[1]), "--img-h", "900"])
    return out


def _jax_cfg(frames):
    jcfg = jax_get_config("bevformerv2-r50-t2")
    return jcfg.replace(frames=frames, data=dataclasses.replace(jcfg.data, raw_size=RAW))


@pytest.mark.parametrize("frames", [(-1, 0), (-2, -1, 0, 1)], ids=["t2", "t4_future"])
@pytest.mark.parametrize("index", [0, 1, 3], ids=["first", "inside", "scene_start"])
def test_test_sample_equals_jax(root, frames, index):
    jcfg = _jax_cfg(frames)
    ann = os.path.join(root, "nuscenes_infos_temporal_val.pkl")
    ref = JaxDatasetV2(ann, jcfg, test_mode=True, data_root=root).get_test_sample_v2(index)
    ds = NuScenesTemporalDatasetV2(ann, port_config(jcfg), data_root=root, device="cpu")
    ours = ds.get_test_sample_v2(index)
    assert ours["images"].shape == (len(frames), 6, RAW[0], RAW[1], 3)
    assert torch.equal(ours["images"], torch.from_numpy(ref["images"]))
    np.testing.assert_allclose(ours["lidar2img"], ref["lidar2img"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ours["frame_valid"], ref["frame_valid"])
    for key in ("token", "scene_token", "flip"):
        assert ours[key] == ref[key], key
    np.testing.assert_array_equal(ours["bda_mat"], ref["bda_mat"])
    # the fill: a frame outside the scene is the current frame
    cur = frames.index(0)
    scene = [ds.infos[i]["scene_token"] for i in range(len(ds))]
    for ti, off in enumerate(frames):
        j = index + off
        inside = 0 <= j < len(ds) and scene[j] == scene[index]
        assert bool(ours["frame_valid"][ti]) == inside
        if not inside:
            assert torch.equal(ours["images"][ti], ours["images"][cur])


@pytest.mark.parametrize("rung,flip", [(512, False), (608, True), (672, True), (768, False)])
def test_crop_resize_flip_equals_jax(rung, flip):
    """The crop, PIL's resize to a rung of the ladder and the flip give
    JAX's images bitwise and its camera matrices (float images clipped and
    truncated to uint8 first)."""
    from bevformer_tpu.data import pipeline_v2 as jax_pipeline_v2

    rng = np.random.RandomState(rung)
    crop = (0, 260, 64, 900)
    params = dict(resize=rung / 640, resize_dims=(int(rung / 640 * 64), rung), crop=crop,
                  flip=flip)
    imgs = rng.uniform(-20, 275, (6, 900, 64, 3)).astype(np.float32)
    cam2img = np.tile(np.eye(4), (6, 1, 1))
    cam2img[:, :3, :3] = [[50.0, 0, 32], [0, 50, 450], [0, 0, 1]]
    l2c = rng.randn(6, 4, 4)
    ours = pipeline_v2.crop_resize_flip(imgs, cam2img, l2c, params)
    ref = jax_pipeline_v2.crop_resize_flip(list(imgs), cam2img, l2c, params)
    assert ours[0].dtype == np.uint8 and ours[0].shape == (6, rung, params["resize_dims"][0], 3)
    np.testing.assert_array_equal(ours[0], np.stack(ref[0]))
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)


def _run_test(root, out, *more, monkeypatch=None):
    """tools.test bevformerv2-r50-t1-base in-process; returns (summary,
    results by token, the BN modes seen)."""
    seen = []
    if monkeypatch is not None:
        forward = torch.nn.BatchNorm2d.forward

        def recording(self, x):
            seen.append(self.training)
            return forward(self, x)

        monkeypatch.setattr(torch.nn.BatchNorm2d, "forward", recording)
    summary = test_cli.main(["bevformerv2-r50-t1-base", "--data-root", root, "--out", out,
                             "--device", "cpu", *more, "--cfg-options", *OPTIONS])
    with open(out) as f:
        results = {r["token"]: {k: np.asarray(v) for k, v in r.items() if k != "token"}
                   for r in json.load(f)}
    return summary, results, seen


def test_tools_test_v2_on_the_cpu(root, tmp_path, monkeypatch):
    out = str(tmp_path / "results.json")
    summary, results, seen = _run_test(root, out, monkeypatch=monkeypatch)
    n = len(results)
    assert n == 6 and summary["timing"]["frames"] == n
    assert seen and not any(seen), f"{sum(seen)} of {len(seen)} BN calls in train mode"
    assert os.path.exists(str(tmp_path / "results_nusc.json"))
    assert os.path.exists(str(tmp_path / "metrics_summary.json"))
    assert all(math.isfinite(summary[k]) for k in ("NDS", "mAP"))
    cfg = get_config("bevformerv2-r50-t1-base")
    assert cfg.group_detr == 1 and cfg.frames == (0,)

    folded, folded_results, seen = _run_test(root, str(tmp_path / "folded.json"),
                                             "--fuse-conv-bn", monkeypatch=monkeypatch)
    assert not seen  # every BN folded away
    assert sorted(folded_results) == sorted(results)
    for token, r in results.items():
        _match_boxes(dict(folded_results[token], token=token), dict(r, token=token), token)
