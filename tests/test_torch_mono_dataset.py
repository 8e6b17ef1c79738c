"""The port's mono dataset (`bevformer_torch/data/mono_dataset.py`, numpy on
the host) against the JAX package's: the padded annotations, the attribute
rule, the rotation-to-quaternion, the rotated BEV IoU, the per-class rotated
NMS, the lift of camera-frame boxes to the global frame and the submission
formatter. The same numpy arithmetic in the same order: everything is held
exactly (arrays bitwise, the submission dict equal)."""

import numpy as np
import pytest

from bevformer_tpu.data import mono_dataset as jmono
from bevformer_torch.data import mono_dataset as mono
from tests.test_mono_dataset import _mini_coco, _quat_z


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def test_constants_equal_jax():
    for name in ("DEFAULT_ATTRIBUTE", "ATTR_NAMES", "CLASS_RANGE"):
        assert getattr(mono, name) == getattr(jmono, name), name
    assert tuple(mono.NuScenesMonoDataset.CLASSES) == tuple(jmono.NuScenesMonoDataset.CLASSES)


@pytest.mark.parametrize("max_boxes,interval", [(8, 1), (1, 1), (4, 2)])
def test_annotations_equal_jax(max_boxes, interval):
    coco = _mini_coco()
    ours = mono.NuScenesMonoDataset(coco, max_boxes=max_boxes, load_interval=interval)
    ref = jmono.NuScenesMonoDataset(coco, max_boxes=max_boxes, load_interval=interval)
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        _equal(ours.get_ann_info(i), ref.get_ann_info(i), f"image {i}")


def test_attr_rule_equals_jax():
    for name in mono.CLASS_RANGE:
        for idx in range(-1, 11):
            assert mono.get_attr_name(idx, name) == jmono.get_attr_name(idx, name), (idx, name)


def test_rot_to_quat_and_global_lift_equal_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        q = rng.randn(4)
        r = jmono.quat_to_rot(q / np.linalg.norm(q))
        _equal(mono._rot_to_quat(r), jmono._rot_to_quat(r))
    for seed in range(4):
        rng = np.random.RandomState(seed)
        info = dict(cam2ego_rotation=_quat_z(rng.uniform(-3, 3)),
                    cam2ego_translation=rng.randn(3).tolist(),
                    ego2global_rotation=_quat_z(rng.uniform(-3, 3)),
                    ego2global_translation=(rng.randn(3) * 50).tolist())
        det = dict(boxes_3d=rng.randn(7, 9) * [5, 1, 10, 1, 1, 1, 3, 2, 2] + [0, 0, 15, 2, 2, 2,
                                                                           0, 0, 0])
        _equal(mono.mono_boxes_to_global(det, info), jmono.mono_boxes_to_global(det, info))


def _clustered_boxes(seed, n=40):
    rng = np.random.RandomState(seed)
    centers = np.repeat(rng.randn(8, 2) * 3.0, n // 8, axis=0) + rng.randn(n, 2) * 0.6
    dims = rng.rand(n, 2) * 2.0 + 1.0
    yaw = rng.rand(n) * 2 * np.pi
    bev = np.stack([centers[:, 0], centers[:, 1], dims[:, 0], dims[:, 1], yaw], -1)
    return bev, rng.rand(n), rng.randint(0, 3, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotated_iou_and_nms_equal_jax(seed):
    bev, scores, labels = _clustered_boxes(seed)
    for i in range(0, len(bev), 7):
        _equal(mono.rotated_iou_bev(bev[i], bev), jmono.rotated_iou_bev(bev[i], bev))
    for thr, score_thr, max_num in ((0.05, 0.01, 500), (0.3, 0.2, 500), (0.5, 0.0, 5)):
        ours = mono.nms_rotated_bev(bev, scores, labels, thr, score_thr, max_num)
        ref = jmono.nms_rotated_bev(bev, scores, labels, thr, score_thr, max_num)
        _equal(ours, ref, f"thr {thr}")
        assert 0 < len(ours) < len(bev)


def _frame_results(seed, cams=6):
    rng = np.random.RandomState(seed)
    out = []
    for c in range(cams):
        n = rng.randint(0, 6)
        boxes = rng.randn(n, 9) * [3, 0.5, 10, 0.5, 0.5, 1, 3, 1, 1] + [0, 0, 20, 2, 2, 4, 0,
                                                                        0, 0]
        res = dict(boxes_3d=boxes, scores_3d=rng.rand(n).tolist(),
                   labels_3d=rng.randint(0, 10, n).tolist())
        if c % 2:
            res["attrs_3d"] = rng.randint(0, 9, n).tolist()
        out.append(res)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_format_mono_results_equals_jax(seed):
    coco = _mini_coco()
    images = coco["images"] * 2
    for i, img in enumerate(images[6:]):
        images[6 + i] = dict(img, token="s1")
    results = _frame_results(seed) + _frame_results(seed + 10)
    ours = mono.format_mono_results(images, results)
    ref = jmono.format_mono_results(images, results)
    _equal(ours, ref)
    assert sorted(ours["results"]) == ["s0", "s1"]
    assert sum(len(v) for v in ours["results"].values()) > 0
