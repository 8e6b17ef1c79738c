"""The generators are deterministic in the seed, and the six cameras
differ."""

import numpy as np
import torch

from portbench import traffic, weights
from portbench.reference.model import config
from portbench import harness


def test_seed32_takes_large_seeds():
    a = traffic.seed32(2 ** 31 + 5, 1)
    assert a == traffic.seed32(2 ** 31 + 5, 1) and a != traffic.seed32(2 ** 31 + 6, 1)
    assert 0 <= traffic.seed32(2 ** 40, 3) < 2 ** 32


def test_images_deterministic_in_the_seed():
    def img(seed):
        g = traffic.generator(seed, 1000, "cpu")
        return traffic.noise_images(2, 6, 8, 12, (1.0, 2.0, 3.0), (1.0, 1.0, 1.0), g, "cpu")
    assert torch.equal(img(7), img(7))
    assert not torch.equal(img(7), img(8))


def test_six_cameras_differ():
    l2i = traffic.rig_lidar2img(1600, 900, 6)
    assert l2i.shape == (6, 4, 4)
    for i in range(6):
        for j in range(i):
            assert not np.allclose(l2i[i], l2i[j])
    # a point 10 m ahead projects into the front camera only
    p = np.array([10.0, 0.0, 1.0, 1.0])
    seen = []
    for m in l2i:
        x, y, z, _ = m @ p
        seen.append(z > 0 and 0 < x / z < 1600 and 0 < y / z < 900)
    assert seen == [True, False, False, False, False, False]


def test_trajectory_and_can_bus():
    rng = np.random.RandomState(3)
    pos, yaw, speed = traffic.scene_poses(rng, 5)
    can = traffic.can_bus_deltas(pos, yaw, speed)
    assert can.shape == (5, 18) and not can[0, :3].any() and can[0, -1] == 0
    assert np.allclose(can[1:, :3], np.diff(pos, axis=0), atol=1e-5)
    can2, prev = traffic.train_queue(np.random.RandomState(4), 4, 2)
    assert prev.tolist() == [False, True, False, True]
    assert not can2[2, :3].any()


def test_history_cameras_are_the_current_at_no_motion():
    l2i = traffic.rig_lidar2img(1600, 640 + 260, 6, crop_top=260)
    pose = traffic.ego_pose([1.0, 2.0, 0.0], 0.3)
    assert np.allclose(traffic.history_lidar2img(l2i, pose, pose), l2i)


def test_weights_deterministic_and_complete():
    c = config(harness.load_cell("base.video").config)
    c.backbone_depth, c.encoder_layers, c.decoder_layers = 10, 1, 1
    a, b = weights.make(c, 5, "cpu"), weights.make(c, 5, "cpu")
    assert a.keys() == weights.reference_skeleton(c).state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    other = weights.make(c, 6, "cpu")
    assert not torch.equal(a["img_backbone.conv1.weight"], other["img_backbone.conv1.weight"])
    # the offset layers sample off the grid: small, nonzero
    off = a["img_backbone.layer3.0.conv2.conv_offset.weight"]
    assert 0 < float(off.abs().mean()) < 1e-3
