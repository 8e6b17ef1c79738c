"""bevformer_small's mini detector (caffe R10 with DCN in stages 3-4, one
FPN level, SCA capacity 0.25, 16 x 16 BEV, 2 + 2 layers) against the JAX
package on the CPU: the checks of `tests/test_torch_presets.py`, in a file
of its own so that it runs beside tiny's on another worker."""

import pytest

from tests.test_torch_presets import (
    check_frame,
    check_fuse_conv_bn,
    check_structure,
    check_train_step,
    preset_runs,
)


@pytest.fixture(scope="module")
def runs():
    return preset_runs("bevformer_small")


def test_mini_preset_structure(runs):
    check_structure(runs)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_video_frame_matches_jax(runs, frame):
    check_frame(runs, frame)


def test_train_step_matches_jax(runs):
    check_train_step(runs)


def test_fuse_conv_bn_keeps_the_frame_and_matches_jax(runs):
    check_fuse_conv_bn(runs)
