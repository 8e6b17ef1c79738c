"""`chip_smoke.py` refuses to run without a CUDA device: it exits nonzero
and prints no result line, here and from a directory that holds nothing
else of the repository."""

import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120,
    )


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _run(cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert '"kernels"' not in proc.stdout


GROUPS = ("loss", "backbone", "neck", "encoder", "decoder", "head")


def _errs(**given):
    return {g: given.get(g, 1e-5) for g in GROUPS}


@pytest.mark.parametrize("damped,errs,noisy,refused", [
    # undamped: every key within 10x of the noisy path
    (False, _errs(neck=6e-3), _errs(neck=7e-4), []),
    (False, _errs(neck=8e-3), _errs(neck=7e-4), ["neck: kernel vs plain"]),
    # damped: the transformer side to 1e-3, the backbone within 10x of noisy
    (True, _errs(backbone=3e-3, neck=9e-4), _errs(backbone=1e-3), []),
    (True, _errs(decoder=2e-3), _errs(), ["decoder: kernel vs plain"]),
    # a batch whose noisy path misses 1e-3 damped is refused as a batch,
    # whatever the kernel path reads
    (True, _errs(neck=9e-5), _errs(neck=2.45e-3), ["neck: noisy plain vs plain"]),
], ids=["undamped_within", "undamped_past", "damped_within", "damped_past", "degenerate_batch"])
def test_training_witness_limits(damped, errs, noisy, refused):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    fails = chip_smoke.witness_failures(errs, noisy, damped)
    assert len(fails) == len(refused)
    for msg, want in zip(fails, refused):
        assert msg.startswith(want), (msg, want)


def _corner_walk(x_shape, off_y, off_x, stride):
    """On-image corners of every (pixel, tap) passing -1 <= p < size, one
    sample at a time."""
    from bevformer_torch.kernels import dcn

    _, h, w, _ = x_shape
    py, px = dcn._grid(off_y.shape[1], off_y.shape[2], stride, off_y, off_x)
    adds = 0
    for y, x in zip(py.reshape(-1).tolist(), px.reshape(-1).tolist()):
        if not (-1 <= y < h and -1 <= x < w):
            continue
        for yy in (math.floor(y), math.floor(y) + 1):
            for xx in (math.floor(x), math.floor(x) + 1):
                adds += 0 <= yy < h and 0 <= xx < w
    return adds


@pytest.mark.parametrize("stride,offsets", [(1, 2.0), (2, 2.0), (1, 0.0), (1, "edge"),
                                            (2, "edge"), (1, 20.0), (2, 20.0)])
def test_col2im_dx_adds_counts_the_on_image_corners(stride, offsets):
    """chip_smoke.py's count of K6's dx adds: at zero offsets each interior
    (pixel, tap) adds 4 corners; exact edges (-1, H - 1, off the map) and far
    offsets as a walk over the samples counts them."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from torch_port_helpers import edge_offsets

    rng = np.random.RandomState(stride)
    b, h, w, c = 2, 8, 16, 32
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    if offsets == "edge":
        off_y, off_x = edge_offsets(rng, b, oh, ow, h), edge_offsets(rng, b, oh, ow, w)
    else:
        off_y, off_x = (rng.randn(2, b, oh, ow, 9) * offsets).astype(np.float32)
    off_y, off_x = torch.from_numpy(off_y), torch.from_numpy(off_x)
    adds = chip_smoke.col2im_dx_adds((b, h, w, c), off_y, off_x, stride)
    assert adds == _corner_walk((b, h, w, c), off_y, off_x, stride)
    if offsets == 0.0:
        # per axis of n pixels, the 3n samples o - 1 + k: -1 and n - 1 (twice)
        # keep one corner row, n drops out, the 3n - 4 others keep two
        assert adds == b * (6 * h - 5) * (6 * w - 5)


def test_recorded_col2im_records_and_restores():
    """chip_smoke.py's recorder hands every dcn_col2im call through, keeps
    its arguments, and puts the wrapper back, also after a raise."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.kernels import dcn

    kernel = dcn.dcn_col2im
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 4, 5, 8).astype(np.float32))
    off = torch.from_numpy(rng.randn(3, 1, 4, 5, 9).astype(np.float32))
    dcols = torch.from_numpy(rng.randn(20, 72).astype(np.float32))
    calls = []
    launches = kernel.launches
    with chip_smoke.recorded_col2im(calls):
        # the wrapper's launch count goes by its module name: the recorder
        # has one, so that a card's launch does not fail on it
        assert dcn.dcn_col2im.launches == 0
        got = dcn.dcn_col2im(x, off[0], off[1], off[2], dcols)
    assert dcn.dcn_col2im is kernel and kernel.launches == launches
    assert len(calls) == 1 and calls[0][0] is x and calls[0][4] is dcols and calls[0][5] == 1
    for a, r in zip(got, kernel(x, off[0], off[1], off[2], dcols)):
        assert torch.equal(a, r)
    with pytest.raises(ZeroDivisionError):
        with chip_smoke.recorded_col2im(calls):
            1 / 0
    assert dcn.dcn_col2im is kernel


def test_perfect_detector_scores_the_ground_truth_as_exact(tmp_path):
    """chip_smoke.py's phase-12 check of the evaluation: a synthetic root's
    val ground truth, scored as predictions, gives mAP 1 and TP errors 0."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.configs import get_config
    from bevformer_torch.data import generate

    generate(str(tmp_path), num_scenes=2, frames_per_scene=2, img_w=64, img_h=32, seed=4)
    m = chip_smoke.perfect_detector(str(tmp_path), get_config("bevformer_base"), "cpu")
    assert abs(m["mean_ap"] - 1) <= chip_smoke.PERFECT_TOL
    assert all(v == 0 for v in m["tp_errors"].values())


def test_cli_helpers():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    records = [{"a": 1}, {"done": True, "steps": 2}, {"a": 2, "b": 3}]
    assert chip_smoke.one(records, "done", "x") == records[1]
    with pytest.raises(chip_smoke.Failure, match="2 lines with 'a'"):
        chip_smoke.one(records, "a", "x")
    assert chip_smoke.median_of([3.0, 1.0, 2.0]) == 2.0
    assert chip_smoke.median_of([4.0, 1.0]) == 2.5
    assert math.isnan(chip_smoke.median_of([]))


@pytest.mark.parametrize("name,frame,step", [
    ("bevformer_base", dict(msda_fwd=18, dcn_conv_fwd=26),
     dict(msda_fwd=54, dcn_conv_fwd=52, msda_bwd=18, dcn_im2col=26, dcn_col2im=26)),
    ("bevformer_small", dict(msda_fwd=12, dcn_conv_fwd=26),
     dict(msda_fwd=24, dcn_conv_fwd=52, msda_bwd=12, dcn_im2col=26, dcn_col2im=26)),
    ("bevformer_tiny", dict(msda_fwd=12), dict(msda_fwd=24, msda_bwd=12)),
    ("bevformer_tiny_fp16", dict(msda_fwd_bf16=12), dict(msda_fwd_bf16=24, msda_bwd_bf16=12)),
])
def test_path_launches(name, frame, step):
    """chip_smoke.py's launches per frame and per training step of each v1
    preset (3 or 6 encoder layers of TSA + SCA, 6 decoder layers; queue 3
    or 4, the history frames encoder only with one backbone pass; the DCN
    blocks of R101's stages 3-4), every other counter 0; bevformer_base's
    are the phases' constants."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.configs import get_config
    from bevformer_torch.kernels import kernel_counters

    zero = dict.fromkeys(kernel_counters(), 0)
    assert chip_smoke.path_launches(get_config(name)) == (dict(zero, **frame), dict(zero, **step))
    if name == "bevformer_base":
        assert step == {k: v for k, v in chip_smoke.TRAIN_PER_STEP.items() if v}
        assert frame == dict(msda_fwd=chip_smoke.K1_PER_FRAME, dcn_conv_fwd=chip_smoke.K2_PER_FRAME)


def test_box_set_errors():
    """The --fuse-conv-bn comparison: boxes matched by label and score as
    sets, whatever their order; a missing match is counted."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    rng = np.random.RandomState(0)
    ref = dict(boxes_3d=rng.randn(5, 9), scores_3d=np.linspace(0.9, 0.5, 5),
               labels_3d=np.arange(5) % 3)
    perm = rng.permutation(5)
    ours = {k: v[perm].copy() for k, v in ref.items()}
    ours["boxes_3d"][:, 0] += 1e-5
    score, box, missing = chip_smoke.box_set_errors(ours, ref)
    assert score == 0 and missing == 0
    assert box == pytest.approx(1e-5 / np.abs(ref["boxes_3d"]).max(), rel=1e-3)
    ours["labels_3d"][0] = 7
    assert chip_smoke.box_set_errors(ours, ref)[2] == 1
    assert chip_smoke.box_set_errors({k: v[:4] for k, v in ours.items()}, ref)[0] == float("inf")


@pytest.mark.parametrize("name,k1,k34", [("bevformerv2-r50-t1", 18, 18),
                                         ("bevformerv2-r50-t8", 102, 18)])
def test_v2_train_per_step(name, k1, k34):
    """K1 in every encoder layer of the 1 or 8 frames encoded and the
    decoder; K3/K4 in the current frame's; no other kernel."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.configs import get_config

    per = chip_smoke.v2_train_per_step(get_config(name))
    assert per == dict(dict.fromkeys(per, 0), msda_fwd=k1, msda_bwd=k34)
