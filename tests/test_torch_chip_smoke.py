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


@pytest.mark.parametrize("name,frame,step", [
    ("bevformer_base", dict(msda_fwd_bf16=18, dcn_conv_fwd_bf16=26),
     dict(msda_fwd_bf16=54, dcn_conv_fwd_bf16=52, msda_bwd_bf16=18, dcn_im2col_bf16=26,
          dcn_col2im_bf16=26)),
    ("bevformer_small", dict(msda_fwd_bf16=12, dcn_conv_fwd_bf16=26),
     dict(msda_fwd_bf16=24, dcn_conv_fwd_bf16=52, msda_bwd_bf16=12, dcn_im2col_bf16=26,
          dcn_col2im_bf16=26)),
])
def test_path_launches_bf16(name, frame, step):
    """At dtype=bfloat16 (phase 16, and phase 12's bf16 CLIs) every launch
    of base's and small's paths counts on the bf16 entries of K1-K6, and
    the fp32 counters stay 0."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.configs import get_config
    from bevformer_torch.kernels import kernel_counters

    zero = dict.fromkeys(kernel_counters(), 0)
    cfg = get_config(name).replace(dtype="bfloat16")
    assert chip_smoke.path_launches(cfg) == (dict(zero, **frame), dict(zero, **step))
    assert name in chip_smoke.BF16_DCN_PRESETS


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


@pytest.mark.parametrize("name,extra", [
    ("bevformer_base", dict(msda_fwd=12, dcn_conv_fwd=22 + 2)),
    ("bevformerv2-r50-t8", dict(msda_fwd=12, dcn_conv_fwd=0)),
    ("bevformer_small", dict(msda_fwd=6, dcn_conv_fwd=22 + 2)),
])
def test_remat_step_counts(name, extra):
    """Phase 17's extra launches a step under `use_remat`: TSA and SCA of
    each recomputed encoder layer, and the DCN blocks after the first of
    R101's stages 3-4 (R50 has no DCN)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.configs import get_config

    assert chip_smoke.remat_step_counts(get_config(name)) == extra


def test_two_sample_batch():
    """Phase 17's two samples: unequal ground-truth counts, V2's DD3D
    targets one row per camera image."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.configs import DataConfig, get_config

    small = dict(backbone_depth=10, bev_h=8, bev_w=8, data=DataConfig(raw_size=(64, 96)))
    for name in ("bevformer_base", "bevformerv2-r50-t1"):
        batch = chip_smoke.two_sample_batch(get_config(name, **small))
        assert batch.num_gt.tolist() == list(chip_smoke.DP_GT_COUNTS)
        assert batch.images.shape[0] == 2
        n = chip_smoke.DP_GT_COUNTS[1]
        assert not batch.gt_boxes[1, n:].any() and batch.gt_boxes[1, :n].any()
        swapped = chip_smoke.swap_samples(batch)
        assert torch.equal(swapped.images[0], batch.images[1])
        assert swapped.num_gt.tolist() == list(chip_smoke.DP_GT_COUNTS)[::-1]
        if name.startswith("bevformerv2"):
            assert all(v.shape[0] == 12 for v in batch.mono_targets.values())
            for k, v in batch.mono_targets.items():
                assert torch.equal(swapped.mono_targets[k], torch.cat([v[6:], v[:6]])), k


def test_sp_phase_cases():
    """Phase 18: base at (dp 1, sp 2) and V2 t1 at (2, 2) with `use_remat`
    (four full-size t1 ranks do not fit one card without it), both at 2
    encoder layers; K1 and K3/K4 at a base rank's split shapes: TSA at half of
    the 40000 queries (the value queue whole), SCA at the rows given."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke.SP_STEPS == (
        ("bevformer_base", 1, 2, {"encoder_layers": 2}),
        ("bevformerv2-r50-t1", 2, 2, {"use_remat": True, "encoder_layers": 2}))
    tsa, sca = chip_smoke.sp_kernel_cases([9000, 8000])
    assert tsa[:3] == ("tsa-sp2", 2, 20000) and tsa[3:] == chip_smoke.K34_CASES[0][3:]
    assert sca[:3] == ("sca-sp2", 6, 9000) and sca[3:] == chip_smoke.K34_CASES[1][3:]


def test_split_calls():
    """A rank's (B, Q) record by call site; TSA at other than the rank's
    queries, or SCA above the capacity's rows, fails."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.configs import get_config

    cfg = get_config("bevformer_base")
    assert chip_smoke.sca_cap(cfg) == 10112
    rec = dict(queries={"msda_fwd": [[1, 900, 6], [2, 20000, 24], [6, 9000, 12], [6, 7000, 12]]})
    assert chip_smoke.split_calls(rec, "msda_fwd", cfg, 20000) == dict(
        tsa={20000: 24}, sca={9000: 12, 7000: 12}, decoder={900: 6})
    with pytest.raises(chip_smoke.Failure, match="TSA"):
        chip_smoke.split_calls(rec, "msda_fwd", cfg, 40000)
    rec["queries"]["msda_fwd"].append([6, 10113, 1])
    with pytest.raises(chip_smoke.Failure, match="capacity"):
        chip_smoke.split_calls(rec, "msda_fwd", cfg, 20000)


def test_mm_phase_cases():
    """Phase 19: K1's and K3/K4's new shapes in one MMBEVFormerLayer call at
    its defaults, one launch each a forward or backward, with their cost
    rows: the lidar branch (one 200 x 200 level, 4 points) and SCA with every
    query routed (6 cameras of 40,000 rows over base's 4 levels, 8 points)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.tools import roofline

    lidar, sca = chip_smoke.mm_kernel_cases()
    assert lidar == ("lidar", 1, 40000, 8, 32, ((200, 200),), 4, 1)
    assert sca == ("sca-dense", 6, 40000, 8, 32, chip_smoke.K1_CASES[1][5], 8, 1)
    assert sum(h * w for h, w in sca[5]) == 30825
    for name, b, q, h, d, shapes, p, _ in (lidar, sca):
        for cost in (roofline.msda_fwd(b, q, h, d, shapes, p),
                     roofline.msda_bwd(b, q, h, d, shapes, p)):
            assert cost.bound_ms > 0 and cost.bound_by in ("bytes", "operations"), name
    # dense SCA reads and writes 40000 / 10112 times the capacity's rows
    fwd = roofline.msda_fwd(*sca[1:7])
    capped = roofline.msda_fwd(*chip_smoke.K1_CASES[1][1:7])
    assert fwd.bytes > capped.bytes and fwd.flops == pytest.approx(capped.flops * 40000 / 10112)


def test_mm_layer_launches_are_the_layers_calls(monkeypatch):
    """`mm_layer_launches` against the msda calls one MMBEVFormerLayer
    forward and backward makes (each forward call and its backward counted
    on the CPU's plain path), at a small BEV."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.kernels import msda
    from bevformer_torch.models import attention
    from bevformer_torch.models.mm_layer import MMBEVFormerLayer

    monkeypatch.setattr(chip_smoke, "MM_BEV", (4, 5))
    calls = {"msda_fwd": [], "msda_bwd": []}

    class Counted(torch.autograd.Function):
        @staticmethod
        def forward(ctx, value, shapes, loc, attw):
            ctx.save_for_backward(value, loc, attw)
            ctx.shapes = shapes
            calls["msda_fwd"].append(tuple(loc.shape[:2]))
            return msda.ms_deform_attn_plain(value, shapes, loc, attw)

        @staticmethod
        def backward(ctx, g):
            value, loc, attw = ctx.saved_tensors
            calls["msda_bwd"].append(tuple(loc.shape[:2]))
            dv, dl, da = msda.ms_deform_attn_backward_plain(value, ctx.shapes, loc, attw, g)
            return dv, None, dl, da

    monkeypatch.setattr(attention, "ms_deform_attn", Counted.apply)
    layer = MMBEVFormerLayer(embed_dims=32, num_heads=8, feedforward_channels=64, num_levels=2)
    q, levels = 20, ((3, 4), (2, 2))
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    query = t(1, q, 32).requires_grad_(True)
    out = layer(query, t(1, 6, 16, 32), t(1, q, 32), t(1, q, 32), t(1, 2, q, 32),
                torch.rand(1, 2, q, 1, 2), torch.rand(1, 6, q, 4, 2),
                torch.from_numpy(rng.rand(1, 6, q, 4) < 0.5), levels, 4, 5)
    out.sum().backward()
    want = chip_smoke.mm_layer_launches()
    for key in want:
        got = sorted([b, n, calls[key].count((b, n))] for b, n in set(calls[key]))
        assert got == want[key], key


def test_head_gt_pins_a_bag_of_ties():
    """Phase 19 (c)'s boxes: 12, one 0.3 m box overlapping some anchors,
    one outside the BEV overlapping none (its bag: 25 IoU-0 anchors, the
    lowest indices); the bags equal a CPU recomputation."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.configs import get_config
    from bevformer_torch.models import bev_head as bh

    cfg = get_config("bevformer_base")
    boxes, labels, ng = chip_smoke.head_gt(cfg)
    assert boxes.shape == (1, 12, 9) and labels.shape == (1, 12) and int(ng) == 12
    anchors = bh.generate_anchors(cfg.bev_h, cfg.bev_w, cfg.pc_range)
    iou, topv, topi = bh.positive_bags(anchors, boxes[0], 12, 25)
    assert (iou[:, 0] > 0).sum() > 0 and (iou[:, 1] == 0).all()
    assert topi[1].tolist() == list(range(25)) and (topv[1] == 0).all()


def test_decode_times_reads_one_frame_both_ways(tmp_path):
    """Phase 19 (d)'s decode timing on a tiny root: the PNGs hold the JPEGs'
    pixels, and both codecs' times and bytes are reported."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bevformer_torch.data import synth

    synth.generate(str(tmp_path), num_scenes=2, frames_per_scene=1, num_objects=4,
                   img_w=160, img_h=96)
    res = chip_smoke.decode_times(str(tmp_path), "cpu")
    assert res["jpeg_decode_ms"] > 0 and res["png_decode_ms"] > 0
    assert 0 < res["jpeg_mb"] < res["png_mb"]


def test_run_mains_runs_each_argv_in_one_process(tmp_path):
    """`run_mains`: one process calls `module.main(argv)` for each (module,
    argv), and the JSON lines come back split by run; a failing run fails
    the call."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    runs, secs = chip_smoke.run_mains([
        ("bevformer_torch.tools.create_data",
         ["synth", "--out-dir", a, "--scenes", "2", "--frames", "1", "--img-w", "32",
          "--img-h", "16"]),
        ("bevformer_torch.tools.create_data",
         ["synth", "--out-dir", b, "--scenes", "2", "--frames", "1", "--img-w", "32",
          "--img-h", "16"])], "create_data twice")
    assert runs == [[], []] and secs > 0
    assert len(list((tmp_path / "a" / "samples").iterdir())) == 12
    assert len(list((tmp_path / "b" / "samples").iterdir())) == 12
    with pytest.raises(chip_smoke.Failure, match="exited"):
        chip_smoke.run_mains([("bevformer_torch.tools.create_data", ["nomode"])], "bad")
