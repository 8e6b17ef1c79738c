"""The reference against the port's plain path at a tiny size on the CPU,
sound runs that come out correct, each fault a cell can have that makes
a run come out not correct, and (on a card, at the cell's size) the
control that does too, and a backward fault (K6's dx doubled)."""

import time

import pytest
import torch

from portbench import harness, program, weights
from portbench.reference import model as ref

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11


def _models(cell):
    c = ref.config(cell.config)
    sd = weights.make(c, SEED, CPU)
    port = program.build_model(program.port_config(cell.config), sd, CPU).eval()
    r = weights.reference_skeleton(c)
    r.to_empty(device=CPU)
    r.load_state_dict(sd)
    return c, port, r.eval()


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_reference_equals_the_ports_plain_path_v1(tiny):
    cell = tiny("base.video")
    c, port, r = _models(cell)
    torch.manual_seed(0)
    h, w = ref.img_size(c)
    images = torch.randn(1, 6, h, w, 3) * 50
    can = torch.zeros(1, 18)
    can[0, :2], can[0, -2], can[0, -1] = torch.tensor([1.0, 0.5]), 0.3, 4.0
    from portbench import traffic

    l2i = torch.as_tensor(traffic.rig_lidar2img(160, 96, 6), dtype=torch.float32)[None]
    prev = torch.randn(1, c.bev_h * c.bev_w, c.embed_dims)
    has = torch.tensor([True])
    bev, _ = program.video_evaluator(port.cfg, port).step(images, can, l2i, prev, has)
    with torch.no_grad():
        want = r.forward_v1(images, can, l2i, prev, has)
        got = port(images, can, l2i, prev, has)
    assert _rel(bev, want["bev_embed"]) < 1e-5
    for k in ("all_cls_scores", "all_bbox_preds"):
        assert _rel(got[k], want[k]) < 1e-5


@pytest.mark.parametrize("name", ["base.video", "v2t8.video", "base.train"])
def test_sound_run_is_correct(tiny, name):
    out = harness.run(tiny(name), SEED, 0.01, False, CPU, time.perf_counter(), log=lambda m: None)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("name,fault", [("base.video", "stale"), ("base.video", "alter"),
                                        ("v2t8.video", "alter"), ("base.train", "stale"),
                                        ("base.train", "alter"), ("base.train", "dw")])
def test_fault_makes_the_run_incorrect(tiny, name, fault):
    out = harness.run(tiny(name), SEED, 0.01, False, CPU, time.perf_counter(), fault=fault,
                      log=lambda m: None)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["base.video", "v2t8.video", "base.train"])
def test_control_fails_on_the_card(name):
    """At the cell's own size and for one frame or the checked steps, the
    program comes out correct and the reference in TF32 in its place fails
    one of the cell's numbers (the readings on many seeds are in PERF.md;
    at a tiny size TF32's error stays under the limits, which are set for
    the cell's size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(name)
    out = harness.run(cell, SEED, 0.01, False, torch.device("cuda", 0), time.perf_counter(),
                      control=True, log=lambda m: None)
    limits = cell.spec["limits"]
    assert out["correct"], out["checks"]
    assert any(v > limits[k] for k, v in out["control"].items()), out["control"]


@pytest.mark.cuda
def test_backward_fault_fails_on_the_card():
    """K6's dx doubled where it is made, at the cell's own size: the
    doubling compounds through the 23 stage-3 blocks and moves the
    backbone's median leaf (at the CPU tests' depth it barely does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run(harness.load_cell("base.train"), SEED, 0.01, False,
                      torch.device("cuda", 0), time.perf_counter(), fault="dx",
                      log=lambda m: None)
    assert not out["correct"], out["checks"]
