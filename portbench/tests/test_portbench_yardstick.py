"""The frozen roofline costs equal the port's tool, and the FLOP and
bound counts match hand counts at small shapes."""

import json
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.reference.model import config
from portbench.yardstick import roofline, work


@pytest.mark.parametrize("case", [
    ("msda_fwd", (2, 40, 8, 32, ((20, 20),), 4)),
    ("msda_fwd", (6, 100, 8, 32, ((16, 20), (8, 10)), 8)),
    ("msda_bwd", (6, 100, 8, 32, ((16, 20), (8, 10)), 8)),
    ("dcn_conv", (6, 16, 20, 64, 64)),
    ("dcn_im2col", (6, 16, 20, 64)),
    ("dcn_col2im", (6, 16, 20, 64)),
])
def test_frozen_copy_equals_the_ports_tool(case):
    from bevformer_torch.tools import roofline as port

    name, args = case
    assert getattr(roofline, name)(*args).as_dict() == getattr(port, name)(*args).as_dict()


def test_hand_counts():
    # msda: per sample 14 + 8 * d operations; bytes value + loc + attw + out
    c = roofline.msda_fwd(1, 10, 2, 4, ((3, 5),), 2)
    samples = 1 * 10 * 2 * 1 * 2
    assert c.flops == samples * (14 + 8 * 4)
    assert c.bytes == 4 * (15 * 2 * 4 + samples * 2 + samples + 10 * 2 * 4)
    # a linear layer: 3xTF32 products of 2 FLOP per multiply-add
    lin = work.linear_cost(10, 4, 3)
    assert lin.tf32_flops == 3 * 2 * 10 * 4 * 3 and lin.bytes == 4 * (40 + 12 + 3 + 30)
    assert work.msda_sums(1, 10, 2, 4, ((3, 5),), 2) == samples * 4 * 4
    assert work.PEAK_FP32_ACCURATE_FLOPS == 165e12


def test_backbone_counts_r10():
    c = config(json.loads((harness.PKG / "configs" / "bevformer_base.json").read_text()))
    c.backbone_depth = 10
    prods, dcns, outs = work.backbone(c, 2, 64, 96)
    # stem 7x7 stride 2: 32 x 48 outputs of 3 x 64 x 49 multiply-adds, frozen
    assert prods[0].macs == 2 * 32 * 48 * 3 * 64 * 49 and not prods[0].weight_grad
    assert [o for o in outs] == [(256, 16, 24), (512, 8, 12), (1024, 4, 6), (2048, 2, 3)]
    # stages 3 and 4 are DCN: one layer each, at the block's input size
    assert dcns == [(2, 4, 6, 256, 256), (2, 2, 3, 512, 512)]
    first_trained = [p for p in prods if p.weight_grad][0]
    assert not first_trained.input_grad  # nothing below stage 2 needs a gradient


def test_units_of_the_cells():
    base = config(json.loads((harness.PKG / "configs" / "bevformer_base.json").read_text()))
    f = work.frame(base)
    assert 3.6e12 < f.flops < 3.9e12  # R101-DCN at 6 x 928 x 1600 and the transformer
    t = work.train_step(base)
    assert t.flops > 5 * f.flops and t.dcn_bound_ms > 6 * f.dcn_bound_ms
    v2 = config(json.loads((harness.PKG / "configs" / "bevformerv2-r50-t8.json").read_text()))
    u = work.frame(v2)
    assert u.dcn_bound_ms == 0
    fusion = 2 * sum(p.macs for p in work.fusion(v2))
    assert 18e12 < fusion < 18.3e12  # six 3x3 convs 2048 -> 2048 on 200 x 200, the linear


def test_metric_readers_stay_silent_without_a_device():
    ctx = SimpleNamespace(on_device=False, trace={"busy_s": 0.0, "window_s": 1.0, "units": 1,
                                                   "ranges": {}}, peak_bytes=0, unit="frame",
                          units=1, window_s=1.0)
    for name in ("idle_pct.video", "peak_mem_gib.video", "mfu.video", "backbone_ms.video",
                 "dcn_roofline.video", "msda_roofline.train", "fusion_ms.video"):
        ctx.cfg = config(json.loads((harness.PKG / "configs" / "bevformer_base.json").read_text()))
        for ctx.unit in ("frame", "step"):
            assert harness.reader(name).read(ctx) is None, name


def test_idle_reads_the_windows_time_a_unit():
    """Busy 0.225 s a frame over the traced stretch against the window's
    0.25 s a frame: 10% idle, whatever the profiled stretch's own length."""
    ctx = SimpleNamespace(trace={"busy_s": 0.9, "units": 4, "window_s": 1.3}, units=100,
                          window_s=25.0, unit="frame")
    assert abs(harness.reader("idle_pct.video").read(ctx) - 10.0) < 1e-9
