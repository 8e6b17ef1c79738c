"""The port's kernel tools (`bevformer_torch/tools`) and entry-point device
defaults, on the CPU: the roofline counts against hand-computed bytes and
FLOPs, the tools' seeded inputs, their `main`s end to end with the timing
stubbed (the kernel wrappers then take their plain versions), and that
nothing that needs the card runs without one. Whether a card is present is
decided inside each test."""

import json

import numpy as np
import pytest
import torch

from bevformer_torch.tools import (
    bench_dcn_variants,
    bench_dma_gather,
    bench_hi_probe,
    bench_kernel_probe,
    bench_kernel_probe3,
    bench_msda_decompose,
    bench_msda_kernel,
    bench_vovnet,
    common,
    roofline,
    witness_seeds,
)

TOOLS = [bench_msda_kernel, bench_kernel_probe3, bench_kernel_probe, bench_hi_probe,
         bench_msda_decompose, bench_dma_gather, witness_seeds, bench_dcn_variants,
         bench_vovnet]


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_roofline_k1_tsa_call():
    """K1 at TSA's shape: value [2, 40000, 8, 32], loc [2, 40000, 8, 1, 4, 2],
    attw [2, 40000, 8, 1, 4], out [2, 40000, 256], fp32."""
    cost = roofline.msda_fwd(2, 40000, 8, 32, ((200, 200),), 4)
    value = 2 * 40000 * 8 * 32 * 4
    samples = 2 * 40000 * 8 * 1 * 4
    want_bytes = value + samples * 2 * 4 + samples * 4 + 2 * 40000 * 256 * 4
    assert cost.bytes == want_bytes == 194_560_000
    # per sample: 14 for the position and corner weights, 4 corner FMAs per channel
    assert cost.flops == samples * (14 + 8 * 32) == 691_200_000
    assert cost.bound_by == "bytes"
    assert cost.bound_ms == pytest.approx(194.56e6 / 3.35e12 * 1e3)


def test_roofline_k2_stage3_call():
    """K2 at stage 3: x [6, 58, 100, 256], offsets and mask [6, 58, 100, 9],
    weight [2304, 256], out [6, 58, 100, 256], stride 1."""
    cost = roofline.dcn_conv(6, 58, 100, 256, 256)
    pixels = 6 * 58 * 100
    want_bytes = pixels * 256 * 4 + 3 * pixels * 9 * 4 + 2304 * 256 * 4 + pixels * 256 * 4
    assert cost.bytes == want_bytes == 77_388_096
    # 8 per tap and channel for sampling on the SIMT units; 2 * 9C * Cout for
    # the contraction on the tensor cores, three TF32 products each
    assert cost.flops == 8 * pixels * 2304 == 641_433_600
    assert cost.tf32_flops == 3 * 2 * pixels * 2304 * 256 == 123_155_251_200
    assert cost.bound_by == "operations"
    assert cost.bound_ms == pytest.approx(123.1552512e9 / 495e12 * 1e3)
    assert cost.bound_ms == pytest.approx(0.249, abs=5e-4)
    # per frame, with stage 4's 3 calls: about 6.5 ms
    per_frame = roofline.total([(cost, 23), (roofline.dcn_conv(6, 29, 50, 512, 512), 3)])
    assert per_frame["bound_ms"] == pytest.approx(6.47, abs=0.01)


def test_roofline_k2_stage4_call():
    """K2 at stage 4: x [6, 29, 50, 512], weight [4608, 512], out [6, 29, 50,
    512]: the same contraction as stage 3, so the same bound; the SIMT
    sampling and the bytes stay far below it."""
    cost = roofline.dcn_conv(6, 29, 50, 512, 512)
    pixels = 6 * 29 * 50
    want_bytes = 2 * pixels * 512 * 4 + 3 * pixels * 9 * 4 + 4608 * 512 * 4
    assert cost.bytes == want_bytes == 46_011_984
    assert cost.flops == 8 * pixels * 4608
    assert cost.tf32_flops == 3 * 2 * pixels * 4608 * 512 == 123_155_251_200
    assert cost.bound_by == "operations"
    assert cost.bound_ms == pytest.approx(0.2488, abs=1e-4)
    assert cost.flops / roofline.FP32_FLOPS < cost.tf32_flops / roofline.TF32_FLOPS / 20
    # stride 2 quarters the pixels and the contraction
    half = roofline.dcn_conv(6, 29, 50, 512, 512, stride=2)
    assert half.tf32_flops == 3 * 2 * (6 * 15 * 25) * 4608 * 512


@pytest.mark.parametrize("args", [
    (2, 2500, 8, 32, ((50, 50),), 4),
    (6, 2500, 8, 32, ((15, 25),), 8),
    (1, 900, 8, 32, ((50, 50),), 4),
    (6, 10112, 8, 32, common.SCA_LEVELS, 8),
], ids=["tiny_tsa", "tiny_sca", "tiny_decoder", "base_sca"])
def test_roofline_bf16_msda_counts_value_and_output_at_two_bytes(args):
    """bf16 K1 and K3/K4: value, output, grad_out and dValue at 2 bytes an
    element, locations, weights and their gradients at 4; the same
    operations as fp32 (the arithmetic is fp32)."""
    b, q, h, d, shapes, p = args
    k = sum(hh * ww for hh, ww in shapes)
    samples = b * q * h * len(shapes) * p
    fwd, bwd = roofline.msda_fwd(*args, itemsize=2), roofline.msda_bwd(*args, itemsize=2)
    assert fwd.bytes == b * k * h * d * 2 + samples * 3 * 4 + b * q * h * d * 2
    assert bwd.bytes == 2 * (b * k * h * d * 2 + samples * 3 * 4) + b * q * h * d * 2
    assert fwd.flops == roofline.msda_fwd(*args).flops == samples * (14 + 8 * d)
    assert bwd.flops == roofline.msda_bwd(*args).flops
    assert fwd.bytes < roofline.msda_fwd(*args).bytes
    for cost in (fwd, bwd):
        assert cost.bound_ms == pytest.approx(max(cost.bytes / 3.35e12, cost.flops / 67e12) * 1e3)


@pytest.mark.parametrize("args,bound", [
    ((2, 40000, 8, 32, ((200, 200),), 4), 0.0917),
    ((6, 10112, 8, 32, common.SCA_LEVELS, 8), 0.2429),
    ((1, 900, 8, 32, ((200, 200),), 4), 0.0249),
], ids=["tsa", "sca", "decoder"])
def test_roofline_k34_per_shape(args, bound):
    """K3/K4 at the training path's three shapes: value, loc and attw read
    and their gradients written, and grad_out read, fp32; bound by bytes."""
    b, q, h, d, shapes, p = args
    cost = roofline.msda_bwd(*args)
    k = sum(hh * ww for hh, ww in shapes)
    samples = b * q * h * len(shapes) * p
    assert cost.bytes == 2 * (b * k * h * d * 4 + samples * 3 * 4) + b * q * h * d * 4
    assert cost.flops == samples * (14 + 26 * d)
    assert cost.bound_by == "bytes"
    assert cost.bound_ms == pytest.approx(bound, abs=5e-5)


@pytest.mark.parametrize("args,bound", [((6, 58, 100, 256), 0.1075), ((6, 29, 50, 512), 0.0535)],
                         ids=["layer3", "layer4"])
def test_roofline_k5_per_stage(args, bound):
    """K5 at R101 stages 3 and 4 (stride 1): x, offsets and mask read, the
    column [B*H*W, 9C] written; the column is nine tenths of the bytes."""
    b, h, w, c = args
    cost = roofline.dcn_im2col(*args)
    column = b * h * w * 9 * c * 4
    assert cost.bytes == b * h * w * c * 4 + 3 * b * h * w * 9 * 4 + column
    assert column / cost.bytes > 0.89
    assert cost.bound_by == "bytes"
    assert cost.bound_ms == pytest.approx(bound, abs=5e-5)


@pytest.mark.parametrize("args,bound", [
    ((6, 58, 100, 256), 399_504_000 / 3.35e12 * 1e3),
    ((6, 29, 50, 512), 197_872_800 / 3.35e12 * 1e3),
], ids=["layer3", "layer4"])
def test_roofline_k6_per_stage(args, bound):
    """K6 at R101 stages 3 and 4 (stride 1): x, offsets and mask read and
    their gradients written, and the column gradient read once; bytes bound
    it."""
    b, h, w, c = args
    cost = roofline.dcn_col2im(*args)
    x, offsets, taps = b * h * w * c * 4, 3 * b * h * w * 9 * 4, b * h * w * 9
    assert cost.bytes == 2 * (x + offsets) + taps * c * 4
    assert cost.flops == taps * c * 24
    assert cost.bound_by == "bytes"
    assert cost.bound_ms == pytest.approx(bound)


def test_roofline_totals_and_the_gather_bound():
    tsa = roofline.msda_fwd(2, 40000, 8, 32, ((200, 200),), 4)
    dec = roofline.msda_fwd(1, 900, 8, 32, ((200, 200),), 4)
    tot = roofline.total([(tsa, 6), (dec, 6)])
    assert tot["bound_ms"] == pytest.approx(6 * (tsa.bound_ms + dec.bound_ms))
    assert tot["bound_by"] == "bytes"
    # the P5 probe: 2 x 125.8 MB of bf16 rows and 1 MB of int32 indices
    rg = roofline.row_gather(6, 40960, 40960, 256, 2)
    assert rg.bytes == 2 * 6 * 40960 * 256 * 2 + 6 * 40960 * 4 == 252_641_280
    assert rg.flops == 0 and rg.bound_by == "bytes"
    assert rg.bound_ms == pytest.approx(0.0754, abs=1e-4)
    modes = {m: roofline.msda_fwd(6, 16000, 8, 32, common.SCA_LEVELS, 8, m)
             for m in ("full", "gather", "weights", "noop")}
    assert modes["full"].bytes > modes["gather"].bytes > modes["weights"].bytes == modes["noop"].bytes


@pytest.mark.parametrize("shape", [common.sca_shape(64), common.tsa_shape(48),
                                   common.sca_shape(40, (common.SCA_LEVELS[0],))],
                         ids=["sca", "tsa", "sca_level0"])
def test_coherent_inputs(shape):
    value, loc, attw = common.coherent_inputs(shape)
    l = len(shape.levels)
    assert value.shape == (shape.b, shape.k, shape.h, shape.d) and value.dtype == np.float32
    assert loc.shape == (shape.b, shape.q, shape.h, l, shape.p, 2) and loc.dtype == np.float32
    assert attw.shape == (shape.b, shape.q, shape.h, l, shape.p)
    assert (0 <= attw).all() and (attw < 1).all()
    assert (0 <= loc[..., 0]).all() and (loc[..., 0] < 1).all()
    # y-coherent: every sample within 3 image rows of its query's row
    base = (np.arange(shape.q) + 0.5) / shape.q
    for lvl, (hh, _) in enumerate(shape.levels):
        rows = np.abs(loc[:, :, :, lvl, :, 1] - base[None, :, None, None]) * hh
        assert rows.max() <= common.JITTER_ROWS + 1e-3
        assert rows.max() > 0.9 * common.JITTER_ROWS
    again = common.coherent_inputs.__wrapped__(shape)  # a fresh draw, not the cache's
    assert all(np.array_equal(a, b) for a, b in zip(again, (value, loc, attw)))


def test_incoherent_locations_and_gather_inputs():
    shape = common.sca_shape(64)
    loc = common.incoherent_locations(shape)
    assert loc.shape == (shape.b, shape.q, shape.h, 4, shape.p, 2)
    outside = ((loc < 0) | (loc > 1)).mean()
    assert 0.09 < outside < 0.11, outside
    src, idx = bench_dma_gather.inputs((2, 64, 32))
    assert src.shape == (2, 64, 32) and idx.shape == (2, 64) and idx.dtype == np.int32
    assert all(sorted(row) == list(range(64)) for row in idx.tolist())


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tool_main_raises_without_a_card(tool):
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])


@pytest.mark.parametrize("name", sorted(bench_dcn_variants.VARIANTS))
def test_dcn_variant_edits_fit_the_kernel_source(name):
    """Each variant of bf16 K2's source changes the kernel as it stands, and
    an edit that does not match it once raises rather than building the
    unchanged kernel under the variant's name."""
    text = bench_dcn_variants.SOURCE.read_text()
    assert bench_dcn_variants.variant_source(name, text) != text
    with pytest.raises(ValueError, match="matches 0 times"):
        bench_dcn_variants.variant_source(name, "")


def test_tool_cases_parse():
    assert common.parser("x", ("a", "b")).parse_args([]).cases == ["a", "b"]
    assert common.parser("x", ("a", "b")).parse_args(["b", "--tsa"]).cases == ["b"]
    assert len(bench_kernel_probe3.CASES) == 8  # tiles 8-64 x accumulators 1-2
    with pytest.raises(SystemExit):
        common.parser("x", ("a",)).parse_args(["c"])


@pytest.fixture
def cpu_tools(monkeypatch):
    """The tools on the CPU at tiny shapes, with the card and its clock
    stubbed: every kernel wrapper takes its plain version."""
    monkeypatch.setattr(common, "require_cuda", lambda: torch.device("cpu"))
    monkeypatch.setattr(common, "card_line", lambda: "cpu")

    def time_ms(fn, reps):
        return 1.0, fn()

    monkeypatch.setattr(common, "time_ms", time_ms)
    sca, tsa = common.sca_shape, common.tsa_shape
    monkeypatch.setattr(common, "sca_shape", lambda q=16000, levels=common.SCA_LEVELS: sca(
        24, tuple((hh // 8, ww // 8) for hh, ww in levels)))
    monkeypatch.setattr(common, "tsa_shape", lambda q=40000: tsa(20))
    monkeypatch.setattr(bench_dma_gather, "SHAPE", (6, 48, 32))


@pytest.mark.parametrize("tool,argv,n", [
    (bench_msda_kernel, [], 5),
    (bench_kernel_probe3, ["t16a1", "t64a2"], 2),
    (bench_kernel_probe, [], 4),
    (bench_hi_probe, ["--tsa"], 4),
    (bench_msda_decompose, [], 4),
    (bench_dma_gather, [], 2),
], ids=lambda v: v.__name__.rsplit(".", 1)[1] if hasattr(v, "__name__") else None)
def test_tool_main_end_to_end_on_the_cpu(cpu_tools, capsys, tool, argv, n):
    records = tool.main(argv)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == records and len(records) == n
    for r in records:
        assert r["ms"] == 1.0 and r["card"] == "cpu" and r["bound_by"] in ("bytes", "operations")
        assert r["bound_ms"] > 0 and r["launches"] == 0  # plain versions launch nothing
        assert r["max_abs_err"] <= 1e-6 * max(r["scale"], 1.0)
        if "bitwise_equal" in r:
            assert r["bitwise_equal"]


@pytest.mark.parametrize("entry", ["build_model", "train_batch", "SyntheticVideo"])
def test_entry_points_default_to_the_card(entry):
    """Called with no device, they ask for the card and raise without one."""
    _no_card()
    from bevformer_torch.configs import get_config
    from bevformer_torch.data import SyntheticVideo, train_batch
    from bevformer_torch.runtime import build_model

    cfg = get_config("bevformer_base")
    call = dict(build_model=lambda: build_model(cfg, {}), train_batch=lambda: train_batch(cfg),
                SyntheticVideo=lambda: SyntheticVideo(cfg))[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
