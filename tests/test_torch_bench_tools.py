"""The port's model measuring tools (`bevformer_torch/tools/benchmark.py`
and the `bench_*` tools of whole modules) on the CPU, against the JAX
package where they compute something the JAX tools compute: the seeded
example frame equals `__graft_entry__._example_inputs`; `benchmark`'s frame
chain, the components of `bench_components` and the encoder of
`bench_enc_only` equal JAX `BEVFormer.apply` and `BEVFormerEncoder.apply`
on the same weights (the JAX init with seeded noise on the layers it
zero-initialises, bridged by `state_dict_from_jax`) at the mini size of
`tests/test_torch_slice.py`; two batched streams equal their batch-1 runs;
and each tool's JSON line has its keys (the tools run on the CPU through
their `run`, the card stubbed).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _example_inputs
from bevformer_tpu.configs import BEVFormerConfig as JaxConfig
from bevformer_tpu.configs import DataConfig as JaxData
from bevformer_tpu.models import BEVFormer as JaxBEVFormer
from bevformer_tpu.models.encoder import BEVFormerEncoder as JaxEncoder
from bevformer_torch.runtime import VideoEvaluator, build_model, state_dict_from_jax
from bevformer_torch.runtime.checkpoint import encoder_state_dict
from bevformer_torch.tools import (
    audit_sca_capacity,
    bench_components,
    bench_dcn,
    bench_enc_only,
    bench_train2,
    bench_train_bisect,
    bench_train_step,
    bench_train_v2,
    bench_v2,
    benchmark,
    common,
)
from tests.torch_port_helpers import assert_close, perturb, port_config, to_numpy_tree

TOL = 1e-4
STREAM_TOL = 1e-5
FRAMES = 3

JCFG = JaxConfig(
    name="mini_base", backbone_depth=10, bev_h=16, bev_w=16,
    encoder_layers=2, decoder_layers=2, sca_capacity_ratio=0.25,
    fused_msda="off", fused_dcn="off", use_grid_mask=False,
    data=JaxData(raw_size=(96, 160)),
)
MINI = ["--cfg-options", "backbone_depth=10", "bev_h=16", "bev_w=16", "encoder_layers=2",
        "decoder_layers=2", "data.raw_size=(96,160)"]
MINI_V2 = ["--cfg-options", "backbone_depth=10", "bev_h=8", "bev_w=8", "encoder_layers=1",
           "decoder_layers=2", "num_query=12", "data.raw_size=(640,64)"]


def jax_inputs(inputs):
    return [jnp.asarray(t.numpy()) for t in inputs]


@pytest.mark.parametrize("bs", [1, 2])
def test_example_inputs_equal_the_jax_packages(bs):
    cfg = port_config(JCFG)
    ours = common.example_inputs(cfg, bs, "cpu")
    ref = _example_inputs(JCFG, bs=bs)
    names = ("images", "can_bus", "lidar2img", "prev_bev", "has_prev")
    for name, a, b in zip(names, ours, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.fixture(scope="module")
def mini():
    """The mini detector on both sides, on the JAX init with noise."""
    cfg = port_config(JCFG)
    jmodel = JaxBEVFormer(cfg=JCFG)
    jin = _example_inputs(JCFG)
    params = to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), *jin))
    rng = np.random.RandomState(0)
    perturb(params, rng, names=("sampling_offsets", "attention_weights"), std=0.02)
    perturb(params, rng, names=("conv_offset",), std=1e-3)
    model = build_model(cfg, state_dict_from_jax(params, JCFG), "cpu")
    return dict(cfg=cfg, jmodel=jmodel, params=params, model=model)


def test_benchmark_frame_chain_matches_jax(mini):
    """`benchmark.frames` over 3 frames (prev_bev threaded, has_prev true
    after the first) against JAX `BEVFormer.apply` threaded the same way."""
    cfg, jmodel, params = mini["cfg"], mini["jmodel"], mini["params"]
    inputs = common.example_inputs(cfg, 1, "cpu")
    chain = benchmark.frames(VideoEvaluator(mini["model"]), inputs)
    apply = jax.jit(jmodel.apply)
    images, can_bus, l2i, prev, has = jax_inputs(inputs)
    for i in range(FRAMES):
        bev, _ = next(chain)
        ref = apply(params, images, can_bus, l2i, prev, has)
        assert_close(bev, np.asarray(ref["bev_embed"]), TOL, f"bev_embed[{i}]")
        prev, has = ref["bev_embed"].astype(jnp.float32), jnp.ones_like(has)


def test_streams_equal_their_batch_one_runs(mini):
    """At --streams 2 each stream's BEV and decoded boxes over 3 frames equal
    those of the same stream's inputs run at batch 1."""
    cfg, model = mini["cfg"], mini["model"]
    both = common.example_inputs(cfg, 2, "cpu")
    runs = [benchmark.frames(VideoEvaluator(model), both)]
    runs += [benchmark.frames(VideoEvaluator(model), [t[s:s + 1] for t in both]) for s in (0, 1)]
    for i in range(FRAMES):
        (bev2, dec2), *alone = [next(r) for r in runs]
        for s, (bev1, dec1) in enumerate(alone):
            assert_close(bev2[s:s + 1], bev1, STREAM_TOL, f"frame {i} stream {s} bev")
            _match_decoded({k: v[s] for k, v in dec2.items()}, {k: v[0] for k, v in dec1.items()},
                           f"frame {i} stream {s}")


def _match_decoded(ours, ref, name):
    """Decoded top-k picks agree as sets: scores to STREAM_TOL, and each
    reference box has a box of its label and score in ours within
    STREAM_TOL of the boxes' scale (near-equal scores may come in either
    order)."""
    assert_close(ours["scores"], ref["scores"], STREAM_TOL, f"{name} scores")
    boxes, labels, scores = ours["bboxes"].numpy(), ours["labels"].numpy(), ours["scores"].numpy()
    scale = float(np.abs(ref["bboxes"].numpy()).max())
    used = np.zeros(len(scores), bool)
    for box, label, score, valid in zip(ref["bboxes"].numpy(), ref["labels"].numpy(),
                                        ref["scores"].numpy(), ref["valid"].numpy()):
        cand = np.flatnonzero(~used & (labels == label) & (np.abs(scores - score) <= STREAM_TOL))
        err = np.abs(boxes[cand] - box).max(-1) if len(cand) else np.array([np.inf])
        assert err.min() <= STREAM_TOL * scale, f"{name}: a box has no match ({err.min():.3e})"
        pick = cand[np.argmin(err)]
        assert bool(ours["valid"][pick]) == bool(valid), f"{name}: valid flags differ"
        used[pick] = True


def test_components_match_jax(mini):
    """`bench_components`' three calls against JAX's `extract_feat`,
    `only_bev=True` and full apply (has_prev true, zero prev_bev)."""
    cfg, jmodel, params = mini["cfg"], mini["jmodel"], mini["params"]
    inputs = common.example_inputs(cfg, 1, "cpu")
    calls = bench_components.components(mini["model"], inputs)
    images, can_bus, l2i, prev, has = jax_inputs(inputs)
    has = jnp.ones_like(has)
    with torch.no_grad():
        feats, bev, full = (calls[k]() for k in ("backbone_neck", "bev_only", "full"))
    jfeats = jax.jit(lambda p, x: jmodel.apply(p, x, method="extract_feat"))(params, images)
    assert len(feats) == len(jfeats) == cfg.num_feature_levels
    for lvl, (a, b) in enumerate(zip(feats, jfeats)):
        b = np.asarray(b)  # [bs, cams, h, w, e]; ours [bs * cams, e, h, w]
        assert_close(a.permute(0, 2, 3, 1).reshape(b.shape), b, TOL, f"level {lvl}")
    jbev = jax.jit(lambda p: jmodel.apply(p, images, can_bus, l2i, prev, has, only_bev=True))(
        params)
    assert_close(bev, np.asarray(jbev), TOL, "bev_only")
    ref = jax.jit(lambda p: jmodel.apply(p, images, can_bus, l2i, prev, has))(params)
    for key in ("bev_embed", "all_cls_scores", "all_bbox_preds"):
        assert_close(full[key], np.asarray(ref[key]), TOL, key)


@pytest.mark.parametrize("layers", [1, 2])
def test_encoder_alone_matches_jax(layers):
    """`bench_enc_only`'s encoder on its fixed seeded inputs against JAX
    `BEVFormerEncoder.apply` on the same weights."""
    cfg = port_config(JCFG, encoder_layers=layers)
    args = bench_enc_only.encoder_inputs(cfg, "cpu")
    tensors, static = args[:7], args[7:]
    jargs = jax_inputs(tensors)
    enc = JaxEncoder(
        num_layers=layers, embed_dims=cfg.embed_dims, num_heads=cfg.num_heads,
        feedforward_channels=cfg.feedforward_channels, num_cams=cfg.data.num_cams,
        num_levels=cfg.num_feature_levels, num_points_in_pillar=cfg.num_points_in_pillar,
        pc_range=cfg.pc_range, sca_capacity_ratio=cfg.sca_capacity_ratio, fused_msda="off",
    )
    params = to_numpy_tree(jax.jit(enc.init, static_argnums=(8, 9, 10, 11))(
        jax.random.PRNGKey(1), *jargs, *static))
    perturb(params, np.random.RandomState(1), names=("sampling_offsets", "attention_weights"),
            std=0.02)
    ref = jax.jit(enc.apply, static_argnums=(8, 9, 10, 11))(params, *jargs, *static)
    ours = bench_enc_only.build_encoder(
        cfg, layers, encoder_state_dict(params["params"], layers), "cpu")
    with torch.no_grad():
        out = ours(*args)
    assert_close(out, np.asarray(ref), TOL, f"encoder L{layers}")


def test_level_shapes_are_the_fpn_levels():
    from bevformer_torch.configs import get_config

    assert bench_enc_only.level_shapes(get_config("bevformer_base")) == (
        (116, 200), (58, 100), (29, 50), (15, 25))


KEYS = {"metric", "value", "unit", "vs_baseline", "dtype", "tf32", "peak_gib", "launches",
        "card", "tool"}
TIMED = {"ms_median", "ms_min", "ms_max", "ms", "launches_per_call", "clock"}


@pytest.mark.parametrize("tool,argv,extra", [
    (benchmark, ["bevformer_base", "--samples", "2", *MINI],
     {"frame_ms_median", "streams", "max_capacity_clipped", "max_visible", "sca_capacity"}),
    (bench_train_step, ["bevformer_base", "--steps", "1", *MINI], {"loss", "use_remat"}),
    (bench_v2, ["bevformerv2-r50-t1", "--samples", "1", *MINI_V2], {"frames"}),
    (bench_train_v2, ["bevformerv2-r50-t1", "--iters", "1", *MINI_V2], {"loss", "rung"}),
    (bench_components, ["bevformer_base", "--reps", "1", *MINI],
     {"cases", "encoder_ms", "decoder_head_ms"}),
    (bench_enc_only, ["bevformer_base", "--layers", "1", "2", "--reps", "1", *MINI], {"cases"}),
    (bench_enc_only, ["bevformer_base", "--glue", "--reps", "1", *MINI], {"cases"}),
    (bench_dcn, ["--reps", "1", *MINI], {"cases", "dcn_minus_plain_ms"}),
    (bench_train2, ["bevformer_base", "backbone", "bev1", "full", "--reps", "1", *MINI],
     {"cases", "use_remat"}),
    (bench_train_bisect, ["bevformer_base", "--reps", "1", *MINI], {"cases"}),
    (bench_train_bisect, ["bevformer_base", "--finer", "--reps", "1", *MINI], {"cases"}),
], ids=["benchmark", "train_step", "v2", "train_v2", "components", "enc_only", "glue", "dcn",
        "train2", "bisect", "bisect_finer"])
def test_tool_json_line(monkeypatch, capsys, tool, argv, extra):
    """Each tool's `main` on the CPU (the card stubbed) prints one JSON line
    with the shared keys, its timing's fields and its own, on the host clock
    and without a card's name."""
    import json

    monkeypatch.setattr(common, "require_cuda", lambda: torch.device("cpu"))
    rec = tool.main(argv)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert lines == [rec]
    assert KEYS | TIMED | extra <= set(rec), sorted((KEYS | TIMED | extra) - set(rec))
    assert rec["card"] == "cpu" and rec["clock"] == "host" and rec["peak_gib"] is None
    assert rec["dtype"] == "float32" and np.isfinite(rec["value"]) and rec["value"] > 0
    for case in rec.get("cases", {}).values():
        assert TIMED <= set(case) and case["ms_median"] > 0
    if tool is benchmark:
        assert rec["vs_baseline"] == pytest.approx(rec["value"] / 3.0)
        assert rec["value"] == pytest.approx(1e3 / rec["frame_ms_median"])
        assert len(rec["ms"]) == 2 and rec["max_capacity_clipped"] == 0
        assert rec["routings"] == benchmark.WARMUP  # counted outside the timed frames
    if tool is bench_train_bisect and "--finer" not in argv:
        assert set(rec["cases"]) == set(bench_train_bisect.CASES)


def test_benchmark_metric_names_the_streams_and_the_baseline():
    one = benchmark.metric_name("bevformer_base", "float32", 1, "cpu")
    many = benchmark.metric_name("bevformer_base", "bfloat16", 4, "cpu")
    assert "AGGREGATE" not in one and "AGGREGATE frames/sec of 4" in many
    for name in (one, many):
        assert "ESTIMATED A100" in name and "3.0" in name


def test_audit_json_line(monkeypatch, capsys):
    monkeypatch.setattr(common, "require_cuda", lambda: torch.device("cpu"))
    rec = audit_sca_capacity.main([])
    assert KEYS <= set(rec) and set(rec["cases"]) == {"base_synthetic", "base_real",
                                                      "tiny_synthetic"}
    assert rec["value"] == max(c["max_query_fraction"] for c in rec["cases"].values())


def _tool_runs():
    import chip_smoke

    return chip_smoke.TOOL_RUNS


@pytest.mark.parametrize("name,argv", _tool_runs(), ids=lambda v: v if isinstance(v, str) else
                         " ".join(v) or "-")
def test_chip_smoke_tool_runs_parse(monkeypatch, name, argv):
    """Each of `chip_smoke.py` phase 20's runs names a tool whose `main`
    takes its arguments, and asks for the card right after parsing them."""
    from importlib import import_module

    class Parsed(Exception):
        pass

    def stop():
        raise Parsed

    monkeypatch.setattr(common, "require_cuda", stop)
    with pytest.raises(Parsed):
        import_module(f"bevformer_torch.tools.{name}").main(argv)
