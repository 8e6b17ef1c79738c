"""BEVFormerV2 inference in the port against the JAX package, on the CPU.

A mini V2 detector with the values of `tests/test_model_v2.py::
mini_v2_config` (R10 with BatchNorm, 3 inputs to the neck, 8 x 8 BEV, 1
encoder and 2 decoder layers, 12 queries in 3 GroupDETR groups), the real
R10 widths (512, 1024, 2048) into the neck and the DD3D levels on
(`num_mono_levels=5`: the neck's two extra levels are built and computed),
on the JAX exact paths (`fused_msda="off"`). t2-shaped (frames (-1, 0),
ResNetFusion) and t1-shaped (frames (0,)) from one JAX init, with seeded
noise on the sampling layers and the BatchNorms' running statistics seeded
away from 0 and 1, carried by `state_dict_from_jax_v2`:

* the four presets equal JAX's field by field;
* the frame (bev, cls, bbox of every decoder layer) and the decoded boxes
  equal JAX's `VideoEvaluatorV2` at 1e-3 of scale, on a plain sample and on
  a flipped one with a rotated, scaled `bda_mat`; `bev_only` too;
* `bev_grid_sample`, `ResNetFusion` (with and without its downsample) and
  the 5-level FPN equal JAX's;
* no BatchNorm runs in train mode in `VideoEvaluatorV2` (and train mode
  would change the frame);
* a reference-layout V2 `.pth` (JAX's `export_reference_state_dict_v2`,
  with a DD3D head's `fcos3d_bbox_head.*` keys) loads through
  `load_reference_pth`, the DD3D head with the rest, and gives the same
  frame; any other unexpected or missing key raises;
* `fuse_conv_bn` keeps the frame to 1e-5 of scale, and its folded weights
  equal JAX's `fuse_conv_bn(variables)`;
* the V2 call sites hand K1 what its CUDA wrapper accepts (training's
  K1 and K3/K4 too, `tests/test_torch_v2_train.py` holds the training
  step).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.configs import BEVFormerConfig as JaxConfig
from bevformer_tpu.configs import DataConfig as JaxData
from bevformer_tpu.configs import get_config as jax_get_config
from bevformer_tpu.core import coder as jax_coder
# imported here, not first inside a jit trace (the detector imports it in
# `setup`), which would stage its module-level constants as tracers
from bevformer_tpu.models import dd3d as jax_dd3d
from bevformer_tpu.models.detector_v2 import BEVFormerV2 as JaxBEVFormerV2
from bevformer_tpu.models.fpn import FPN as JaxFPN
from bevformer_tpu.models.transformer_v2 import ResNetFusion as JaxResNetFusion
from bevformer_tpu.models.transformer_v2 import bev_grid_sample as jax_bev_grid_sample
from bevformer_tpu.runtime.checkpoint import export_reference_state_dict_v2
from bevformer_tpu.runtime.eval import VideoEvaluatorV2 as JaxVideoEvaluatorV2
from bevformer_tpu.runtime.fuse import fuse_conv_bn as jax_fuse_conv_bn
from bevformer_torch.configs import get_config
from bevformer_torch.data.synth import rig_lidar2img
from bevformer_torch.models.fpn import FPN
from bevformer_torch.models.transformer_v2 import ResNetFusion, bev_grid_sample
from bevformer_torch.runtime import (
    VideoEvaluatorV2,
    build_model,
    fuse_conv_bn,
    load_reference_pth,
    state_dict_from_jax_v2,
)
from bevformer_torch.runtime.checkpoint import neck_state_dict
from tests.test_torch_presets import _fields
from tests.test_torch_slice import _match_boxes
from tests.torch_port_helpers import assert_close, perturb, port_config, t, to_numpy_tree

TOL = 1e-3
FUSE_TOL = 1e-5
EXACT_TOL = 1e-6
PRESETS = ("bevformerv2-r50-t1", "bevformerv2-r50-t1-base", "bevformerv2-r50-t2",
           "bevformerv2-r50-t8")
# flipped sample's unwarp: rotation by ~18 degrees, scale 1.05 (past the edges)
BDA = np.array([[0.9986, -0.3245], [0.3245, 0.9986]], np.float32)

JCFG2 = JaxConfig(
    name="mini_v2", version="v2", backbone_depth=10, backbone_out_indices=(1, 2, 3),
    backbone_dcn_stages=(), backbone_norm="bn", neck_in_channels=(512, 1024, 2048),
    num_feature_levels=3, num_mono_levels=5, bev_h=8, bev_w=8, encoder_layers=1,
    decoder_layers=2, num_query=12, group_detr=3, frames=(-1, 0), bbox_loss="smooth_l1",
    bbox_loss_weight=0.75, use_grid_mask=False, video_test_mode=False, sca_capacity_ratio=0.25,
    fused_msda="off", fused_dcn="off", data=JaxData(raw_size=(64, 128), queue_length=1),
)
JCFG1 = JCFG2.replace(name="mini_v2_t1", frames=(0,))


def seed_batch_stats(tree, rng):
    """Running statistics away from JAX's init (mean 0, var 1), in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            seed_batch_stats(v, rng)
        elif k == "mean":
            tree[k] = (v + rng.uniform(-0.5, 0.5, v.shape)).astype(np.float32)
        elif k == "var":
            tree[k] = (v * rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)


def with_dd3d(variables, jcfg):
    """The variables with a DD3D head's (`fcos3d_bbox_head`, JAX's init on
    seeded features), which the port's model holds wherever
    `num_mono_levels > 0` and inference never runs."""
    from tests.test_dd3d import _mk_targets

    h, w = jcfg.data.img_size
    feats = [jnp.zeros((6, h // s, w // s, jcfg.embed_dims)) for s in (8, 16, 32, 64, 128)]
    # jitted, as the JAX package inits its models (op by op, each operation
    # of the head compiles on its own)
    head = to_numpy_tree(jax.jit(lambda key, fs, ik, tg: jax_dd3d.NuscenesDD3D(cfg=jcfg).init(
        key, fs, ik, tg, train=False))(
        jax.random.PRNGKey(3), feats, jnp.tile(jnp.eye(3), (6, 1, 1)),
        _mk_targets(np.random.RandomState(0), 6, 2, w, h)))
    return {c: {**variables[c], "fcos3d_bbox_head": head[c]} for c in ("params", "batch_stats")}


class _TracedJaxEvaluatorV2(JaxVideoEvaluatorV2):
    """The JAX evaluator with each sample's head outputs and history BEVs
    kept (its step, returning them too)."""

    def __init__(self, model, variables):
        super().__init__(model, variables)
        c, cur = self.cfg, list(self.cfg.frames).index(0)
        self.trace = []

        def step(variables, images, lidar2img, flip, bda_mat):
            prev = [None if off == 0 else model.apply(
                variables, images[:, i], lidar2img[:, i], flip, bda_mat, method="bev_only")
                for i, off in enumerate(c.frames)]
            preds = model.apply(variables, images[:, cur], lidar2img[:, cur],
                                prev_bev_list=prev, flip=flip, bda_mat=bda_mat)
            dec = jax_coder.decode_batch(preds, max_num=self.max_num, num_classes=c.num_classes,
                                         post_center_range=c.post_center_range)
            return preds, prev, dec

        jitted = jax.jit(step)

        def traced(*args):
            preds, prev, dec = jitted(*args)
            self.trace.append(dict(jax.tree.map(np.asarray, preds),
                                   prev=[None if p is None else np.asarray(p) for p in prev]))
            return dec

        self._step = traced


def _samples(jcfg, rng):
    """A plain sample and a flipped one with a rotated, scaled unwarp."""
    h, w = jcfg.data.img_size
    n = len(jcfg.frames)
    l2i = np.stack([rig_lidar2img(w, h)] * n).astype(np.float32)
    plain = dict(images=rng.randn(n, 6, h, w, 3).astype(np.float32), lidar2img=l2i,
                 token="plain", flip=np.bool_(False), bda_mat=np.eye(2, dtype=np.float32))
    flipped = dict(images=rng.randn(n, 6, h, w, 3).astype(np.float32), lidar2img=l2i,
                   token="flipped", flip=np.bool_(True), bda_mat=BDA)
    return [plain, flipped]


def _port_run(model, samples):
    """Each sample's head outputs through `VideoEvaluatorV2`, and its results."""
    preds = []
    hook = model.register_forward_hook(lambda m, i, out: preds.append(out))
    try:
        res = [VideoEvaluatorV2(model).infer_sample(s) for s in samples]
    finally:
        hook.remove()
    return preds, res


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    jmodel = JaxBEVFormerV2(cfg=JCFG2)
    h, w = JCFG2.data.img_size
    variables = with_dd3d(to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 6, h, w, 3)),
        jnp.asarray(rig_lidar2img(w, h), jnp.float32)[None])), JCFG2)
    perturb(variables["params"], rng, names=("sampling_offsets", "attention_weights"), std=0.02)
    seed_batch_stats(variables["batch_stats"], rng)
    out = {}
    for tag, jcfg in (("t2", JCFG2), ("t1", JCFG1)):
        v = variables
        if tag == "t1":  # the same weights without the fusion
            v = {c: {**tree, "pts_bbox_head": {
                **tree["pts_bbox_head"], "transformer": {
                    k: x for k, x in tree["pts_bbox_head"]["transformer"].items()
                    if k != "fusion"}}} for c, tree in variables.items()}
        samples = _samples(jcfg, rng)
        jev = _TracedJaxEvaluatorV2(JaxBEVFormerV2(cfg=jcfg), v)
        jres = [jev.infer_sample(s) for s in samples]
        cfg = port_config(jcfg)
        model = build_model(cfg, state_dict_from_jax_v2(v, jcfg), "cpu")
        preds, res = _port_run(model, samples)
        out[tag] = dict(jcfg=jcfg, cfg=cfg, variables=v, samples=samples, jtrace=jev.trace,
                        jres=jres, model=model, preds=preds, res=res)
    return out


@pytest.mark.parametrize("name", PRESETS)
def test_preset_equals_jax_field_by_field(name):
    ours, ref = _fields(get_config(name)), _fields(jax_get_config(name))
    assert ours == ref, {k: (ours[k], ref[k]) for k in ours if ours[k] != ref[k]}
    assert get_config(name) == port_config(jax_get_config(name))


def check_frame(preds, res, jtrace, jres, name, tol=TOL):
    for key in ("bev_embed", "all_cls_scores", "all_bbox_preds"):
        assert_close(preds[key], jtrace[key], tol, f"{name} {key}")
    assert res["token"] == jres["token"]
    _match_boxes(res, jres, name)


@pytest.mark.parametrize("tag", ["t1", "t2"])
@pytest.mark.parametrize("sample", [0, 1], ids=["plain", "flipped_bda"])
def test_frame_matches_jax(setup, tag, sample):
    r = setup[tag]
    check_frame(r["preds"][sample], r["res"][sample], r["jtrace"][sample], r["jres"][sample],
                f"{tag} sample {sample}")


@pytest.mark.parametrize("sample", [0, 1], ids=["plain", "flipped_bda"])
def test_bev_only_matches_jax(setup, sample):
    r = setup["t2"]
    s = r["samples"][sample]
    with torch.no_grad():
        bev = r["model"].bev_only(t(s["images"][0])[None], t(s["lidar2img"][0])[None],
                                  torch.tensor([bool(s["flip"])]), t(s["bda_mat"])[None])
    assert_close(bev, r["jtrace"][sample]["prev"][0], TOL, "bev_only")


def test_query_groups_and_bn_statistics(setup):
    """The GroupDETR table holds every group and eval reads the first; the
    BNs hold the seeded statistics, and BNs in train mode (batch
    statistics) would give another frame."""
    r = setup["t2"]
    cfg = r["cfg"]
    model = copy.deepcopy(r["model"])
    assert model.pts_bbox_head.query_embedding.weight.shape[0] == cfg.num_query * cfg.group_detr
    assert r["preds"][0]["all_cls_scores"].shape[2] == cfg.num_query
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(float((m.running_var - 1).abs().max()) > 0.1 for m in bns)
    s = r["samples"][0]

    def frame():
        with torch.no_grad():
            return model(t(s["images"][1])[None], t(s["lidar2img"][1])[None], [None, None])

    ref = frame()
    for m in bns:
        m.train()
    batch_stats = frame()
    assert float((batch_stats["bev_embed"] - ref["bev_embed"]).abs().max()) > 1e-2


def test_no_batchnorm_runs_in_train_mode(setup):
    """Every BN call of `VideoEvaluatorV2` runs in eval mode (running
    statistics), also when the model comes in train mode."""
    model = copy.deepcopy(setup["t2"]["model"]).train()
    seen = []
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_hook(lambda m, i, o: seen.append(m.training))
    VideoEvaluatorV2(model).infer_sample(setup["t2"]["samples"][1])
    assert seen and not any(seen), f"{sum(seen)} of {len(seen)} BN calls in train mode"


def test_bev_grid_sample_matches_jax():
    """Rotated, scaled and shifted grids that reach past every edge, and
    the identity (within an ulp of each pixel, computed as JAX does)."""
    rng = np.random.RandomState(1)
    h, w, c = 8, 12, 5
    bev = rng.randn(h, w, c).astype(np.float32)
    ys = (np.arange(h, dtype=np.float32) + 0.5) / h
    xs = (np.arange(w, dtype=np.float32) + 0.5) / w
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    grid = np.stack([gx, gy], -1) * 2 - 1
    for m, shift in ((np.eye(2), 0.0), (BDA, 0.0), (np.array([[1.3, 0.4], [-0.5, 0.8]]), 0.3),
                     (np.array([[-1.0, 0.0], [0.0, 1.0]]), -0.2)):
        g = (np.einsum("ij,hwj->hwi", m, grid) + shift).astype(np.float32)
        ref = np.asarray(jax_bev_grid_sample(jnp.asarray(bev), jnp.asarray(g)))
        assert_close(bev_grid_sample(t(bev), t(g)), ref, EXACT_TOL, f"grid {m.tolist()}")
    ident = bev_grid_sample(t(bev), t(grid.astype(np.float32)))
    assert_close(ident, bev, EXACT_TOL, "identity")


def _resnet_fusion_state_dict(params, stats, num_layer):
    from bevformer_torch.runtime.checkpoint import _converters, _with_batch_stats

    merged = _with_batch_stats(params, stats)
    sd = {}
    _, conv, linear, norm = _converters(sd, merged)
    for i in range(num_layer):
        for n in (1, 2):
            conv(f"layers.{i}.conv{n}", f"block{i}/conv{n}")
            norm(f"layers.{i}.bn{n}", f"block{i}/bn{n}", running=True)
        if "downsample_conv" in merged[f"block{i}"]:
            conv(f"layers.{i}.downsample.0", f"block{i}/downsample_conv")
            norm(f"layers.{i}.downsample.1", f"block{i}/downsample_bn", running=True)
    linear("layer_norm.0", "out_fc")
    norm("layer_norm.1", "out_ln")
    return sd


@pytest.mark.parametrize("inter", [16, 24], ids=["same_width", "downsample"])
def test_resnet_fusion_matches_jax(inter):
    rng = np.random.RandomState(2)
    bs, h, w, e, frames = 1, 6, 5, 8, 2
    bevs = [rng.randn(bs, h * w, e).astype(np.float32) for _ in range(frames)]
    jmod = JaxResNetFusion(out_channels=e, inter_channels=inter, num_layer=3)
    v = to_numpy_tree(jmod.init(jax.random.PRNGKey(0), [jnp.asarray(b) for b in bevs], h, w))
    perturb(v["params"], rng, names=("bn1", "bn2", "downsample_bn"), std=0.2)
    seed_batch_stats(v["batch_stats"], rng)
    ref = np.asarray(jmod.apply(v, [jnp.asarray(b) for b in bevs], h, w))
    mod = ResNetFusion(frames * e, e, inter, 3)
    keys = mod.load_state_dict({k: t(x) for k, x in _resnet_fusion_state_dict(
        v["params"], v["batch_stats"], 3).items()}, strict=False)
    assert not keys.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in keys.missing_keys)
    assert (mod.layers[0].downsample is not None) == (inter != frames * e)
    with torch.no_grad():
        out = mod.eval()([t(b) for b in bevs], h, w)
    assert_close(out, ref, EXACT_TOL * 10, "ResNetFusion")


def test_fpn_extra_levels_match_jax():
    """Three inputs to five outputs: two stride-2 extra convs on the last
    output, a ReLU before the second."""
    rng = np.random.RandomState(3)
    chans, e = (8, 12, 16), 8
    xs = [rng.randn(2, 16 // 2 ** i, 24 // 2 ** i, c).astype(np.float32)
          for i, c in enumerate(chans)]
    jfpn = JaxFPN(in_channels=chans, out_channels=e, num_outs=5)
    p = to_numpy_tree(jfpn.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs]))["params"]
    ref = jfpn.apply({"params": p}, [jnp.asarray(x) for x in xs])
    fpn = FPN(chans, e, num_outs=5)
    fpn.load_state_dict({k: t(v) for k, v in neck_state_dict(p, 3, 5).items()})
    with torch.no_grad():
        outs = fpn([t(x).permute(0, 3, 1, 2) for x in xs])
    assert len(outs) == len(ref) == 5
    for lvl, (o, r) in enumerate(zip(outs, ref)):
        assert_close(o.permute(0, 2, 3, 1), np.asarray(r), EXACT_TOL * 10, f"level {lvl}")


@pytest.fixture(scope="module")
def dd3d_head():
    """A DD3D head's variables (zeros) of the DD3D init's shapes, for JAX's
    export to write its `fcos3d_bbox_head.*` keys."""
    from bevformer_tpu.models import dd3d
    from tests.test_dd3d import _mk_targets

    jcfg = JCFG2
    feats = [jnp.zeros((6, 8 // s, 16 // s, jcfg.embed_dims)) for s in (1, 2, 4, 8, 16)]
    targets = _mk_targets(np.random.RandomState(0), 6, 2, 16, 8)
    shapes = jax.eval_shape(lambda: dd3d.NuscenesDD3D(cfg=jcfg).init(
        jax.random.PRNGKey(0), feats, jnp.tile(jnp.eye(3), (6, 1, 1)), targets, train=False))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _reference_pth(r, head, tmp_path, extra=None, drop=None):
    """A model-zoo-layout checkpoint of the mini t2 weights: JAX's
    export with the DD3D head, each BN's num_batches_tracked, `extra`
    keys added and `drop` left out."""
    v = r["variables"]
    full = {c: {**v[c], "fcos3d_bbox_head": head[c]} for c in ("params", "batch_stats")}
    sd = {k: torch.from_numpy(np.array(x)) for k, x in
          export_reference_state_dict_v2(full, r["jcfg"]).items()}
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(100)
    sd.update(extra or {})
    if drop:
        del sd[drop]
    path = tmp_path / "v2.pth"
    torch.save({"meta": {}, "state_dict": sd}, path)
    return str(path), sum(k.startswith("fcos3d_bbox_head.") and not k.endswith("batches_tracked")
                          for k in sd)


def test_reference_pth_loads_and_gives_the_frame(setup, dd3d_head, tmp_path):
    """The DD3D head's keys load with the rest (`build_model` is strict)."""
    r = setup["t2"]
    path, mono = _reference_pth(r, dd3d_head, tmp_path)
    assert mono > 50
    sd = load_reference_pth(path)
    assert sum(k.startswith("fcos3d_bbox_head.") for k in sd) == mono
    model = build_model(r["cfg"], sd, "cpu")
    key = "fcos3d_bbox_head.fcos2d_head.cls_logits.weight"
    assert torch.equal(model.state_dict()[key], sd[key])
    preds, res = _port_run(model, r["samples"])
    for i in range(2):
        check_frame(preds[i], res[i], r["jtrace"][i], r["jres"][i], f".pth sample {i}")


@pytest.mark.parametrize("bad", ["unexpected", "missing"])
def test_reference_pth_with_other_keys_raises(setup, dd3d_head, tmp_path, bad):
    r = setup["t2"]
    if bad == "unexpected":
        path, _ = _reference_pth(r, dd3d_head, tmp_path,
                                 extra={"pts_bbox_head.extra.weight": torch.ones(3)})
    else:
        path, _ = _reference_pth(r, dd3d_head, tmp_path, drop="pts_bbox_head.transformer.fusion.layers.0."
                                                   "bn1.running_mean")
    with pytest.raises(RuntimeError, match="Unexpected key|Missing key"):
        build_model(r["cfg"], load_reference_pth(path), "cpu")


@pytest.mark.parametrize("tag", ["t1", "t2"])
def test_fuse_conv_bn_keeps_the_frame_and_matches_jax(setup, tag):
    r = setup[tag]
    sd = state_dict_from_jax_v2(r["variables"], r["jcfg"])
    model = fuse_conv_bn(build_model(r["cfg"], sd, "cpu"))
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    preds, res = _port_run(model, r["samples"])
    for i in range(2):
        for key in ("bev_embed", "all_cls_scores", "all_bbox_preds"):
            assert_close(preds[i][key], r["preds"][i][key], FUSE_TOL, f"{key} sample {i}")
        _match_boxes(res[i], r["res"][i], f"folded sample {i}")

    jsd = state_dict_from_jax_v2(to_numpy_tree(jax_fuse_conv_bn(r["variables"])), r["jcfg"])
    ours = model.state_dict()
    convs = [k for k in sd if k.endswith(".weight") and sd[k].ndim == 4
             and k.replace("conv", "bn").replace("downsample.0", "downsample.1") in
             {b[:-len("running_var")] + "weight" for b in sd if b.endswith("running_var")}]
    fusion = 6 if tag == "t2" else 0
    assert len(convs) == 1 + 4 * 3 + 4 + fusion  # stem, 3 per block, 4 downsamples, fusion
    for key in convs:
        assert_close(ours[key], jsd[key], EXACT_TOL, key)
        bn = key.replace("conv", "bn").replace("downsample.0", "downsample.1")
        assert_close(ours[key[:-len("weight")] + "bias"], jsd[bn.replace(".weight", ".bias")],
                     EXACT_TOL, key)


def test_fuse_conv_bn_refuses_train_mode(setup):
    model = build_model(setup["t1"]["cfg"], state_dict_from_jax_v2(
        setup["t1"]["variables"], JCFG1), "cpu").train()
    with pytest.raises(ValueError, match="eval mode"):
        fuse_conv_bn(model)


def test_call_sites_meet_the_kernel_contract(setup, monkeypatch):
    """Every msda call of a t2 sample (history encoder, current frame,
    decoder) hands K1 what its CUDA wrapper accepts."""
    from bevformer_torch.kernels import msda
    from bevformer_torch.models import attention

    calls = []

    def checked(value, shapes, loc, attw):
        msda._check(value, tuple(shapes), loc, attw)
        calls.append(tuple(loc.shape))
        return msda.ms_deform_attn_plain(value, shapes, loc, attw)

    monkeypatch.setattr(attention, "ms_deform_attn", checked)
    r = setup["t2"]
    VideoEvaluatorV2(r["model"]).infer_sample(r["samples"][1])
    c = r["cfg"]
    assert len(calls) == len(c.frames) * 2 * c.encoder_layers + c.decoder_layers


def test_video_test_mode_off_carries_nothing():
    """V2's `video_test_mode=False` in the v1 evaluator (the JAX
    `VideoEvaluator`'s reading): every frame starts without history, so a
    scene's second frame equals that frame run alone."""
    from bevformer_torch.data import SyntheticVideo
    from bevformer_torch.runtime import VideoEvaluator, init_state_dict

    cfg = get_config("bevformer_base", backbone_depth=10, backbone_dcn_stages=(), bev_h=8,
                     bev_w=8, encoder_layers=1, decoder_layers=1, num_query=10,
                     video_test_mode=False, data=dataclasses.replace(
                         get_config("bevformer_base").data, raw_size=(64, 96)))
    model = build_model(cfg, init_state_dict(cfg), "cpu")
    video = SyntheticVideo(cfg, scene_lengths=(2,), seed=1, device="cpu")
    preds = []
    model.register_forward_hook(lambda m, i, out: preds.append(out))
    VideoEvaluator(model).run(video, progress_every=0)
    VideoEvaluator(model).infer_frame(video.get_test_sample(1))
    assert torch.equal(preds[1]["bev_embed"], preds[2]["bev_embed"])
