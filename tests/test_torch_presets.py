"""The other v1 presets (bevformer_small, bevformer_tiny, bevformer_tiny_fp16)
and conv-BN folding in the port, against the JAX package on the CPU.

* Each preset equals JAX's field by field.
* Two mini detectors cut from the presets (R10, 16 x 16 BEV, 2 + 2 layers,
  100 queries, 96 x 160 network input, everything else the preset's):
  tiny's here (pytorch style, no DCN, one FPN level, dense SCA, RGB
  normalisation) and small's in `tests/test_torch_presets_small.py` (caffe
  style, DCN in stages 3-4, one level, SCA capacity 0.25), each file on its
  own worker. Each runs
  a 3-frame video with a scene reset through both `VideoEvaluator`s
  (bev_embed, cls and bbox to 1e-3 of scale, the decoded boxes as in
  `tests/test_torch_slice.py`) and one training step in eval mode as
  `tests/test_torch_train_step.py` does (the Hungarian matches equal, every
  loss term and every trainable gradient to 1e-3 of scale). Both sides load
  the JAX init with seeded noise on the layers it zero-initialises.
* `fuse_conv_bn`: the folded model's frame equals the unfolded one's to
  1e-5 of scale, and its folded weights and biases equal those of the JAX
  package's `fuse_conv_bn` on the same weights; `tools.test
  --fuse-conv-bn` gives the unfolded run's boxes.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bevformer_tpu.configs import get_config as jax_get_config
from bevformer_tpu.runtime.fuse import fuse_conv_bn as jax_fuse_conv_bn
from bevformer_torch.configs import BEVFormerConfig, DataConfig, OptimConfig, get_config
from bevformer_torch.core.assigner import hungarian_match
from bevformer_torch.data import SyntheticVideo, train_batch
from bevformer_torch.models.resnet import FrozenBN
from bevformer_torch.runtime import (
    VideoEvaluator,
    build_model,
    fuse_conv_bn,
    label_params,
    loss_fn,
    state_dict_from_jax,
)
from bevformer_torch.runtime.fuse import ChannelAdd
from tests.test_torch_slice import _match_boxes, _NumpyFrames, _TracedJaxEvaluator
from tests.test_torch_train_step import jax_batch, jax_deterministic_loss, jax_params
from tests.torch_port_helpers import assert_close, port_config, to_numpy_tree

TOL = 1e-3
FUSE_TOL = 1e-5
PRESETS = ("bevformer_small", "bevformer_tiny", "bevformer_tiny_fp16")


def mini(name: str):
    """The JAX preset `name` at mini size: R10, 16 x 16 BEV, 2 + 2 layers,
    a 96 x 160 network input at the preset's scale, exact paths."""
    jcfg = jax_get_config(name)
    scale = jcfg.data.scale
    return jcfg.replace(
        name=f"mini_{name}", backbone_depth=10, bev_h=16, bev_w=16, encoder_layers=2,
        decoder_layers=2, num_query=100, fused_msda="off", fused_dcn="off", use_grid_mask=False,
        max_gt=16,
        data=dataclasses.replace(jcfg.data, raw_size=(round(96 / scale), round(160 / scale))),
    )


def _fields(cfg) -> dict:
    """The port's fields of a config (the port's or the JAX package's), the
    nested data and optim configs field by field."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(BEVFormerConfig)
           if f.name not in ("data", "optim")}
    for sub, cls in (("data", DataConfig), ("optim", OptimConfig)):
        out.update({f"{sub}.{f.name}": getattr(getattr(cfg, sub), f.name)
                    for f in dataclasses.fields(cls)})
    return out


@pytest.mark.parametrize("name", PRESETS)
def test_preset_equals_jax_field_by_field(name):
    ours, ref = _fields(get_config(name)), _fields(jax_get_config(name))
    assert ours == ref, {k: (ours[k], ref[k]) for k in ours if ours[k] != ref[k]}
    assert get_config(name) == port_config(jax_get_config(name))


def test_tiny_keeps_the_transformers_rotate_center():
    """The reference and the JAX package leave rotate_center at the
    transformer's default (100, 100) at every BEV size."""
    for name in PRESETS:
        assert get_config(name).rotate_center == (100.0, 100.0), name


def preset_runs(name: str) -> dict:
    """Both frameworks' video and eval-mode training step on `mini(name)`."""
    jcfg = mini(name)
    cfg = port_config(jcfg)
    assert cfg.dtype == "float32"
    video = SyntheticVideo(cfg, scene_lengths=(2, 1), seed=5, device="cpu")
    batch = train_batch(cfg, seed=6, device="cpu", scene_break_at=1)
    jb = jax_batch(batch)
    jmodel, params = jax_params(jcfg, jb, seed=3)

    jev = _TracedJaxEvaluator(jmodel, params)
    jres = jev.run(_NumpyFrames(video), progress_every=0)
    # blocked on at once: JAX's matcher calls back into JAX from a host
    # callback, which can deadlock with JAX work dispatched meanwhile
    (_, (jlosses, jpreds)), jgrads = jax.block_until_ready(jax.jit(jax.value_and_grad(
        lambda p: jax_deterministic_loss(jmodel, p, jb), has_aux=True))(params))

    model = build_model(cfg, state_dict_from_jax(params, jcfg), "cpu")
    preds = []
    hook = model.register_forward_hook(lambda m, i, out: preds.append(out))
    res = VideoEvaluator(model).run(video, progress_every=0)
    hook.remove()

    labels = label_params(model, cfg.optim.frozen_stages)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    train_preds = []
    hook = model.register_forward_hook(
        lambda m, i, out: train_preds.append(out) if isinstance(out, dict) else None)
    total, losses = loss_fn(model.eval(), batch)
    total.backward()
    hook.remove()
    return dict(
        cfg=cfg, jcfg=jcfg, params=params, video=video, batch=batch, jb=jb, model=model,
        labels=labels, jtrace=jev.trace, jres=jres, preds=preds, res=res,
        losses=losses, train_preds=train_preds[0], jpreds=jax.tree.map(np.asarray, jpreds),
        jlosses=jax.tree.map(np.asarray, jlosses),
        jgrads=state_dict_from_jax(to_numpy_tree(jgrads), jcfg),
    )


@pytest.fixture(scope="module")
def runs():
    return preset_runs("bevformer_tiny")


def check_structure(runs):
    """The mini detector has the preset's structure: one FPN level, the
    backbone style, DCN where the preset has it, SCA dense or routed."""
    cfg, model = runs["cfg"], runs["model"]
    assert cfg.num_feature_levels == 1 and len(model.img_neck.fpn_convs) == 1
    block = model.img_backbone.layer2[0]
    caffe = cfg.backbone_style == "caffe"
    assert (block.conv1.stride, block.conv2.stride) == (
        ((2, 2), (1, 1)) if caffe else ((1, 1), (2, 2)))
    assert model.pts_bbox_head.transformer.level_embeds.shape == (1, cfg.embed_dims)
    assert (cfg.sca_capacity_ratio == 0) == (cfg.name == "mini_bevformer_tiny")


def check_frame(runs, frame):
    ref, ours = runs["jtrace"][frame], runs["preds"][frame]
    for key in ("bev_embed", "all_cls_scores", "all_bbox_preds"):
        assert_close(ours[key], ref[key], TOL, f"{key}[{frame}]")
    assert runs["res"][frame]["token"] == runs["jres"][frame]["token"]
    _match_boxes(runs["res"][frame], runs["jres"][frame], f"frame {frame}")


def check_train_step(runs):
    """Matches, loss terms and gradients of one eval-mode training step."""
    cfg, batch, jb = runs["cfg"], runs["batch"], runs["jb"]
    ours, ref = runs["train_preds"], runs["jpreds"]
    from bevformer_tpu.core.assigner import hungarian_match as jax_match

    for lid in range(cfg.decoder_layers):
        a = hungarian_match(ours["all_cls_scores"][lid].detach(),
                            ours["all_bbox_preds"][lid].detach(),
                            batch.gt_boxes, batch.gt_labels, batch.num_gt)
        # one jitted call, blocked on (see preset_runs)
        b = jax.block_until_ready(jax.jit(jax_match)(
            jnp.asarray(ref["all_cls_scores"][lid]), jnp.asarray(ref["all_bbox_preds"][lid]),
            jb.gt_boxes, jb.gt_labels, jb.num_gt))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"layer {lid}")
    assert set(runs["losses"]) == set(runs["jlosses"])
    for key, v in runs["jlosses"].items():
        assert_close(runs["losses"][key], v, TOL, key)
    checked = 0
    for name, p in runs["model"].named_parameters():
        if runs["labels"][name] == "frozen":
            assert p.grad is None, name
            continue
        assert_close(p.grad, runs["jgrads"][name], TOL, name)
        checked += 1
    assert checked > 100


def check_fuse_conv_bn(runs):
    """The folded model gives the unfolded frame to 1e-5 of scale; every
    folded conv weight equals JAX's folded kernel, every bias JAX's folded
    BN bias (1e-6 of scale); no FrozenBN is left and each DCN keeps a
    per-channel add."""
    cfg, jcfg = runs["cfg"], runs["jcfg"]
    sd = state_dict_from_jax(runs["params"], jcfg)
    model = build_model(cfg, sd, "cpu")
    sample = runs["video"].get_test_sample(0)
    ref = []
    hook = model.register_forward_hook(lambda m, i, out: ref.append(out))
    VideoEvaluator(model).infer_frame(sample)
    hook.remove()

    fuse_conv_bn(model)
    assert not any(isinstance(m, FrozenBN) for m in model.modules())
    adds = [m for m in model.modules() if isinstance(m, ChannelAdd)]
    assert len(adds) == len(cfg.backbone_dcn_stages)  # one block per stage at R10
    folded = []
    hook = model.register_forward_hook(lambda m, i, out: folded.append(out))
    VideoEvaluator(model).infer_frame(sample)
    hook.remove()
    for key in ("bev_embed", "all_cls_scores", "all_bbox_preds"):
        assert_close(folded[0][key], ref[0][key], FUSE_TOL, key)

    jsd = state_dict_from_jax(to_numpy_tree(jax_fuse_conv_bn(
        {"params": runs["params"]["params"]})), jcfg)
    ours = model.state_dict()
    convs = [k for k in sd if k.startswith("img_backbone.") and k.endswith(".weight")
             and sd[k].ndim == 4 and "conv_offset" not in k]
    assert len(convs) == 1 + 4 * 3 + 4  # stem, 3 per block, 4 downsamples
    for key in convs:
        assert_close(ours[key], jsd[key], 1e-6, key)
        bn = key.replace("conv", "bn").replace("downsample.0", "downsample.1")
        bias = key[:-len("weight")] + "bias"
        if bias not in ours:  # a DCN: the add stays behind
            bias = bn.replace(".weight", ".bias")
        assert_close(ours[bias], jsd[bn.replace(".weight", ".bias")], 1e-6, bias)


def test_mini_preset_structure(runs):
    check_structure(runs)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_video_frame_matches_jax(runs, frame):
    check_frame(runs, frame)


def test_train_step_matches_jax(runs):
    check_train_step(runs)


def test_fuse_conv_bn_keeps_the_frame_and_matches_jax(runs):
    check_fuse_conv_bn(runs)


def test_tools_test_fuse_conv_bn_gives_the_same_boxes(tmp_path):
    """`tools.test --fuse-conv-bn` at tiny's mini size on a synthetic root:
    the decoded boxes of every frame equal the unfolded run's (scores to
    1e-4, boxes to 1e-3 of scale, matched as sets)."""
    import json

    from bevformer_torch.tools import create_data, test as test_cli

    data = str(tmp_path / "data")
    create_data.main(["synth", "--out-dir", data, "--scenes", "2", "--frames", "2",
                      "--img-w", "320", "--img-h", "192"])
    opts = ["backbone_depth=10", "bev_h=16", "bev_w=16", "encoder_layers=2",
            "decoder_layers=2", "data.raw_size=(192,320)"]
    outs = {}
    for tag, more in (("plain", []), ("fused", ["--fuse-conv-bn"])):
        out = str(tmp_path / f"{tag}.json")
        test_cli.main(["bevformer_tiny", "--data-root", data, "--device", "cpu", "--out", out,
                       "--eval", "none", *more, "--cfg-options", *opts])
        with open(out) as f:
            outs[tag] = json.load(f)
    assert len(outs["plain"]) == len(outs["fused"]) == 2
    for a, b in zip(outs["fused"], outs["plain"]):
        assert a["token"] == b["token"]
        _match_boxes({k: np.asarray(a[k]) for k in ("boxes_3d", "scores_3d", "labels_3d")},
                     {k: np.asarray(b[k]) for k in ("boxes_3d", "scores_3d", "labels_3d")},
                     a["token"])
