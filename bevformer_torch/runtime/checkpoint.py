"""Weights for the port, keyed as the reference `.pth` state dict.

* `state_dict_from_jax(params, cfg)`: numpy-only port of
  `bevformer_tpu/runtime/checkpoint.py::export_reference_state_dict`. Its
  input is the JAX params pytree with numpy leaves; it unstacks the scanned
  backbone blocks (`layer{i}_rest`) and encoder layers by indexing.
* `vovnet_state_dict`, `rel_position_state_dict`, `mm_layer_state_dict`,
  `bev_head_state_dict`: JAX params (and batch_stats) of the modules no
  registered config builds (VoVNet V2-99, RelPositionEmbedding,
  MMBEVFormerLayer, BEVHead) -> the port's state dicts, keyed by the JAX
  module names (the reference has no `.pth` layout for them here).
* `state_dict_from_jax_v2(variables, cfg)`: the same for a BEVFormerV2
  (`export_reference_state_dict_v2`, :905): JAX `{'params',
  'batch_stats'}`, the BatchNorms' running statistics from `batch_stats`,
  the neck's extra levels, `ResNetFusion` and the DD3D head
  (`fcos3d_bbox_head`, :1093-1140; JAX's `box3d_depth` bias, which the
  reference does not have, is left out).
* `init_state_dict(cfg, seed)`: seeded numpy weights for every key, for
  runs with no JAX checkpoint at hand.
* `build_model(cfg, state_dict, device)`: the port's model for the config's
  version with those weights, on `device` (default: the card).
* `load_reference_pth(path)`: the state dict of a model-zoo `.pth` (or of a
  checkpoint of the port: the layout is the same), a V2 one's DD3D head
  included.
* `save_checkpoint` / `restore_checkpoint`: a training run's state in
  mmcv's checkpoint layout, and back.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from bevformer_torch.device import DEFAULT as DEFAULT_DEVICE
from bevformer_torch.device import resolve as resolve_device
from bevformer_torch.models import BEVFormer, BEVFormerV2
from bevformer_torch.models import dd3d
from bevformer_torch.models.attention import (
    CustomMSDeformableAttention,
    MSDeformableAttention3D,
    TemporalSelfAttention,
    grid_init_bias,
)
from bevformer_torch.models.head import bias_init_with_prob
from bevformer_torch.models.layers import _PackedProjection
from bevformer_torch.models.resnet import ARCH_SETTINGS, FrozenBN, ModulatedDeformConv
from bevformer_torch.runtime import distributed

StateDict = Dict[str, np.ndarray]


def _node(tree: Mapping, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _index(tree, i: int):
    """Slice the leading (scan) axis of every leaf."""
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _converters(sd: StateDict, root: Mapping = None):
    """Writers of reference-layout tensors into `sd`, reading from `tree`
    (default `root`) at a '/'-separated path."""

    def get(path: str, tree=root) -> np.ndarray:
        return np.asarray(_node(tree, path))

    def conv(dst, src, tree=root):  # HWIO -> OIHW
        sd[f"{dst}.weight"] = np.transpose(get(f"{src}/kernel", tree), (3, 2, 0, 1))

    def linear(dst, src, tree=root):  # [in, out] -> [out, in]
        sd[f"{dst}.weight"] = np.transpose(get(f"{src}/kernel", tree), (1, 0))
        sd[f"{dst}.bias"] = get(f"{src}/bias", tree)

    def norm(dst, src, tree=root, running=False):
        sd[f"{dst}.weight"] = get(f"{src}/scale", tree)
        sd[f"{dst}.bias"] = get(f"{src}/bias", tree)
        if running:
            sd[f"{dst}.running_mean"] = get(f"{src}/mean", tree)
            sd[f"{dst}.running_var"] = get(f"{src}/var", tree)

    return get, conv, linear, norm


def backbone_state_dict(bb: Mapping, depth: int, dcn_stages, prefix="") -> StateDict:
    """JAX `ResNet` params -> `models.resnet.ResNet` state dict."""
    sd: StateDict = {}
    get, conv, _, norm = _converters(sd)
    conv(f"{prefix}conv1", "stem_conv", bb)
    norm(f"{prefix}bn1", "stem_bn", bb, running=True)

    def block(dst: str, node: Mapping, use_dcn: bool):
        if use_dcn:
            wk = get("conv2/kernel", node)  # [9*in, out], rows (ky, kx, in)
            i, o = wk.shape[0] // 9, wk.shape[1]
            sd[f"{dst}.conv2.weight"] = np.transpose(wk.reshape(3, 3, i, o), (3, 2, 0, 1))
            conv(f"{dst}.conv2.conv_offset", "conv2/conv_offset", node)
            sd[f"{dst}.conv2.conv_offset.bias"] = get("conv2/conv_offset/bias", node)
        else:
            conv(f"{dst}.conv2", "conv2", node)
        conv(f"{dst}.conv1", "conv1", node)
        conv(f"{dst}.conv3", "conv3", node)
        for ib in (1, 2, 3):
            norm(f"{dst}.bn{ib}", f"bn{ib}", node, running=True)
        if "downsample_conv" in node:
            conv(f"{dst}.downsample.0", "downsample_conv", node)
            norm(f"{dst}.downsample.1", "downsample_bn", node, running=True)

    for stage, nblocks in enumerate(ARCH_SETTINGS[depth]):
        use_dcn = stage in dcn_stages
        block(f"{prefix}layer{stage + 1}.0", bb[f"layer{stage + 1}_block0"], use_dcn)
        for blk in range(1, nblocks):
            node = _index(bb[f"layer{stage + 1}_rest"]["block"], blk - 1)
            block(f"{prefix}layer{stage + 1}.{blk}", node, use_dcn)
    return sd


def neck_state_dict(neck: Mapping, num_ins: int, num_outs: int, prefix="") -> StateDict:
    """JAX `FPN` params -> `models.fpn.FPN` state dict."""
    sd: StateDict = {}
    get, conv, _, _ = _converters(sd)
    for i in range(num_ins):
        conv(f"{prefix}lateral_convs.{i}.conv", f"lateral{i}", neck)
        sd[f"{prefix}lateral_convs.{i}.conv.bias"] = get(f"lateral{i}/bias", neck)
    for i in range(num_outs):
        conv(f"{prefix}fpn_convs.{i}.conv", f"fpn{i}", neck)
        sd[f"{prefix}fpn_convs.{i}.conv.bias"] = get(f"fpn{i}/bias", neck)
    return sd


def _with_batch_stats(params: Mapping, stats: Mapping) -> dict:
    """The V2 params tree with each BatchNorm node (`<name>/bn/{scale, bias}`
    in params, `<name>/bn/{mean, var}` in batch_stats) replaced by one node
    `<name>/{scale, bias, mean, var}`, as a FrozenBN's params are."""
    out = {}
    for k, v in params.items():
        if not isinstance(v, Mapping):
            out[k] = v
        elif set(v) == {"bn"}:
            out[k] = {**v["bn"], **stats[k]["bn"]}
        else:
            out[k] = _with_batch_stats(v, stats.get(k, {}))
    return out


def dd3d_state_dict(params: Mapping, stats: Mapping, num_levels: int,
                    prefix: str = "fcos3d_bbox_head.") -> StateDict:
    """JAX `NuscenesDD3D` params and batch_stats -> `models.dd3d.
    NuscenesDD3D` state dict (reference keys, JAX `checkpoint.py:1093-1140`):
    each tower conv with one BatchNorm per level, the predictors (the
    FCOS3D ones wrapped at `.0`; `box3d_depth` without bias), the per-level
    scales and depth offsets as [1] tensors, and the depth constants."""
    sd: StateDict = {}
    get, conv, _, _ = _converters(sd, params)
    f2, f3 = f"{prefix}fcos2d_head", f"{prefix}fcos3d_head"

    def conv_bias(dst, src):
        conv(dst, src)
        sd[f"{dst}.bias"] = get(f"{src}/bias")

    for dst, src in ((f"{f2}.cls_tower", "cls_tower"), (f"{f2}.box2d_tower", "box2d_tower"),
                     (f"{f3}.box3d_tower", "box3d_tower")):
        for i in range(dd3d.NUM_CONVS):
            conv(f"{dst}.{i}", f"{src}/conv{i}")
            for lvl in range(num_levels):
                bn, node = f"{dst}.{i}.norm.{lvl}", f"{src}/bn{i}_l{lvl}"
                sd[f"{bn}.weight"] = get(f"{node}/scale")
                sd[f"{bn}.bias"] = get(f"{node}/bias")
                sd[f"{bn}.running_mean"] = get(f"{node}/mean", stats)
                sd[f"{bn}.running_var"] = get(f"{node}/var", stats)
    for nm in ("cls_logits", "box2d_reg", "centerness"):
        conv_bias(f"{f2}.{nm}", nm)
    for nm in ("box3d_quat", "box3d_ctr", "box3d_size", "box3d_conf"):
        conv_bias(f"{f3}.{nm}.0", nm)
    conv(f"{f3}.box3d_depth.0", "box3d_depth")
    for nm in ("attr_logits", "speed"):
        conv_bias(f"{prefix}{nm}", nm)
    for lvl in range(num_levels):
        sd[f"{f2}.scales_box2d_reg.{lvl}.scale"] = get(f"scale_box2d_l{lvl}").reshape(1)
        for name, src in (("proj_ctr", "proj_ctr"), ("size", "size"), ("conf", "conf"),
                          ("depth", "depth")):
            sd[f"{f3}.scales_{name}.{lvl}.scale"] = get(f"scale_{src}_l{lvl}").reshape(1)
        sd[f"{f3}.offsets_depth.{lvl}.bias"] = get(f"offset_depth_l{lvl}").reshape(1)
    sd[f"{f3}.mean_depth_per_level"] = np.asarray(dd3d.MEAN_DEPTH_PER_LEVEL[:num_levels],
                                                  np.float32)
    sd[f"{f3}.std_depth_per_level"] = np.asarray(dd3d.STD_DEPTH_PER_LEVEL[:num_levels],
                                                 np.float32)
    return sd


def vovnet_state_dict(variables: Mapping[str, Any], prefix: str = "") -> StateDict:
    """JAX `VoVNet` variables (`{'params'[, 'batch_stats']}`, numpy leaves;
    FrozenBN keeps its statistics in params, BatchNorm in batch_stats) ->
    `models.vovnet.VoVNet` state dict, keyed by the JAX module names."""
    from bevformer_torch.models.vovnet import V2_99

    params = variables["params"] if "params" in variables else variables
    p = _with_batch_stats(params, variables.get("batch_stats", {}))
    sd: StateDict = {}
    get, conv, _, norm = _converters(sd, p)

    def conv_norm(name):
        conv(f"{prefix}{name}.conv", f"{name.replace('.', '/')}/conv")
        norm(f"{prefix}{name}.bn", f"{name.replace('.', '/')}/bn", running=True)

    for i in (1, 2, 3):
        conv_norm(f"stem{i}")
    for stage, nblocks in enumerate(V2_99["block_per_stage"]):
        for blk in range(nblocks):
            name = f"stage{stage + 2}_block{blk}"
            for i in range(V2_99["layer_per_block"]):
                conv_norm(f"{name}.layer{i}")
            conv_norm(f"{name}.concat")
            conv(f"{prefix}{name}.ese.fc", f"{name}/ese/fc")
            sd[f"{prefix}{name}.ese.fc.bias"] = get(f"{name}/ese/fc/bias")
    return sd


def rel_position_state_dict(params: Mapping[str, Any], prefix: str = "") -> StateDict:
    """JAX `RelPositionEmbedding` params -> `models.position_embedding.
    RelPositionEmbedding` state dict (`fc` has no bias; `norm` where it is
    on)."""
    sd: StateDict = {}
    get, _, _, norm = _converters(sd, params)
    sd[f"{prefix}fc.weight"] = np.transpose(get("fc/kernel"))
    if "norm" in params:
        norm(f"{prefix}norm", "norm")
    return sd


def mm_layer_state_dict(params: Mapping[str, Any], prefix: str = "") -> StateDict:
    """JAX `MMBEVFormerLayer` params -> `models.mm_layer.MMBEVFormerLayer`
    state dict, keyed by the JAX module names (the attentions' projections
    in the layout `state_dict_from_jax` copies for the encoder's)."""
    sd: StateDict = {}
    get, _, linear, norm = _converters(sd, params)
    for nm in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        linear(f"{prefix}self_attn.{nm}", f"self_attn/{nm}")
        linear(f"{prefix}lidar_cross_attn.{nm}", f"lidar_cross_attn/{nm}")
    for nm in ("sampling_offsets", "attention_weights", "value_proj"):
        linear(f"{prefix}cross_attn.deformable_attention.{nm}",
               f"cross_attn/deformable_attention/{nm}")
    linear(f"{prefix}cross_attn.output_proj", "cross_attn/output_proj")
    for i in (1, 2, 3):
        norm(f"{prefix}norm{i}", f"norm{i}")
    linear(f"{prefix}ffn.layers.0.0", "ffn/fc1")
    linear(f"{prefix}ffn.layers.1", "ffn/fc2")
    sd[f"{prefix}cross_model_weights"] = np.asarray(get("cross_model_weights"), np.float32)
    return sd


def bev_head_state_dict(params: Mapping[str, Any], prefix: str = "") -> StateDict:
    """JAX `BEVHead` params -> `models.bev_head.BEVHead` state dict (three
    1x1 convs with bias)."""
    sd: StateDict = {}
    get, conv, _, _ = _converters(sd, params)
    for nm in ("conv_cls", "conv_reg", "conv_dir_cls"):
        conv(f"{prefix}{nm}", nm)
        sd[f"{prefix}{nm}.bias"] = get(f"{nm}/bias")
    return sd


def state_dict_from_jax_v2(variables: Mapping[str, Any], cfg) -> StateDict:
    """JAX BEVFormerV2 variables (`{'params', 'batch_stats'}`, numpy
    leaves) -> reference-keyed state dict of the port's `BEVFormerV2`, the
    DD3D head's (`fcos3d_bbox_head`) where the params hold one."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = state_dict_from_jax(_with_batch_stats(params, stats), cfg)
    if cfg.num_mono_levels > 0 and "fcos3d_bbox_head" in params:
        sd.update(dd3d_state_dict(params["fcos3d_bbox_head"], stats["fcos3d_bbox_head"],
                                  cfg.num_mono_levels))
    return sd


def _norms_ffn(linear, norm, dst: str, node: Mapping) -> None:
    for i in range(3):
        norm(f"{dst}.norms.{i}", f"norm{i + 1}", node)
    linear(f"{dst}.ffns.0.layers.0.0", "ffn/fc1", node)
    linear(f"{dst}.ffns.0.layers.1", "ffn/fc2", node)


def encoder_state_dict(enc: Mapping[str, Any], num_layers: int, prefix: str = "") -> StateDict:
    """The params of a JAX `BEVFormerEncoder` (its scanned layer stack
    `layers/layer`) -> the state dict of the port's `BEVFormerEncoder`,
    keys under `prefix`."""
    sd: StateDict = {}
    _, _, linear, norm = _converters(sd, enc)
    stacked = _node(enc, "layers/layer")
    for lid in range(num_layers):
        node = _index(stacked, lid)
        dst = f"{prefix}layers.{lid}"
        for nm in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            linear(f"{dst}.attentions.0.{nm}", f"self_attn/{nm}", node)
        for nm in ("sampling_offsets", "attention_weights", "value_proj"):
            linear(
                f"{dst}.attentions.1.deformable_attention.{nm}",
                f"cross_attn/deformable_attention/{nm}", node,
            )
        linear(f"{dst}.attentions.1.output_proj", "cross_attn/output_proj", node)
        _norms_ffn(linear, norm, dst, node)
    return sd


def state_dict_from_jax(params: Mapping[str, Any], cfg) -> StateDict:
    """JAX params (numpy leaves) -> reference-keyed state dict. For a V2
    config the params must hold the running statistics in their BN nodes
    (`state_dict_from_jax_v2` does that)."""
    p = params["params"] if "params" in params else params
    v2 = cfg.version == "v2"
    sd: StateDict = {}
    get, conv, linear, norm = _converters(sd, p)
    sd.update(backbone_state_dict(
        p["img_backbone"], cfg.backbone_depth, cfg.backbone_dcn_stages, "img_backbone."
    ))
    num_outs = max(cfg.num_mono_levels, cfg.num_feature_levels)
    sd.update(neck_state_dict(p["img_neck"], len(cfg.neck_in_channels), num_outs, "img_neck."))

    hd = "pts_bbox_head"
    sd[f"{hd}.bev_embedding.weight"] = get(f"{hd}/bev_embedding")
    sd[f"{hd}.query_embedding.weight"] = get(f"{hd}/query_embedding")
    for rc in ("row", "col"):
        sd[f"{hd}.positional_encoding.{rc}_embed.weight"] = get(
            f"{hd}/positional_encoding/{rc}_embed"
        )
    for lid in range(cfg.decoder_layers):
        cb, rb = f"{hd}/cls_branch{lid}", f"{hd}/reg_branch{lid}"
        linear(f"{hd}.cls_branches.{lid}.0", f"{cb}/fc0")
        norm(f"{hd}.cls_branches.{lid}.1", f"{cb}/ln0")
        linear(f"{hd}.cls_branches.{lid}.3", f"{cb}/fc1")
        norm(f"{hd}.cls_branches.{lid}.4", f"{cb}/ln1")
        linear(f"{hd}.cls_branches.{lid}.6", f"{cb}/out")
        linear(f"{hd}.reg_branches.{lid}.0", f"{rb}/fc0")
        linear(f"{hd}.reg_branches.{lid}.2", f"{rb}/fc1")
        linear(f"{hd}.reg_branches.{lid}.4", f"{rb}/out")

    tr, trd = f"{hd}.transformer", f"{hd}/transformer"
    sd[f"{tr}.level_embeds"] = get(f"{trd}/level_embeds")
    sd[f"{tr}.cams_embeds"] = get(f"{trd}/cams_embeds")
    linear(f"{tr}.reference_points", f"{trd}/reference_points")
    if not v2:
        linear(f"{tr}.can_bus_mlp.0", f"{trd}/can_bus_fc1")
        linear(f"{tr}.can_bus_mlp.2", f"{trd}/can_bus_fc2")
        if "can_bus_ln" in p[hd]["transformer"]:
            norm(f"{tr}.can_bus_mlp.norm", f"{trd}/can_bus_ln")
    elif len(cfg.frames) > 1:
        for i in range(cfg.num_fusion):
            src, dst = f"{trd}/fusion/block{i}", f"{tr}.fusion.layers.{i}"
            for n in (1, 2):
                conv(f"{dst}.conv{n}", f"{src}/conv{n}")
                norm(f"{dst}.bn{n}", f"{src}/bn{n}", running=True)
            if "downsample_conv" in _node(p, src):
                conv(f"{dst}.downsample.0", f"{src}/downsample_conv")
                norm(f"{dst}.downsample.1", f"{src}/downsample_bn", running=True)
        linear(f"{tr}.fusion.layer_norm.0", f"{trd}/fusion/out_fc")
        norm(f"{tr}.fusion.layer_norm.1", f"{trd}/fusion/out_ln")

    sd.update(encoder_state_dict(_node(p, f"{trd}/encoder"), cfg.encoder_layers,
                                 f"{tr}.encoder."))
    for lid in range(cfg.decoder_layers):
        node = _node(p, f"{trd}/decoder/layer{lid}")
        dst = f"{tr}.decoder.layers.{lid}"
        sa = node["self_attn"]
        sd[f"{dst}.attentions.0.attn.in_proj_weight"] = np.concatenate(
            [np.transpose(get(f"{n}/kernel", sa)) for n in ("q_proj", "k_proj", "v_proj")]
        )
        sd[f"{dst}.attentions.0.attn.in_proj_bias"] = np.concatenate(
            [get(f"{n}/bias", sa) for n in ("q_proj", "k_proj", "v_proj")]
        )
        linear(f"{dst}.attentions.0.attn.out_proj", "out_proj", sa)
        for nm in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            linear(f"{dst}.attentions.1.{nm}", f"cross_attn/{nm}", node)
        _norms_ffn(linear, norm, dst, node)

    return sd


def _bias_of_offsets(mod: nn.Module) -> np.ndarray:
    if isinstance(mod, TemporalSelfAttention):
        return grid_init_bias(mod.num_heads, mod.num_levels * mod.num_bev_queue, mod.num_points)
    return grid_init_bias(mod.num_heads, mod.num_levels, mod.num_points)


def init_state_dict(cfg, seed: int = 0) -> StateDict:
    """Seeded random weights for every key of the port's state dict.

    Convolutions are He-normal, linears N(0, 1/fan_in), embeddings N(0, 1),
    BNs near identity with the last BN of each bottleneck scaled to ~0.2
    (so the residual stream stays in range over 33 blocks), and LayerNorms
    identity. Unlike the zero init of the JAX package, the offset layers
    (`conv_offset`, `sampling_offsets`) and the attention logits get small
    nonzero weights, so the kernels sample off the grid.
    """
    rng = np.random.RandomState(seed)
    with torch.device("meta"):
        model = _detector(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd: StateDict = {}

    def normal(key, std, mean=0.0):
        sd[key] = (rng.standard_normal(shapes[key]) * std + mean).astype(np.float32)

    def uniform(key, lo, hi):
        sd[key] = rng.uniform(lo, hi, shapes[key]).astype(np.float32)

    def const(key, value):
        sd[key] = np.full(shapes[key], value, np.float32)

    def fan_in(key):
        s = shapes[key]
        return int(np.prod(s[1:]))

    offset_mods = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (TemporalSelfAttention, MSDeformableAttention3D,
                            CustomMSDeformableAttention)):
            offset_mods[f"{name}.sampling_offsets"] = mod

    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, (FrozenBN, nn.BatchNorm2d)):
            last = name.endswith("bn3")
            lo, hi = (0.1, 0.3) if last else (0.8, 1.2)
            uniform(pre + "weight", lo, hi)
            uniform(pre + "bias", -0.1, 0.1)
            uniform(pre + "running_mean", -0.1, 0.1)
            uniform(pre + "running_var", 0.8, 1.2)
            if isinstance(mod, nn.BatchNorm2d):
                sd[pre + "num_batches_tracked"] = np.zeros((), np.int64)
        elif isinstance(mod, ModulatedDeformConv):
            normal(pre + "weight", np.sqrt(2.0 / fan_in(pre + "weight")))
        elif isinstance(mod, nn.Conv2d):
            k = pre + "weight"
            if name.endswith("conv_offset"):
                # offsets of about a pixel on features of rms ~1e2 (the
                # caffe-normalised images are not scaled), masks near 0.5
                normal(k, 0.01 / np.sqrt(fan_in(k)))
                normal(pre + "bias", 0.5)
            else:
                normal(k, np.sqrt(2.0 / fan_in(k)))
                if mod.bias is not None:
                    normal(pre + "bias", 0.02)
        elif isinstance(mod, nn.LayerNorm):
            const(pre + "weight", 1.0)
            const(pre + "bias", 0.0)
        elif isinstance(mod, nn.Embedding):
            normal(pre + "weight", 1.0)
        elif isinstance(mod, _PackedProjection):
            normal(pre + "in_proj_weight", 1.0 / np.sqrt(shapes[pre + "in_proj_weight"][1]))
            normal(pre + "in_proj_bias", 0.02)
        elif isinstance(mod, nn.Linear):
            k = pre + "weight"
            normal(k, 1.0 / np.sqrt(fan_in(k)))
            if name in offset_mods:
                # about +-0.5 cell of learned spread around the grid init
                sd[k] *= 0.5
                sd[pre + "bias"] = _bias_of_offsets(offset_mods[name]).astype(np.float32)
            else:
                normal(pre + "bias", 0.02)
    hd = "pts_bbox_head"
    for lid in range(cfg.decoder_layers):
        const(f"{hd}.cls_branches.{lid}.{3 * cfg.num_reg_fcs}.bias", bias_init_with_prob(0.01))
    tr = f"{hd}.transformer"
    normal(f"{tr}.level_embeds", 1.0)
    normal(f"{tr}.cams_embeds", 1.0)
    if cfg.version == "v2" and cfg.num_mono_levels > 0:
        # DD3D's initialisers (JAX `dd3d.py:225-262`): the focal prior on
        # the class logits, the per-level scales and depth offsets, the
        # depth constants
        m = model.fcos3d_bbox_head
        const("fcos3d_bbox_head.fcos2d_head.cls_logits.bias", bias_init_with_prob(0.01))
        for name, sub in m.named_modules():
            if isinstance(sub, (dd3d.Scale, dd3d.Offset)):
                key = f"fcos3d_bbox_head.{name}.{'scale' if isinstance(sub, dd3d.Scale) else 'bias'}"
                sd[key] = dd3d_init_value(name, cfg.num_mono_levels)
        f3 = "fcos3d_bbox_head.fcos3d_head"
        n = cfg.num_mono_levels
        sd[f"{f3}.mean_depth_per_level"] = np.asarray(dd3d.MEAN_DEPTH_PER_LEVEL[:n], np.float32)
        sd[f"{f3}.std_depth_per_level"] = np.asarray(dd3d.STD_DEPTH_PER_LEVEL[:n], np.float32)
    missing = set(shapes) - set(sd)
    if missing:
        raise AssertionError(f"init_state_dict left keys unset: {sorted(missing)[:10]}")
    return sd


def dd3d_init_value(name: str, num_levels: int) -> np.ndarray:
    """The [1] init of DD3D's per-level scale or offset `name`
    (`<head>.scales_<kind>.<level>` or `fcos3d_head.offsets_depth.<level>`)
    as JAX's `NuscenesDD3D` sets it."""
    kind, lvl = name.split(".")[-2], int(name.split(".")[-1])
    value = {
        "scales_box2d_reg": dd3d.STRIDES[lvl] * dd3d.BOX2D_SCALE_INIT,
        "scales_proj_ctr": dd3d.STRIDES[lvl] * dd3d.PROJ_CTR_SCALE_INIT,
        "scales_size": 1.0,
        "scales_conf": 1.0,
        "scales_depth": dd3d.STD_DEPTH_PER_LEVEL[lvl] * dd3d.DEPTH_SCALE_INIT,
        "offsets_depth": dd3d.MEAN_DEPTH_PER_LEVEL[lvl],
    }[kind]
    return np.full((1,), value, np.float32)


def _detector(cfg) -> nn.Module:
    return BEVFormerV2(cfg) if cfg.version == "v2" else BEVFormer(cfg)


def build_model(cfg, state_dict: Mapping[str, Any], device=DEFAULT_DEVICE) -> nn.Module:
    """The port's model for `cfg.version` (`BEVFormer` or `BEVFormerV2`)
    holding `state_dict` (numpy or torch values), evaluated on `device`
    (the card unless the caller asks for another). Every key must match
    (strict load), but for the BatchNorms' `num_batches_tracked` counters,
    which a state dict may leave out (`load_reference_pth` drops them, and
    the JAX package has none): they start at 0, and inference never reads
    them."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = _detector(cfg)
    want = model.state_dict()
    # copies: the model must not alias the caller's arrays (fuse_conv_bn
    # writes into its weights)
    tensors = {k: v.detach().clone() if torch.is_tensor(v) else torch.from_numpy(np.array(v))
               for k, v in state_dict.items()}
    for k, ref in want.items():
        if k in tensors:
            tensors[k] = tensors[k].to(ref.dtype)
        elif k.endswith(".num_batches_tracked"):
            tensors[k] = torch.zeros((), dtype=ref.dtype)
    model.load_state_dict(tensors, strict=True, assign=True)
    return model.to(device).eval()


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """`["state_dict"]` of a model-zoo-layout checkpoint (mmcv's
    `{"meta", "state_dict", "optimizer"}`), read with
    `torch.load(weights_only=True)`, less the BatchNorm `num_batches_tracked`
    counters where it has them (FrozenBN keeps none). A V2 checkpoint's
    DD3D head (`fcos3d_bbox_head.*`) is part of it. `build_model` then loads
    it strictly: every key must be the port's."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in ckpt["state_dict"].items()
            if not k.endswith(".num_batches_tracked")}


def save_checkpoint(path: str, trainer, step: int, epoch: int) -> None:
    """Write `trainer`'s state after `step` steps in mmcv's layout
    (`meta`, `state_dict` with the reference keys, `optimizer`), with the
    lr schedule (`scheduler`), `step` and the random generators' states
    (`rng`, and every rank's `rng_by_rank` under a process group) beside
    them. The file appears whole or not at all. Under a process group every
    rank calls it, rank 0 writes, and every rank returns once the file is
    there."""
    ckpt = trainer.state_dict()
    if distributed.rank() == 0:
        ckpt["meta"] = dict(epoch=epoch, iter=step, config=trainer.cfg.name)
        ckpt["step"] = step
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
    distributed.barrier()


def restore_checkpoint(path: str, trainer) -> Tuple[int, dict]:
    """Load a `save_checkpoint` file into `trainer` (model, optimizer, lr
    schedule, random generators); returns (step, meta)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    trainer.load_state_dict(ckpt)
    return int(ckpt["step"]), ckpt["meta"]
