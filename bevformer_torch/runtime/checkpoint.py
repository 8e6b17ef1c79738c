"""Weights for the port, keyed as the reference `.pth` state dict.

* `state_dict_from_jax(params, cfg)`: numpy-only port of
  `bevformer_tpu/runtime/checkpoint.py::export_reference_state_dict`. Its
  input is the JAX params pytree with numpy leaves; it unstacks the scanned
  backbone blocks (`layer{i}_rest`) and encoder layers by indexing.
* `init_state_dict(cfg, seed)`: seeded numpy weights for every key, for
  runs with no JAX checkpoint at hand.
* `build_model(cfg, state_dict, device)`: the port's model with those
  weights, on `device`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from bevformer_torch.models import BEVFormer
from bevformer_torch.models.attention import (
    CustomMSDeformableAttention,
    MSDeformableAttention3D,
    TemporalSelfAttention,
    grid_init_bias,
)
from bevformer_torch.models.head import bias_init_with_prob
from bevformer_torch.models.layers import _PackedProjection
from bevformer_torch.models.resnet import ARCH_SETTINGS, FrozenBN, ModulatedDeformConv

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


def state_dict_from_jax(params: Mapping[str, Any], cfg) -> StateDict:
    """JAX params (numpy leaves) -> reference-keyed state dict."""
    p = params["params"] if "params" in params else params
    sd: StateDict = {}
    get, _, linear, norm = _converters(sd, p)
    sd.update(backbone_state_dict(
        p["img_backbone"], cfg.backbone_depth, cfg.backbone_dcn_stages, "img_backbone."
    ))
    sd.update(neck_state_dict(
        p["img_neck"], len(cfg.neck_in_channels), cfg.num_feature_levels, "img_neck."
    ))

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
    linear(f"{tr}.can_bus_mlp.0", f"{trd}/can_bus_fc1")
    linear(f"{tr}.can_bus_mlp.2", f"{trd}/can_bus_fc2")
    if "can_bus_ln" in p[hd]["transformer"]:
        norm(f"{tr}.can_bus_mlp.norm", f"{trd}/can_bus_ln")

    def norms_ffn(dst, node):
        for i in range(3):
            norm(f"{dst}.norms.{i}", f"norm{i + 1}", node)
        linear(f"{dst}.ffns.0.layers.0.0", "ffn/fc1", node)
        linear(f"{dst}.ffns.0.layers.1", "ffn/fc2", node)

    stacked = _node(p, f"{trd}/encoder/layers/layer")
    for lid in range(cfg.encoder_layers):
        node = _index(stacked, lid)
        dst = f"{tr}.encoder.layers.{lid}"
        for nm in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            linear(f"{dst}.attentions.0.{nm}", f"self_attn/{nm}", node)
        for nm in ("sampling_offsets", "attention_weights", "value_proj"):
            linear(
                f"{dst}.attentions.1.deformable_attention.{nm}",
                f"cross_attn/deformable_attention/{nm}", node,
            )
        linear(f"{dst}.attentions.1.output_proj", "cross_attn/output_proj", node)
        norms_ffn(dst, node)

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
        norms_ffn(dst, node)

    return sd


def _bias_of_offsets(mod: nn.Module) -> np.ndarray:
    if isinstance(mod, TemporalSelfAttention):
        return grid_init_bias(mod.num_heads, mod.num_levels * mod.num_bev_queue, mod.num_points)
    return grid_init_bias(mod.num_heads, mod.num_levels, mod.num_points)


def init_state_dict(cfg, seed: int = 0) -> StateDict:
    """Seeded random weights for every key of the port's state dict.

    Convolutions are He-normal, linears N(0, 1/fan_in), embeddings N(0, 1),
    frozen BNs near identity with the last BN of each block scaled to ~0.2
    (so the residual stream stays in range over 33 blocks), and LayerNorms
    identity. Unlike the zero init of the JAX package, the offset layers
    (`conv_offset`, `sampling_offsets`) and the attention logits get small
    nonzero weights, so the kernels sample off the grid.
    """
    rng = np.random.RandomState(seed)
    with torch.device("meta"):
        model = BEVFormer(cfg)
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
        if isinstance(mod, FrozenBN):
            last = name.endswith("bn3")
            lo, hi = (0.1, 0.3) if last else (0.8, 1.2)
            uniform(pre + "weight", lo, hi)
            uniform(pre + "bias", -0.1, 0.1)
            uniform(pre + "running_mean", -0.1, 0.1)
            uniform(pre + "running_var", 0.8, 1.2)
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
    missing = set(shapes) - set(sd)
    if missing:
        raise AssertionError(f"init_state_dict left keys unset: {sorted(missing)[:10]}")
    return sd


def build_model(cfg, state_dict: Mapping[str, Any], device="cpu") -> BEVFormer:
    """The port's model holding `state_dict` (numpy or torch values),
    evaluated on `device`. Every key must match (strict load)."""
    with torch.device("meta"):
        model = BEVFormer(cfg)
    tensors = {k: torch.as_tensor(np.array(v, np.float32)) for k, v in state_dict.items()}
    model.load_state_dict(tensors, strict=True, assign=True)
    return model.to(device).eval()
