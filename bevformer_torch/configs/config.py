"""Model configuration: frozen dataclasses and a preset registry.

The fields are the ones the inference, training and data paths and the
CLIs read, with the values of the JAX package's presets
(`bevformer_tpu/configs/config.py`): the four v1 model-zoo configs
bevformer_base, bevformer_small, bevformer_tiny and bevformer_tiny_fp16,
and the four BEVFormerV2 configs bevformerv2-r50-t1, -t1-base, -t2 and
-t8. What the v1 configs share is code, not a field: the ego-motion shift,
the prev-BEV rotation and the CAN-bus embedding. V2 has none of them; its
temporal context is the explicit `frames`, each re-encoded per sample.
The V2 fields only training reads (`group_detr`'s extra groups,
`num_mono_levels`' DD3D head, the losses and the train-time augmentation)
carry the JAX values. The DD3D head's constants stay in `models/dd3d.py`
and the per-camera target count in `data/dataset_v2.py`, as in the JAX
package.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Optional, Tuple

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Image geometry and normalisation of one model configuration."""

    # raw camera image size before resize (nuScenes: 900x1600)
    raw_size: Tuple[int, int] = (900, 1600)
    scale: float = 1.0
    # pad-to divisor
    size_divisor: int = 32
    # per-channel mean/std; to_rgb=False keeps caffe-style BGR order
    mean: Tuple[float, float, float] = (103.530, 116.280, 123.675)
    std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    to_rgb: bool = False
    use_photometric: bool = True  # train-time PhotoMetricDistortion
    # frames per training sample: queue_length - 1 history frames, then
    # the trained one
    queue_length: int = 4
    num_cams: int = 6
    # V2 train-time augmentation (CropResizeFlip's resize ladder and flip,
    # GlobalRotScaleTrans): t1/t2/t8 use the full recipe, t1-base none
    v2_resize_ladder: Tuple[int, ...] = (512, 544, 576, 608, 640, 672, 704, 736, 768)
    v2_rand_flip: bool = True
    v2_use_grst: bool = True

    @property
    def resized_size(self) -> Tuple[int, int]:
        """(H, W) after resize, before pad (floor scaling)."""
        return (
            int(self.raw_size[0] * self.scale),
            int(self.raw_size[1] * self.scale),
        )

    @property
    def img_size(self) -> Tuple[int, int]:
        """Network input (H, W) after resize and pad.

        It is also the image shape that `point_sampling` divides camera
        projections by: the reference's pad transform overwrites
        `img_shape` with the padded shape.
        """
        h, w = self.resized_size
        d = self.size_divisor
        return ((h + d - 1) // d * d, (w + d - 1) // d * d)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """AdamW with a warmup + cosine schedule (`bevformer_base.py:228-244`)."""

    lr: float = 2e-4
    weight_decay: float = 0.01
    backbone_lr_mult: float = 0.1
    grad_clip_norm: float = 35.0
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3.0
    min_lr_ratio: float = 1e-3
    total_epochs: int = 24
    samples_per_gpu: int = 1
    # the stem and stages 1..frozen_stages of the backbone do not train
    frozen_stages: int = 1


@dataclasses.dataclass(frozen=True)
class BEVFormerConfig:
    name: str = "bevformer_base"
    # backbone / neck
    backbone_depth: int = 101
    backbone_out_indices: Tuple[int, ...] = (1, 2, 3)
    backbone_dcn_stages: Tuple[int, ...] = (2, 3)
    # "caffe": each block's stride in its 1x1 conv1; "pytorch": in its 3x3 conv2
    backbone_style: str = "caffe"
    neck_in_channels: Tuple[int, ...] = (512, 1024, 2048)
    num_feature_levels: int = 4
    # BEV / transformer
    embed_dims: int = 256
    bev_h: int = 200
    bev_w: int = 200
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    feedforward_channels: int = 512
    ffn_dropout: float = 0.1
    num_points_in_pillar: int = 4
    sca_num_points: int = 8
    tsa_num_points: int = 4
    # static per-camera SCA query capacity (fraction of bev_h*bev_w; 0=dense)
    sca_capacity_ratio: float = 0.0
    rotate_center: Tuple[float, float] = (100.0, 100.0)
    # head
    num_query: int = 900
    num_classes: int = 10
    code_size: int = 10
    code_weights: Tuple[float, ...] = (
        1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2,
    )
    num_reg_fcs: int = 2
    pc_range: Tuple[float, ...] = PC_RANGE
    post_center_range: Tuple[float, ...] = (
        -61.2, -61.2, -10.0, 61.2, 61.2, 10.0,
    )
    max_num: int = 300  # NMS-free decode top-k
    # losses (FocalLoss gamma/alpha, weights; `bevformer_base.py:143-150`)
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    cls_loss_weight: float = 2.0
    bbox_loss_weight: float = 0.25
    # GridMask on the trained frame's images (train mode only)
    use_grid_mask: bool = True
    # v1: carry prev_bev from frame to frame of a scene in VideoEvaluator
    # (False: every frame starts without history); V2 carries nothing
    video_test_mode: bool = True
    # V2 (BEVFormerV2): "v1" | "v2"
    version: str = "v1"
    # frame offsets of a sample, 0 the current one; more than one fuses
    # their BEVs in ResNetFusion (num_fusion blocks, inter_channels wide:
    # None = len(frames) * embed_dims)
    frames: Tuple[int, ...] = (0,)
    num_fusion: int = 3
    inter_channels: Optional[int] = None
    # "frozen" (v1 FrozenBN) or "bn" (V2: BatchNorm with running statistics)
    backbone_norm: str = "frozen"
    # FPN levels the DD3D mono head reads (training only); the neck builds
    # max(num_mono_levels, num_feature_levels) levels
    num_mono_levels: int = 0
    # GroupDETR: query groups in training; inference reads the first group
    group_detr: int = 1
    # V2 training losses: "l1" or "smooth_l1" boxes, the DD3D loss weight
    bbox_loss: str = "l1"
    smooth_l1_beta: float = 1.0
    mono_loss_weight: float = 1.0
    # compute dtype of the network, the JAX config's field (`device.precision`):
    # "float32" (TF32 off) or "bfloat16" (bf16 autocast around fp32 islands
    # and fp32 parameters); any other value raises at the entry points
    dtype: str = "float32"
    # training max GT boxes per sample (static padding for the matcher)
    max_gt: int = 320

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)

    @property
    def grid_length(self) -> Tuple[float, float]:
        real_h = self.pc_range[4] - self.pc_range[1]
        real_w = self.pc_range[3] - self.pc_range[0]
        return (real_h / self.bev_h, real_w / self.bev_w)

    def replace(self, **kw) -> "BEVFormerConfig":
        return dataclasses.replace(self, **kw)


CONFIGS: Dict[str, BEVFormerConfig] = {}


def register_config(cfg: BEVFormerConfig) -> BEVFormerConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


def get_config(name: str, **overrides) -> BEVFormerConfig:
    cfg = CONFIGS[name]
    return cfg.replace(**overrides) if overrides else cfg


# projects/configs/bevformer/bevformer_base.py: R101-DCN caffe, 4 FPN
# levels, 200x200 BEV, 6+6 layers, 900 queries
register_config(BEVFormerConfig(name="bevformer_base", sca_capacity_ratio=0.25))

# projects/configs/bevformer/bevformer_small.py: R101-DCN caffe, C5 only,
# 150x150 BEV, 3 encoder layers, x0.8 input, queue 3
register_config(
    BEVFormerConfig(
        name="bevformer_small",
        sca_capacity_ratio=0.25,
        backbone_out_indices=(3,),
        neck_in_channels=(2048,),
        num_feature_levels=1,
        bev_h=150,
        bev_w=150,
        encoder_layers=3,
        data=DataConfig(scale=0.8, queue_length=3),
    )
)

# projects/configs/bevformer/bevformer_tiny.py: R50 pytorch style (no DCN),
# C5 only, 50x50 BEV, 3 encoder layers, x0.5 input, RGB normalisation, dense
# SCA. rotate_center stays (100, 100), the transformer's default, which the
# reference and the JAX package leave at every BEV size
register_config(
    BEVFormerConfig(
        name="bevformer_tiny",
        backbone_depth=50,
        backbone_out_indices=(3,),
        backbone_dcn_stages=(),
        backbone_style="pytorch",
        neck_in_channels=(2048,),
        num_feature_levels=1,
        bev_h=50,
        bev_w=50,
        encoder_layers=3,
        data=DataConfig(
            scale=0.5,
            mean=(123.675, 116.28, 103.53),
            std=(58.395, 57.12, 57.375),
            to_rgb=True,
            queue_length=3,
        ),
    )
)

# projects/configs/bevformer_fp16/bevformer_tiny_fp16.py: tiny in mixed
# precision, here bf16 (fp32's exponent range: no loss scaling)
register_config(
    CONFIGS["bevformer_tiny"].replace(name="bevformer_tiny_fp16", dtype="bfloat16")
)


# projects/configs/bevformerv2/bevformerv2-r50-t1-24ep.py: R50 caffe style
# with trainable BN (frozen_stages=-1), 3 inputs to a 5-level FPN (4 for the
# BEV, 5 for DD3D), GroupDETR-11, smooth-L1 boxes, one frame. The network
# input is the (0, 260, 1600, 900) crop of a nuScenes camera: raw_size is the
# crop's size
register_config(
    BEVFormerConfig(
        name="bevformerv2-r50-t1",
        version="v2",
        sca_capacity_ratio=0.25,
        backbone_depth=50,
        backbone_dcn_stages=(),
        backbone_norm="bn",
        optim=OptimConfig(frozen_stages=-1),
        num_mono_levels=5,
        group_detr=11,
        bbox_loss="smooth_l1",
        bbox_loss_weight=0.75,
        video_test_mode=False,
        data=DataConfig(raw_size=(640, 1600), queue_length=1),
    )
)

# bevformerv2-r50-t2 / -t8: BEV fusion over frames (-1, 0) and (-7 .. 0)
register_config(CONFIGS["bevformerv2-r50-t1"].replace(name="bevformerv2-r50-t2", frames=(-1, 0)))
register_config(
    CONFIGS["bevformerv2-r50-t1"].replace(name="bevformerv2-r50-t8", frames=tuple(range(-7, 1)))
)

# bevformerv2-r50-t1-base-24ep.py: t1 without GroupDETR and without the
# train-time augmentation (resize 640 only, no flip, no GlobalRotScaleTrans)
register_config(
    CONFIGS["bevformerv2-r50-t1"].replace(
        name="bevformerv2-r50-t1-base",
        group_detr=1,
        data=DataConfig(raw_size=(640, 1600), queue_length=1, v2_resize_ladder=(640,),
                        v2_rand_flip=False, v2_use_grst=False),
    )
)


def apply_overrides(cfg: BEVFormerConfig, options: Dict[str, str]) -> BEVFormerConfig:
    """`--cfg-options key=val` overrides (port of the JAX package's
    `apply_overrides`): `data.` and `optim.` descend into those configs, a
    leading `model.` names a top-level field. Values are Python literals;
    an unknown key raises KeyError naming the valid fields, a bool field
    given anything but a bool, or a number field given a string, raises
    ValueError."""
    scopes = {"": cfg, "data": cfg.data, "optim": cfg.optim}
    valid = {k: {f.name for f in dataclasses.fields(v)} for k, v in scopes.items()}

    def checked(scope: str, field: str, key: str, raw: str):
        if field not in valid[scope]:
            where = f"{scope} config" if scope else "config"
            raise KeyError(
                f"--cfg-options: unknown key {key!r} (no field {field!r} in {where}; "
                f"valid fields: {', '.join(sorted(valid[scope]))})")
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        cur = getattr(scopes[scope], field)
        # a typo such as use_grid_mask=Ture stays a (truthy) string: refuse it
        if isinstance(cur, bool) and not isinstance(val, bool):
            raise ValueError(f"--cfg-options: {key}={raw!r} is not a bool (use True or False)")
        if isinstance(cur, (int, float)) and isinstance(val, str):
            raise ValueError(f"--cfg-options: {key}={raw!r} is not a number")
        return val

    updates: Dict[str, object] = {}
    sub: Dict[str, Dict[str, object]] = {"data": {}, "optim": {}}
    for key, raw in options.items():
        head, _, rest = key.partition(".")
        if rest and head in sub:
            sub[head][rest] = checked(head, rest, key, raw)
            continue
        field = rest if rest and head == "model" else key
        updates[field] = checked("", field, key, raw)
    for scope, kw in sub.items():
        if kw:
            updates[scope] = dataclasses.replace(scopes[scope], **kw)
    return cfg.replace(**updates)
