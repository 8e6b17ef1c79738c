"""Model configuration: frozen dataclasses and a preset registry.

The fields are the ones the bevformer_base inference path reads, with the
values of the JAX package's presets (`bevformer_tpu/configs/config.py`).
What bevformer_base fixes is code, not a field: a caffe-style backbone, the
ego-motion shift, the prev-BEV rotation, the CAN-bus embedding and the
prev-BEV carry across the frames of a scene (video test mode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Image geometry and normalisation of one model configuration."""

    # raw camera image size before resize (nuScenes: 900x1600)
    raw_size: Tuple[int, int] = (900, 1600)
    scale: float = 1.0
    # pad-to divisor
    size_divisor: int = 32
    # per-channel mean/std of caffe-style (BGR) normalisation
    mean: Tuple[float, float, float] = (103.530, 116.280, 123.675)
    std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    num_cams: int = 6

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
class BEVFormerConfig:
    name: str = "bevformer_base"
    # backbone / neck
    backbone_depth: int = 101
    backbone_out_indices: Tuple[int, ...] = (1, 2, 3)
    backbone_dcn_stages: Tuple[int, ...] = (2, 3)
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
    num_reg_fcs: int = 2
    pc_range: Tuple[float, ...] = PC_RANGE
    post_center_range: Tuple[float, ...] = (
        -61.2, -61.2, -10.0, 61.2, 61.2, 10.0,
    )
    max_num: int = 300  # NMS-free decode top-k

    data: DataConfig = dataclasses.field(default_factory=DataConfig)

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
