from bevformer_torch.data.dataset import (
    CAM_ORDER,
    NuScenesTemporalDataset,
    lidar2img_from_cam_info,
)
from bevformer_torch.data.dataset_v2 import NuScenesTemporalDatasetV2
from bevformer_torch.data.sampler import ContiguousVideoSampler, GroupShuffleSampler
from bevformer_torch.data.synth import (
    SyntheticVideo,
    camera_rigs,
    generate,
    train_batch,
)

__all__ = [
    "CAM_ORDER", "ContiguousVideoSampler", "GroupShuffleSampler", "NuScenesTemporalDataset",
    "NuScenesTemporalDatasetV2",
    "SyntheticVideo", "camera_rigs", "generate", "lidar2img_from_cam_info", "train_batch",
]
