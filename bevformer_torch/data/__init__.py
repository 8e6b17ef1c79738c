from bevformer_torch.data.synth import SyntheticVideo, camera_rigs, lidar2img_from_cam_info

__all__ = ["SyntheticVideo", "camera_rigs", "lidar2img_from_cam_info"]
