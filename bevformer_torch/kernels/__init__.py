"""Kernels of the inference path. Each wrapper runs its CUDA kernel on a
CUDA tensor and its plain PyTorch version on a CPU tensor."""

from bevformer_torch.kernels.dcn import dcn_conv, dcn_conv_plain
from bevformer_torch.kernels.msda import ms_deform_attn, ms_deform_attn_plain

__all__ = ["dcn_conv", "dcn_conv_plain", "ms_deform_attn", "ms_deform_attn_plain"]
