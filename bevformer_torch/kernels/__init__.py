"""Kernels of the inference and training paths. Each wrapper runs its CUDA
kernel on a CUDA tensor and its plain PyTorch version on a CPU tensor."""

from bevformer_torch.kernels.dcn import (
    dcn_col2im,
    dcn_col2im_plain,
    dcn_conv,
    dcn_conv_backward_plain,
    dcn_conv_plain,
    dcn_im2col,
    dcn_im2col_plain,
)
from bevformer_torch.kernels.msda import (
    ms_deform_attn,
    ms_deform_attn_backward,
    ms_deform_attn_backward_plain,
    ms_deform_attn_plain,
)

__all__ = [
    "dcn_col2im", "dcn_col2im_plain", "dcn_conv", "dcn_conv_backward_plain",
    "dcn_conv_plain", "dcn_im2col", "dcn_im2col_plain", "ms_deform_attn",
    "ms_deform_attn_backward", "ms_deform_attn_backward_plain",
    "ms_deform_attn_plain",
]
