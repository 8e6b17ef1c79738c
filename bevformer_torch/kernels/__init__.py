"""Kernels of the inference and training paths, and of the kernel probes.
Each wrapper runs its CUDA kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor."""

from bevformer_torch.kernels import dcn, msda
from bevformer_torch.kernels.dcn import (
    dcn_col2im,
    dcn_col2im_plain,
    dcn_conv,
    dcn_conv_backward_plain,
    dcn_conv_plain,
    dcn_im2col,
    dcn_im2col_plain,
)
from bevformer_torch.kernels.gather import row_gather, row_gather_plain
from bevformer_torch.kernels.msda import (
    ms_deform_attn,
    ms_deform_attn_backward,
    ms_deform_attn_backward_plain,
    ms_deform_attn_ho,
    ms_deform_attn_plain,
    msda_probe,
    msda_probe_plain,
)


def kernel_counters() -> dict:
    """The wrappers of the model's paths' kernels, each of which counts its
    launches in `.launches`, by counter name (K1 msda_fwd, K2 dcn_conv_fwd,
    K3/K4 msda_bwd, K5 dcn_im2col, K6 dcn_col2im)."""
    # read through the modules: a wrapper counts under its module's name
    return dict(msda_fwd=msda.ms_deform_attn, dcn_conv_fwd=dcn.dcn_conv,
                msda_bwd=msda.ms_deform_attn_backward, dcn_im2col=dcn.dcn_im2col,
                dcn_col2im=dcn.dcn_col2im)


def launch_counts() -> dict:
    """Launches so far of each kernel of `kernel_counters`."""
    return {k: fn.launches for k, fn in kernel_counters().items()}


def zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


__all__ = [
    "dcn_col2im", "dcn_col2im_plain", "dcn_conv", "dcn_conv_backward_plain",
    "dcn_conv_plain", "dcn_im2col", "dcn_im2col_plain", "kernel_counters", "launch_counts",
    "ms_deform_attn", "ms_deform_attn_backward", "ms_deform_attn_backward_plain",
    "ms_deform_attn_ho", "ms_deform_attn_plain", "msda_probe", "msda_probe_plain",
    "row_gather", "row_gather_plain", "zero_counts",
]
