"""Kernels of the inference and training paths, and of the kernel probes.
Each wrapper runs its CUDA kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor."""

from bevformer_torch.kernels import conv, dcn, msda
from bevformer_torch.kernels.conv import conv2d_nhwc, conv2d_nhwc_plain
from bevformer_torch.kernels.dcn import (
    dcn_col2im,
    dcn_col2im_gw,
    dcn_col2im_gw_plain,
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
    K3/K4 msda_bwd, K5 dcn_im2col, K6 dcn_col2im, the dense conv conv_fwd),
    and the counts of their bf16 entries (msda_fwd_bf16, msda_bwd_bf16,
    dcn_conv_fwd_bf16, dcn_im2col_bf16, and dcn_col2im_bf16: K6 on a bf16
    x, `dcn_col2im_gw`)."""
    # read through the modules: a wrapper counts under its module's name
    return dict(msda_fwd=msda.ms_deform_attn, dcn_conv_fwd=dcn.dcn_conv,
                msda_bwd=msda.ms_deform_attn_backward, dcn_im2col=dcn.dcn_im2col,
                dcn_col2im=dcn.dcn_col2im, conv_fwd=conv.conv2d_nhwc,
                msda_fwd_bf16=msda.MSDA_FWD_BF16, msda_bwd_bf16=msda.MSDA_BWD_BF16,
                dcn_conv_fwd_bf16=dcn.DCN_CONV_FWD_BF16, dcn_im2col_bf16=dcn.DCN_IM2COL_BF16,
                dcn_col2im_bf16=dcn.DCN_COL2IM_BF16)


def launch_counts() -> dict:
    """Launches so far of each kernel of `kernel_counters`."""
    return {k: fn.launches for k, fn in kernel_counters().items()}


def launch_queries() -> dict:
    """Launches so far of K1 and K3/K4 (and their bf16 entries) by the
    (B, Q) of each: {counter name: [[B, Q, launches], ...]}."""
    return {k: sorted([*bq, n] for bq, n in c.items()) for k, c in msda.QUERIES.items()}


def zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0
    for c in msda.QUERIES.values():
        c.clear()


__all__ = [
    "conv2d_nhwc", "conv2d_nhwc_plain",
    "dcn_col2im", "dcn_col2im_gw", "dcn_col2im_gw_plain", "dcn_col2im_plain", "dcn_conv", "dcn_conv_backward_plain",
    "dcn_conv_plain", "dcn_im2col", "dcn_im2col_plain", "kernel_counters", "launch_counts",
    "launch_queries",
    "ms_deform_attn", "ms_deform_attn_backward", "ms_deform_attn_backward_plain",
    "ms_deform_attn_ho", "ms_deform_attn_plain", "msda_probe", "msda_probe_plain",
    "row_gather", "row_gather_plain", "zero_counts",
]
