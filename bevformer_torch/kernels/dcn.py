"""DCNv2 (modulated deformable 3x3 convolution): the sampling fused with the
conv contraction, and its backward.

For output pixel (oy, ox) and tap (ky, kx): sample the input bilinearly at
(oy*s - 1 + ky + dy, ox*s - 1 + kx + dx) with zeros outside the image, scale
by the (already sigmoided) mask, and contract the [9*C] column with
`weight[9*C, Cout]` (rows tap-major: row = (ky*3 + kx)*C + c). The spec is
`bevformer_tpu/models/resnet.py::ModulatedDeformConv._sample_gather` and
`_bilinear_gather` followed by the einsum of its exact path. There is no
clip on the offsets.

Layouts are channels-last: x [B, H, W, C], offsets and mask [B, OH, OW, 9]
-> output [B, OH, OW, Cout].

`dcn_conv` runs the CUDA kernel `csrc/dcn_conv_fwd.cu` on a CUDA tensor, as
a `torch.autograd.Function` whose backward runs `dcn_im2col`
(`csrc/dcn_im2col.cu`), two matrix products and `dcn_col2im`
(`csrc/dcn_col2im.cu`), and the plain PyTorch version `dcn_conv_plain` under
ordinary autograd on a CPU tensor. Each of the two backward kernels has its
plain version beside it (`dcn_im2col_plain`, `dcn_col2im_plain`).
"""

from __future__ import annotations

import torch

from bevformer_torch.kernels import build

K_TILE = 32  # csrc/dcn_conv_fwd.cu: a K tile never spans two taps
N_BLOCK = 256  # csrc/dcn_conv_fwd.cu: output channels per block


def bilinear_gather(img: torch.Tensor, py: torch.Tensor, px: torch.Tensor):
    """img [b, h, w, c]; py/px [b, oh, ow, t] pixel coords -> [b, oh, ow, t, c]
    (zeros outside the image)."""
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ty = py - y0
    tx = px - x0
    y0 = y0.long()
    x0 = x0.long()
    bidx = torch.arange(b, device=img.device)[:, None]
    out = 0.0
    for dy, dx, wgt in (
        (0, 0, (1 - ty) * (1 - tx)),
        (0, 1, (1 - ty) * tx),
        (1, 0, ty * (1 - tx)),
        (1, 1, ty * tx),
    ):
        yy = y0 + dy
        xx = x0 + dx
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        g = flat[bidx, idx.reshape(b, -1)].reshape(*idx.shape, c)
        out = out + g * (wgt * valid.float())[..., None]
    return out


def dcn_conv_plain(x, off_y, off_x, mask, weight, stride: int = 1):
    """Gather formulation of the modulated deformable conv (any device)."""
    b, _, _, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    py, px = _grid(oh, ow, stride, off_y, off_x)
    sampled = bilinear_gather(x.float(), py, px) * mask[..., None]
    return torch.einsum(
        "bhwi,io->bhwo", sampled.reshape(b, oh, ow, 9 * c), weight.float()
    )


def _check_tensor(name, t, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2**31:
        raise ValueError(f"{name} has {t.numel()} elements (limit 2^31)")


def _check_sampling(x, off_y, off_x, mask, stride):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if off_y.dim() != 4 or off_y.shape[0] != b or off_y.shape[3] != 9:
        raise ValueError(f"offsets must be [{b}, OH, OW, 9], got {tuple(off_y.shape)}")
    oh, ow = off_y.shape[1], off_y.shape[2]
    if oh != (h - 1) // stride + 1 or ow != (w - 1) // stride + 1:
        raise ValueError(
            f"output {oh}x{ow} does not match input {h}x{w} at stride {stride}"
        )
    for name, t in (("off_x", off_x), ("mask", mask)):
        if t.shape != off_y.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(off_y.shape)}")
    for name, t in (("x", x), ("off_y", off_y), ("off_x", off_x), ("mask", mask)):
        _check_tensor(name, t, x.device)
    if b * oh * ow * 9 * c >= 2**31:
        raise ValueError("the column has 2^31 elements or more")


def _check(x, off_y, off_x, mask, weight, stride):
    _check_sampling(x, off_y, off_x, mask, stride)
    b, _, _, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    if weight.dim() != 2 or weight.shape[0] != 9 * c:
        raise ValueError(f"weight must be [9*C={9 * c}, Cout], got {tuple(weight.shape)}")
    if c % K_TILE:
        raise ValueError(f"channels {c} must be a multiple of {K_TILE}")
    _check_tensor("weight", weight, x.device)
    if b * oh * ow * weight.shape[1] >= 2**31:
        raise ValueError("output has 2^31 elements or more")


def _launch_fwd(x, off_y, off_x, mask, weight, stride) -> torch.Tensor:
    b, h, w, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    cout = weight.shape[1]
    out = torch.empty((b, oh, ow, cout), dtype=torch.float32, device=x.device)
    # the kernel's copy of the weight, split into TF32 halves in its tile order
    split = torch.empty(2 * -(-cout // N_BLOCK) * N_BLOCK * 9 * c, dtype=torch.float32,
                        device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dcn_conv_fwd(
            x.data_ptr(), off_y.data_ptr(), off_x.data_ptr(),
            mask.data_ptr(), weight.data_ptr(), split.data_ptr(), out.data_ptr(),
            b, h, w, c, oh, ow, cout, stride, stream,
        )
    build.check_launch("dcn_conv_fwd", rc)
    dcn_conv.launches += 1
    return out


class _DCNConv(torch.autograd.Function):
    """K2 forward. The backward follows the JAX `_conv_bwd`: it recomputes
    the im2col (`dcn_im2col`), takes dWeight = cols^T g and dCols = g W^T
    as plain matrix products, and scatters dCols back through the sampling
    (`dcn_col2im`). Only the inputs are saved, never the 9x column."""

    @staticmethod
    def forward(ctx, x, off_y, off_x, mask, weight, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, off_y, off_x, mask, weight)
        return _launch_fwd(x, off_y, off_x, mask, weight, stride)

    @staticmethod
    def backward(ctx, grad_out):
        x, off_y, off_x, mask, weight = ctx.saved_tensors
        # autograd may hand over a strided view (the NCHW permute upstream)
        g = grad_out.contiguous().view(-1, weight.shape[1])
        cols = dcn_im2col(x, off_y, off_x, mask, ctx.stride)
        dweight = cols.t() @ g
        del cols
        dcols = g @ weight.t()
        dx, doff_y, doff_x, dmask = dcn_col2im(x, off_y, off_x, mask, dcols, ctx.stride)
        return dx, doff_y, doff_x, dmask, dweight, None


def dcn_conv(x, off_y, off_x, mask, weight, stride: int = 1) -> torch.Tensor:
    """DCNv2 conv: the plain version (under ordinary autograd) for a CPU
    tensor, the CUDA kernel for a CUDA tensor, differentiable through
    `dcn_im2col` and `dcn_col2im` (no fallback between the two)."""
    if x.device.type == "cpu":
        return dcn_conv_plain(x, off_y, off_x, mask, weight, stride)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_conv: unsupported device {x.device}")
    _check(x, off_y, off_x, mask, weight, stride)
    return _DCNConv.apply(x, off_y, off_x, mask, weight, stride)


dcn_conv.launches = 0


def _grid(oh: int, ow: int, stride: int, off_y, off_x):
    """Sampling positions [b, oh, ow, 9] of every (pixel, tap)."""
    dev = off_y.device
    ys = torch.arange(oh, dtype=torch.float32, device=dev) * stride - 1.0
    xs = torch.arange(ow, dtype=torch.float32, device=dev) * stride - 1.0
    k = torch.arange(3, dtype=torch.float32, device=dev)
    ky, kx = torch.meshgrid(k, k, indexing="ij")
    py = ys[None, :, None, None] + ky.reshape(-1) + off_y
    px = xs[None, None, :, None] + kx.reshape(-1) + off_x
    return py, px


def dcn_im2col_plain(x, off_y, off_x, mask, stride: int = 1) -> torch.Tensor:
    """The modulated column [B*OH*OW, 9C], rows tap-major (any device)."""
    b, _, _, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    py, px = _grid(oh, ow, stride, off_y, off_x)
    sampled = bilinear_gather(x.float(), py, px) * mask[..., None]
    return sampled.reshape(b * oh * ow, 9 * c)


def dcn_col2im_plain(x, off_y, off_x, mask, dcols, stride: int = 1):
    """(dx, d off_y, d off_x, dmask) of the column for a column gradient
    `dcols` [B*OH*OW, 9C], by autograd through `dcn_im2col_plain`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, off_y, off_x, mask)]
        cols = dcn_im2col_plain(*leaves, stride)
        return torch.autograd.grad(cols, leaves, dcols)


def dcn_conv_backward_plain(x, off_y, off_x, mask, weight, grad_out, stride: int = 1):
    """(dx, d off_y, d off_x, dmask, dweight) by autograd through
    `dcn_conv_plain`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, off_y, off_x, mask, weight)]
        out = dcn_conv_plain(*leaves, stride)
        return torch.autograd.grad(out, leaves, grad_out)


def dcn_im2col(x, off_y, off_x, mask, stride: int = 1) -> torch.Tensor:
    """The modulated column [B*OH*OW, 9C]: the plain version for a CPU
    tensor, the CUDA kernel `dcn_im2col` for a CUDA tensor."""
    if x.device.type == "cpu":
        return dcn_im2col_plain(x, off_y, off_x, mask, stride)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_im2col: unsupported device {x.device}")
    b, h, w, c = x.shape
    _check_sampling(x, off_y, off_x, mask, stride)
    oh, ow = off_y.shape[1], off_y.shape[2]
    cols = torch.empty((b * oh * ow, 9 * c), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dcn_im2col(
            x.data_ptr(), off_y.data_ptr(), off_x.data_ptr(), mask.data_ptr(),
            cols.data_ptr(), b, h, w, c, oh, ow, stride, stream,
        )
    build.check_launch("dcn_im2col", rc)
    dcn_im2col.launches += 1
    return cols


dcn_im2col.launches = 0


def dcn_col2im(x, off_y, off_x, mask, dcols, stride: int = 1):
    """The sampling backward: (dx [B, H, W, C], d off_y, d off_x, dmask
    [B, OH, OW, 9]) for a column gradient `dcols` [B*OH*OW, 9C]. The plain
    version for a CPU tensor, the CUDA kernel `dcn_col2im` for a CUDA
    tensor."""
    if x.device.type == "cpu":
        return dcn_col2im_plain(x, off_y, off_x, mask, dcols, stride)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_col2im: unsupported device {x.device}")
    b, h, w, c = x.shape
    _check_sampling(x, off_y, off_x, mask, stride)
    oh, ow = off_y.shape[1], off_y.shape[2]
    _check_tensor("dcols", dcols, x.device)
    if tuple(dcols.shape) != (b * oh * ow, 9 * c):
        raise ValueError(f"dcols must be {(b * oh * ow, 9 * c)}, got {tuple(dcols.shape)}")
    dx = torch.zeros_like(x)
    doff_y = torch.empty_like(off_y)
    doff_x = torch.empty_like(off_x)
    dmask = torch.empty_like(mask)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dcn_col2im(
            x.data_ptr(), off_y.data_ptr(), off_x.data_ptr(), mask.data_ptr(),
            dcols.data_ptr(), dx.data_ptr(), doff_y.data_ptr(),
            doff_x.data_ptr(), dmask.data_ptr(), b, h, w, c, oh, ow, stride,
            stream,
        )
    build.check_launch("dcn_col2im", rc)
    dcn_col2im.launches += 1
    return dx, doff_y, doff_x, dmask


dcn_col2im.launches = 0
