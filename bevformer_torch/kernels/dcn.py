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
-> output [B, OH, OW, Cout]. x is fp32 or bf16; offsets, mask and the
weight are fp32. On a bf16 x (the JAX kernels at compute_dtype=bfloat16)
the samples are taken in fp32, the column is rounded once to bf16, the
weight too, the product sums in fp32 and the output is rounded once to
bf16; the backward's column gradient is the product of the bf16 output
gradient with that bf16 weight, summed in fp32, dx is summed in fp32 and
rounded once to bf16, and d offsets, dmask and dWeight are fp32 (the
parameter's dtype).

`dcn_conv` runs the CUDA kernel `csrc/dcn_conv_fwd.cu` on a CUDA tensor, as
a `torch.autograd.Function` whose backward runs `dcn_im2col`
(`csrc/dcn_im2col.cu`) and the dWeight product, then on an fp32 x the
column gradient's product and `dcn_col2im` (`csrc/dcn_col2im.cu`), on a
bf16 x `dcn_col2im_gw` (the same file), which makes the column gradient
itself on the tensor cores from the output gradient and the weight; on a
CPU tensor `dcn_conv` runs the plain PyTorch version `dcn_conv_plain` under
ordinary autograd. Each backward kernel has its plain version beside it
(`dcn_im2col_plain`, `dcn_col2im_plain`, `dcn_col2im_gw_plain`). K2 and K5
have a bf16 entry (`dcn_conv_fwd_bf16`, `dcn_im2col_bf16`), which a bf16 x
reaches; a bf16 launch counts on `DCN_CONV_FWD_BF16` / `DCN_IM2COL_BF16` /
`DCN_COL2IM_BF16` (`dcn_col2im_gw`), an fp32 one on the wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from bevformer_torch.kernels import build
from bevformer_torch.kernels.msda import FP32_ONLY, LaunchCount

K_TILE = 32  # csrc/dcn_conv_fwd.cu: a K tile never spans two taps
N_BLOCK = 256  # csrc/dcn_conv_fwd.cu: output channels per block
GW_PART = 256  # csrc/dcn_col2im.cu (dcn_col2im_gw): channels of a tap per product
GW_K_STEP = 16  # ... the depth of one bf16 wgmma: Cout a multiple of it

X_DTYPES = (torch.float32, torch.bfloat16)  # x of K2, K5 and K6

DCN_CONV_FWD_BF16 = LaunchCount()  # dcn_conv on a bf16 x
DCN_IM2COL_BF16 = LaunchCount()  # dcn_im2col on a bf16 x
DCN_COL2IM_BF16 = LaunchCount()  # dcn_col2im_gw (the bf16 DCN backward's sampling half)


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


class _RoundBF16(torch.autograd.Function):
    """`t` rounded to bf16 (nearest even), kept in fp32. Its gradient
    passes unrounded: the kernels' backward takes the fp32 gradient of the
    rounded values."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, grad):
        return grad


def _samples(x, off_y, off_x, mask, stride):
    """The modulated samples [B, OH, OW, 9, C] in fp32."""
    oh, ow = off_y.shape[1], off_y.shape[2]
    py, px = _grid(oh, ow, stride, off_y, off_x)
    return bilinear_gather(x.float(), py, px) * mask[..., None]


def dcn_conv_plain(x, off_y, off_x, mask, weight, stride: int = 1):
    """Gather formulation of the modulated deformable conv (any device), in
    x's dtype whatever the autocast around it."""
    b, _, _, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    with torch.autocast(x.device.type, enabled=False):
        sampled = _samples(x, off_y, off_x, mask, stride).reshape(b, oh, ow, 9 * c)
        if x.dtype == torch.bfloat16:
            out = torch.einsum("bhwi,io->bhwo", _RoundBF16.apply(sampled),
                               _RoundBF16.apply(weight.float()))
            return out.to(torch.bfloat16)
        return torch.einsum("bhwi,io->bhwo", sampled, weight.float())


def _check_tensor(name, t, device, dtypes=FP32_ONLY):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2**31:
        raise ValueError(f"{name} has {t.numel()} elements (limit 2^31)")


def _check_sampling(x, off_y, off_x, mask, stride, x_dtypes=X_DTYPES):
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
    _check_tensor("x", x, x.device, x_dtypes)
    for name, t in (("off_y", off_y), ("off_x", off_x), ("mask", mask)):
        _check_tensor(name, t, x.device)
    if b * oh * ow * 9 * c >= 2**31:
        raise ValueError("the column has 2^31 elements or more")


def _check(x, off_y, off_x, mask, weight, stride, x_dtypes=X_DTYPES):
    _check_sampling(x, off_y, off_x, mask, stride, x_dtypes)
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
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    # the kernel's copy of the weight in its tile order: split into TF32
    # halves (fp32), or rounded to bf16
    prep = torch.empty((1 if bf16 else 2) * -(-cout // N_BLOCK) * N_BLOCK * 9 * c,
                       dtype=x.dtype, device=x.device)
    entry = "dcn_conv_fwd_bf16" if bf16 else "dcn_conv_fwd"
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(), off_y.data_ptr(), off_x.data_ptr(),
            mask.data_ptr(), weight.data_ptr(), prep.data_ptr(), out.data_ptr(),
            b, h, w, c, oh, ow, cout, stride, stream,
        )
    build.check_launch(entry, rc)
    (DCN_CONV_FWD_BF16 if bf16 else dcn_conv).launches += 1
    return out


def bf16_conv_grid() -> dict:
    """The persistent grid of the last `dcn_conv_fwd_bf16` launch, as its C
    entry recorded it: the card's SMs, the blocks, the most pixels a block
    walks, the pixels a tile and the most tiles an SM walks."""
    grid = (ctypes.c_int * 5)()
    build.check_launch("dcn_conv_fwd_bf16_grid", build.library().dcn_conv_fwd_bf16_grid(grid))
    return dict(zip(("sms", "blocks", "pixels_per_block", "tile_pixels", "tiles_per_sm"), grid))


class _DCNConv(torch.autograd.Function):
    """K2 forward. The backward follows the JAX `_conv_bwd`: it recomputes
    the im2col (`dcn_im2col`), takes dWeight = cols^T g as a plain matrix
    product, and scatters dCols = g W^T back through the sampling. Only the
    inputs are saved, never the 9x column. On an fp32 x dCols is a plain
    product and `dcn_col2im` scatters it. On a bf16 x dWeight runs in fp32
    with autocast off, on the bf16 column widened exactly (fp32 whatever
    the caller's autocast), and `dcn_col2im_gw` takes the bf16 g and the
    weight: dCols is made inside the kernel and never stored."""

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
        if x.dtype == torch.bfloat16:
            with torch.autocast(x.device.type, enabled=False):
                cols = dcn_im2col(x, off_y, off_x, mask, ctx.stride)
                dweight = cols.float().t() @ g.float()
                del cols
            grads = dcn_col2im_gw(x, off_y, off_x, mask, g, weight, ctx.stride)
        else:
            cols = dcn_im2col(x, off_y, off_x, mask, ctx.stride)
            dweight = cols.t() @ g
            del cols
            grads = dcn_col2im(x, off_y, off_x, mask, g @ weight.t(), ctx.stride)
        return (*grads, dweight, None)


def dcn_conv(x, off_y, off_x, mask, weight, stride: int = 1) -> torch.Tensor:
    """DCNv2 conv: the plain version (under ordinary autograd) for a CPU
    tensor, the CUDA kernel for a CUDA tensor (fp32 or bf16 x, fp32
    offsets, mask and weight; anything else raises), differentiable through
    `dcn_im2col` and `dcn_col2im` (no fallback between the two, nor between
    the dtypes)."""
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
    """The modulated column [B*OH*OW, 9C], rows tap-major, in x's dtype (a
    bf16 column is the fp32 one rounded once) (any device)."""
    b, _, _, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    return _samples(x, off_y, off_x, mask, stride).reshape(b * oh * ow, 9 * c).to(x.dtype)


def dcn_col2im_plain(x, off_y, off_x, mask, dcols, stride: int = 1):
    """(dx, d off_y, d off_x, dmask) of the column for an fp32 column
    gradient `dcols` [B*OH*OW, 9C], by autograd through the fp32 column of
    `dcn_im2col_plain`: dx in x's dtype (summed in fp32, rounded once), the
    rest fp32."""
    b, _, _, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in (x, off_y, off_x, mask)]
        cols = _samples(*leaves, stride).reshape(b * oh * ow, 9 * c)
        dx, doff_y, doff_x, dmask = torch.autograd.grad(cols, leaves, dcols)
    return dx.to(x.dtype), doff_y, doff_x, dmask


def dcn_conv_backward_plain(x, off_y, off_x, mask, weight, grad_out, stride: int = 1):
    """(dx, d off_y, d off_x, dmask, dweight) by autograd through
    `dcn_conv_plain`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, off_y, off_x, mask, weight)]
        out = dcn_conv_plain(*leaves, stride)
        return torch.autograd.grad(out, leaves, grad_out)


def dcn_im2col(x, off_y, off_x, mask, stride: int = 1) -> torch.Tensor:
    """The modulated column [B*OH*OW, 9C] in x's dtype: the plain version
    for a CPU tensor, the CUDA kernel `dcn_im2col` (`dcn_im2col_bf16` for a
    bf16 x) for a CUDA tensor."""
    if x.device.type == "cpu":
        return dcn_im2col_plain(x, off_y, off_x, mask, stride)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_im2col: unsupported device {x.device}")
    b, h, w, c = x.shape
    _check_sampling(x, off_y, off_x, mask, stride)
    oh, ow = off_y.shape[1], off_y.shape[2]
    bf16 = x.dtype == torch.bfloat16
    entry = "dcn_im2col_bf16" if bf16 else "dcn_im2col"
    cols = torch.empty((b * oh * ow, 9 * c), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(), off_y.data_ptr(), off_x.data_ptr(), mask.data_ptr(),
            cols.data_ptr(), b, h, w, c, oh, ow, stride, stream,
        )
    build.check_launch(entry, rc)
    (DCN_IM2COL_BF16 if bf16 else dcn_im2col).launches += 1
    return cols


dcn_im2col.launches = 0


def dcn_col2im(x, off_y, off_x, mask, dcols, stride: int = 1):
    """The sampling backward: (dx [B, H, W, C] in x's dtype, d off_y, d
    off_x, dmask [B, OH, OW, 9]) for an fp32 column gradient `dcols`
    [B*OH*OW, 9C]. The plain version for a CPU tensor (any x dtype), the
    CUDA kernel `dcn_col2im` for a CUDA tensor (fp32 x; the backward of a
    bf16 x is `dcn_col2im_gw`)."""
    if x.device.type == "cpu":
        return dcn_col2im_plain(x, off_y, off_x, mask, dcols, stride)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_col2im: unsupported device {x.device}")
    b, h, w, c = x.shape
    _check_sampling(x, off_y, off_x, mask, stride, FP32_ONLY)
    oh, ow = off_y.shape[1], off_y.shape[2]
    _check_tensor("dcols", dcols, x.device)
    if tuple(dcols.shape) != (b * oh * ow, 9 * c):
        raise ValueError(f"dcols must be {(b * oh * ow, 9 * c)}, got {tuple(dcols.shape)}")
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
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


def dcn_col2im_gw_plain(x, off_y, off_x, mask, g, weight, stride: int = 1):
    """`dcn_col2im_gw`'s function (any device): the column gradient g
    W_bf16^T as an fp32 product with autocast off (the weight rounded once
    to bf16, g and it widened exactly), then `dcn_col2im_plain`."""
    with torch.autocast(x.device.type, enabled=False):
        dcols = g.float() @ weight.to(torch.bfloat16).float().t()
    return dcn_col2im_plain(x, off_y, off_x, mask, dcols, stride)


def _check_col2im_gw(x, off_y, off_x, mask, g, weight, stride):
    """What `dcn_col2im_gw`'s kernel takes: a bf16 x, fp32 offsets, mask
    and weight [9C, Cout] (C a multiple of K_TILE), a bf16 g [B*OH*OW,
    Cout], Cout a multiple of GW_K_STEP, all contiguous; else raises."""
    _check(x, off_y, off_x, mask, weight, stride, (torch.bfloat16,))
    b, oh, ow = off_y.shape[:3]
    cout = weight.shape[1]
    _check_tensor("g", g, x.device, (torch.bfloat16,))
    if tuple(g.shape) != (b * oh * ow, cout):
        raise ValueError(f"g must be {(b * oh * ow, cout)}, got {tuple(g.shape)}")
    if cout % GW_K_STEP:
        raise ValueError(f"Cout {cout} must be a multiple of {GW_K_STEP}")


def dcn_col2im_gw(x, off_y, off_x, mask, g, weight, stride: int = 1):
    """The sampling half of the DCN backward on a bf16 x, from the output
    gradient: (dx [B, H, W, C] bf16, d off_y, d off_x, dmask [B, OH, OW, 9]
    fp32) for the column gradient g W_bf16^T, where g is the bf16 gradient
    [B*OH*OW, Cout] of the conv's output and W the fp32 weight [9C, Cout]
    rounded once to bf16. The plain version `dcn_col2im_gw_plain` for a CPU
    tensor; for a CUDA tensor the kernel `dcn_col2im_gw`, which makes the
    column gradient on the tensor cores inside the kernel (never stored)
    and sums dx in an fp32 workspace rounded to bf16 once. Anything it does
    not take raises (`_check_col2im_gw`, and the C entry's alignment:
    x on 8 bytes, g on 16)."""
    if x.device.type == "cpu":
        return dcn_col2im_gw_plain(x, off_y, off_x, mask, g, weight, stride)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_col2im_gw: unsupported device {x.device}")
    _check_col2im_gw(x, off_y, off_x, mask, g, weight, stride)
    grads = launch_col2im_gw(build.library(), x, off_y, off_x, mask, g, weight, stride)
    DCN_COL2IM_BF16.launches += 1
    return grads


def launch_col2im_gw(lib, x, off_y, off_x, mask, g, weight, stride: int = 1):
    """One launch of the C entry `dcn_col2im_gw` of the library `lib` (the
    package's, or another build of its source) on checked CUDA tensors, with
    the wrapper's work around it: the weight's scratch, the zeroed fp32 dx
    workspace and its rounding to bf16."""
    b, h, w, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    cout = weight.shape[1]
    # the kernel's copy of the weight: per tap and 256-channel part, bf16
    wprep = torch.empty(9 * -(-c // GW_PART) * GW_PART * cout, dtype=torch.bfloat16,
                        device=x.device)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    doff_y = torch.empty_like(off_y)
    doff_x = torch.empty_like(off_x)
    dmask = torch.empty_like(mask)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dcn_col2im_gw(
            x.data_ptr(), off_y.data_ptr(), off_x.data_ptr(), mask.data_ptr(),
            g.data_ptr(), weight.data_ptr(), wprep.data_ptr(), dx.data_ptr(),
            doff_y.data_ptr(), doff_x.data_ptr(), dmask.data_ptr(),
            b, h, w, c, oh, ow, cout, stride, stream,
        )
    build.check_launch("dcn_col2im_gw", rc)
    return dx.to(x.dtype), doff_y, doff_x, dmask
