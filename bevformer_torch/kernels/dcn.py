"""DCNv2 (modulated deformable 3x3 convolution) sampling fused with the
conv contraction.

For output pixel (oy, ox) and tap (ky, kx): sample the input bilinearly at
(oy*s - 1 + ky + dy, ox*s - 1 + kx + dx) with zeros outside the image, scale
by the (already sigmoided) mask, and contract the [9*C] column with
`weight[9*C, Cout]` (rows tap-major: row = (ky*3 + kx)*C + c). The spec is
`bevformer_tpu/models/resnet.py::ModulatedDeformConv._sample_gather` and
`_bilinear_gather` followed by the einsum of its exact path. There is no
clip on the offsets.

Layouts are channels-last: x [B, H, W, C], offsets and mask [B, OH, OW, 9]
-> output [B, OH, OW, Cout].

`dcn_conv` runs the CUDA kernel `csrc/dcn_conv_fwd.cu` on a CUDA tensor and
the plain PyTorch version `dcn_conv_plain` on a CPU tensor.
"""

from __future__ import annotations

import torch

from bevformer_torch.kernels import build

K_TILE = 32  # csrc/dcn_conv_fwd.cu: a K tile never spans two taps


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
    b, h, w, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    dev = x.device
    ys = torch.arange(oh, dtype=torch.float32, device=dev) * stride - 1.0
    xs = torch.arange(ow, dtype=torch.float32, device=dev) * stride - 1.0
    k = torch.arange(3, dtype=torch.float32, device=dev)
    ky, kx = torch.meshgrid(k, k, indexing="ij")
    ky = ky.reshape(-1)
    kx = kx.reshape(-1)
    py = ys[None, :, None, None] + ky + off_y
    px = xs[None, None, :, None] + kx + off_x
    sampled = bilinear_gather(x.float(), py, px) * mask[..., None]
    return torch.einsum(
        "bhwi,io->bhwo", sampled.reshape(b, oh, ow, 9 * c), weight.float()
    )


def _check(x, off_y, off_x, mask, weight, stride):
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
    if weight.dim() != 2 or weight.shape[0] != 9 * c:
        raise ValueError(f"weight must be [9*C={9 * c}, Cout], got {tuple(weight.shape)}")
    if c % K_TILE:
        raise ValueError(f"channels {c} must be a multiple of {K_TILE}")
    for name, t in (("x", x), ("off_y", off_y), ("off_x", off_x),
                    ("mask", mask), ("weight", weight)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() >= 2**31:
            raise ValueError(f"{name} has {t.numel()} elements (limit 2^31)")
    if b * oh * ow * weight.shape[1] >= 2**31:
        raise ValueError("output has 2^31 elements or more")


def dcn_conv(x, off_y, off_x, mask, weight, stride: int = 1) -> torch.Tensor:
    """DCNv2 conv: the plain version for a CPU tensor, the CUDA kernel for
    a CUDA tensor (no fallback between the two)."""
    if x.device.type == "cpu":
        return dcn_conv_plain(x, off_y, off_x, mask, weight, stride)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_conv: unsupported device {x.device}")
    _check(x, off_y, off_x, mask, weight, stride)
    b, h, w, c = x.shape
    oh, ow = off_y.shape[1], off_y.shape[2]
    cout = weight.shape[1]
    out = torch.empty((b, oh, ow, cout), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dcn_conv_fwd(
            x.data_ptr(), off_y.data_ptr(), off_x.data_ptr(),
            mask.data_ptr(), weight.data_ptr(), out.data_ptr(),
            b, h, w, c, oh, ow, cout, stride, stream,
        )
    build.check_launch("dcn_conv_fwd", rc)
    dcn_conv.launches += 1
    return out


dcn_conv.launches = 0
