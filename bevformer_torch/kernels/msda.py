"""Multi-scale deformable attention (msda), forward.

For every (batch, query, head, level, point): sample the value map of that
level bilinearly at the normalised location (the `grid_sample`
`align_corners=False` convention, pixel = loc * size - 0.5, zeros outside
the map), multiply by the attention weight, and sum over (level, point) in
fp32. The spec is `bevformer_tpu/kernels/msda.py::ms_deform_attn_jnp`.

Layouts are batch-first: value [B, K, H, D], locations [B, Q, H, L, P, 2],
weights [B, Q, H, L, P] -> output [B, Q, H*D].

`ms_deform_attn` runs the CUDA kernel `csrc/msda_fwd.cu` on a CUDA tensor
and the plain PyTorch version `ms_deform_attn_plain` on a CPU tensor.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from bevformer_torch.kernels import build

MAX_LEVELS = 8  # csrc/msda_fwd.cu

Shapes = Sequence[Tuple[int, int]]


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Gather formulation of msda in plain PyTorch (any device)."""
    b, k, h, d = value.shape
    _, q, _, l, p, _ = sampling_locations.shape
    assert sum(hh * ww for hh, ww in spatial_shapes) == k, (spatial_shapes, k)
    loc = sampling_locations.float()
    attw = attention_weights.float()
    val = value.float().transpose(1, 2).reshape(b * h, k, d)

    out = value.new_zeros((b * h, q, d), dtype=torch.float32)
    start = 0
    for lvl, (hh, ww) in enumerate(spatial_shapes):
        val_l = val[:, start:start + hh * ww]
        start += hh * ww
        x = loc[:, :, :, lvl, :, 0] * ww - 0.5  # [B, Q, H, P]
        y = loc[:, :, :, lvl, :, 1] * hh - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        tx = x - x0
        ty = y - y0
        x0i = x0.long()
        y0i = y0.long()
        w_l = attw[:, :, :, lvl, :]
        for dy, dx, wgt in (
            (0, 0, (1 - tx) * (1 - ty)),
            (0, 1, tx * (1 - ty)),
            (1, 0, (1 - tx) * ty),
            (1, 1, tx * ty),
        ):
            cx = x0i + dx
            cy = y0i + dy
            valid = (cx >= 0) & (cx < ww) & (cy >= 0) & (cy < hh)
            idx = cy.clamp(0, hh - 1) * ww + cx.clamp(0, ww - 1)
            cw = wgt * w_l * valid.float()
            idx_bh = idx.transpose(1, 2).reshape(b * h, q * p)
            cw_bh = cw.transpose(1, 2).reshape(b * h, q, p)
            g = torch.gather(
                val_l, 1, idx_bh[:, :, None].expand(-1, -1, d)
            ).view(b * h, q, p, d)
            out += torch.einsum("nqp,nqpd->nqd", cw_bh, g)

    out = out.view(b, h, q, d).transpose(1, 2).reshape(b, q, h * d)
    return out.to(value.dtype)


def _check(value, spatial_shapes, loc, attw):
    if value.dim() != 4:
        raise ValueError(f"value must be [B, K, H, D], got {tuple(value.shape)}")
    b, k, h, d = value.shape
    if loc.dim() != 6 or loc.shape[0] != b or loc.shape[2] != h or loc.shape[5] != 2:
        raise ValueError(
            f"locations must be [B, Q, H, L, P, 2] = [{b}, Q, {h}, L, P, 2], "
            f"got {tuple(loc.shape)}"
        )
    q, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    if tuple(attw.shape) != (b, q, h, l, p):
        raise ValueError(
            f"attention weights must be {(b, q, h, l, p)}, got {tuple(attw.shape)}"
        )
    if len(spatial_shapes) != l or not 1 <= l <= MAX_LEVELS:
        raise ValueError(
            f"{len(spatial_shapes)} spatial shapes for {l} levels "
            f"(the kernel takes 1..{MAX_LEVELS})"
        )
    if sum(hh * ww for hh, ww in spatial_shapes) != k:
        raise ValueError(f"spatial shapes {spatial_shapes} do not sum to K={k}")
    if d % 32:
        raise ValueError(f"head dim {d} must be a multiple of 32")
    for name, t in (("value", value), ("locations", loc), ("weights", attw)):
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() >= 2**31:
            raise ValueError(f"{name} has {t.numel()} elements (limit 2^31)")


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """msda forward: the plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor (no fallback between the two)."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn: unsupported device {value.device}")
    spatial_shapes = tuple((int(hh), int(ww)) for hh, ww in spatial_shapes)
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    b, k, h, d = value.shape
    q, l, p = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    out = torch.empty((b, q, h * d), dtype=torch.float32, device=value.device)
    level_hw = np.asarray(spatial_shapes, dtype=np.int32).reshape(-1)
    lib = build.library()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_fwd(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), out.data_ptr(),
            level_hw.ctypes.data, l, b, k, q, h, d, p, stream,
        )
    build.check_launch("msda_fwd", rc)
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0
