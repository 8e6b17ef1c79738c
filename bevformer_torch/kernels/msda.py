"""Multi-scale deformable attention (msda), forward and backward.

For every (batch, query, head, level, point): sample the value map of that
level bilinearly at the normalised location (the `grid_sample`
`align_corners=False` convention, pixel = loc * size - 0.5, zeros outside
the map), multiply by the attention weight, and sum over (level, point) in
fp32. The spec is `bevformer_tpu/kernels/msda.py::ms_deform_attn_jnp`.

Layouts are batch-first: value [B, K, H, D], locations [B, Q, H, L, P, 2],
weights [B, Q, H, L, P] -> output [B, Q, H*D]. The value is fp32 or bf16,
and the output has its dtype (a bf16 value is read as fp32 exactly, the sums
run in fp32 and the output is rounded to bf16 once: the JAX function on a
bf16 value); locations and weights are fp32.

`ms_deform_attn` runs the CUDA kernel `csrc/msda_fwd.cu` on a CUDA tensor
(its C entry `msda_fwd`, or `msda_fwd_bf16` for a bf16 value), as a
`torch.autograd.Function` whose backward is `ms_deform_attn_backward` (the
CUDA kernel `csrc/msda_bwd.cu`, on the forward's block mapping and tile;
`msda_bwd_bf16` for a bf16 value, which sums dValue in an fp32 workspace),
and the plain PyTorch version `ms_deform_attn_plain` under ordinary autograd
on a CPU tensor. The bf16 entries take their tile from `k1_bf16_tile`. A
bf16 launch counts on `MSDA_FWD_BF16` / `MSDA_BWD_BF16`, an fp32 one on the
wrapper, and each launch of K1 or K3/K4 also counts its (B, Q) in
`QUERIES`. The backward's plain version
`ms_deform_attn_backward_plain` is autograd through
`ms_deform_attn_plain`.

`ms_deform_attn_ho` computes the same forward with the heads-outer kernel
`csrc/msda_fwd_ho.cu` (the counterpart of the JAX package's
`msda_pallas.py::_kernel`), forward only. `msda_probe` runs either forward
kernel in one of the cost-split modes of `csrc/msda_fwd.cuh` (and the
heads-outer one at another tile), for the probes in `bevformer_torch/tools`;
`msda_probe_plain` is each mode's plain version. K7 and the probes take an
fp32 value only.
"""

from __future__ import annotations

import collections
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from bevformer_torch.kernels import build

MAX_LEVELS = 8  # csrc/msda_fwd.cuh

Shapes = Sequence[Tuple[int, int]]

FP32_ONLY = (torch.float32,)
VALUE_DTYPES = (torch.float32, torch.bfloat16)  # K1 and K3/K4


class LaunchCount:
    """The launch count (`.launches`, as each wrapper keeps its own) of a
    kernel entry that a wrapper reaches beside the one it counts on
    itself."""

    def __init__(self):
        self.launches = 0


MSDA_FWD_BF16 = LaunchCount()  # ms_deform_attn on a bf16 value
MSDA_BWD_BF16 = LaunchCount()  # ms_deform_attn_backward on a bf16 value
# launches of K1 and K3/K4 by (B, Q), under their counters' names
QUERIES = {k: collections.Counter()
           for k in ("msda_fwd", "msda_fwd_bf16", "msda_bwd", "msda_bwd_bf16")}


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Gather formulation of msda in plain PyTorch (any device), in fp32
    whatever the autocast around it."""
    with torch.autocast(value.device.type, enabled=False):
        return _corner_sum(value, spatial_shapes, sampling_locations, attention_weights)


def _corner_sum(value, spatial_shapes, sampling_locations, attention_weights,
                unit_weights: bool = False) -> torch.Tensor:
    """Sum over (level, point, in-bounds corner) of the corner's value times
    bilinear weight * attw, or times 1 with `unit_weights`."""
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
        w_l = attw[:, :, :, lvl, :]
        for idx, wgt, valid in _corners(loc[:, :, :, lvl], hh, ww):
            cw = valid.float() if unit_weights else wgt * w_l * valid.float()
            idx_bh = idx.transpose(1, 2).reshape(b * h, q * p)
            cw_bh = cw.transpose(1, 2).reshape(b * h, q, p)
            g = torch.gather(
                val_l, 1, idx_bh[:, :, None].expand(-1, -1, d)
            ).view(b * h, q, p, d)
            out += torch.einsum("nqp,nqpd->nqd", cw_bh, g)

    out = out.view(b, h, q, d).transpose(1, 2).reshape(b, q, h * d)
    return out.to(value.dtype)


def _corners(loc_l: torch.Tensor, hh: int, ww: int):
    """The four bilinear corners of one level's locations [B, Q, H, P, 2]:
    for each, the clamped pixel index (long), the bilinear weight and
    whether the corner lies on the map, each [B, Q, H, P]."""
    x = loc_l[..., 0] * ww - 0.5
    y = loc_l[..., 1] * hh - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    x0i = x0.long()
    y0i = y0.long()
    for dy, dx, wgt in (
        (0, 0, (1 - tx) * (1 - ty)),
        (0, 1, tx * (1 - ty)),
        (1, 0, (1 - tx) * ty),
        (1, 1, tx * ty),
    ):
        cx = x0i + dx
        cy = y0i + dy
        valid = (cx >= 0) & (cx < ww) & (cy >= 0) & (cy < hh)
        yield cy.clamp(0, hh - 1) * ww + cx.clamp(0, ww - 1), wgt, valid


def _check(value, spatial_shapes, loc, attw, value_dtypes=FP32_ONLY):
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
    if value.dtype not in value_dtypes:
        raise TypeError(f"value must be {' or '.join(map(str, value_dtypes))}, got {value.dtype}")
    for name, t in (("value", value), ("locations", loc), ("weights", attw)):
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if t is not value and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.numel() >= 2**31:
            raise ValueError(f"{name} has {t.numel()} elements (limit 2^31)")


def _level_hw(spatial_shapes: Shapes) -> np.ndarray:
    return np.asarray(spatial_shapes, dtype=np.int32).reshape(-1)


def _cuda_args(name, value, spatial_shapes, loc, attw, value_dtypes=FP32_ONLY):
    """The checked spatial shapes, as ints, of a call that launches a
    kernel; a tensor on neither the CPU nor a card raises, and so does a
    value of a dtype outside `value_dtypes`."""
    if value.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {value.device}")
    spatial_shapes = tuple((int(hh), int(ww)) for hh, ww in spatial_shapes)
    _check(value, spatial_shapes, loc, attw, value_dtypes)
    return spatial_shapes


def _launch(entry: str, value, spatial_shapes, loc, attw, *extra: int) -> torch.Tensor:
    """One launch of a forward entry (`msda_fwd`, `msda_fwd_bf16`,
    `msda_fwd_probe`, `msda_fwd_ho`), whose C arguments are value, loc,
    attw, out (value's dtype), level_hw, L, B, K, Q, H, D, P, then `extra`,
    then the stream."""
    b, k, h, d = value.shape
    q, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    out = torch.empty((b, q, h * d), dtype=value.dtype, device=value.device)
    level_hw = _level_hw(spatial_shapes)
    lib = build.library()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            value.data_ptr(), loc.data_ptr(), attw.data_ptr(), out.data_ptr(),
            level_hw.ctypes.data, l, b, k, q, h, d, p, *extra, stream,
        )
    build.check_launch(entry, rc)
    return out


K1_TILES = (1, 2, 4, 8, 16, 32, 64, 128)  # csrc/msda_fwd.cu: queries per block
K1_ITEMS = 512  # samples per block K1's tile aims at: two per thread in phase 1
K1_MIN_BLOCKS_PER_SM = 2


def k1_tile(b: int, q: int, h: int, samples: int, sms: int) -> int:
    """K1's (and its backward's) queries per block for B `b`, Q `q`, H `h`
    and `samples` = L*P per query on a card of `sms` SMs: the largest tile
    of K1_TILES whose payload holds at most K1_ITEMS samples (TSA and the
    decoder 128, SCA 16), halved, down to 8, while the grid has fewer than
    K1_MIN_BLOCKS_PER_SM blocks per SM (the decoder's 900 queries: 16)."""
    tile = max([t for t in K1_TILES if t * samples <= K1_ITEMS] or [1])
    while tile > 8 and b * h * -(-q // tile) < K1_MIN_BLOCKS_PER_SM * sms:
        tile //= 2
    return tile


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def k1_tile_for(value, loc) -> int:
    """K1's (and its backward's) queries per block for these inputs on their
    card."""
    b, _, h, _ = value.shape
    q, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    return k1_tile(b, q, h, l * p, _sm_count(value.device))


K1_BF16_MIN_TILE = 32  # queries a pass of a block's 8 warps covers at SPLIT 1
K1_BF16_ITEMS = 2 * K1_ITEMS  # samples a bf16 block's payload holds at most (32 KB)


def k1_bf16_tile(b: int, q: int, h: int, samples: int, sms: int) -> int:
    """bf16 K1's (and its backward's) queries per block for B `b`, Q `q`, H
    `h` and `samples` = L*P per query on a card of `sms` SMs. bf16 K1 gives
    each 8-lane group whole queries (SPLIT 1), so a block's 8 warps cover
    32 queries a pass: K1's tile (`k1_tile`), doubled up to
    K1_BF16_MIN_TILE while the payload holds at most K1_BF16_ITEMS samples
    (SCA 32, TSA 128, the decoder 32)."""
    tile = k1_tile(b, q, h, samples, sms)
    while tile < K1_BF16_MIN_TILE and 2 * tile * samples <= K1_BF16_ITEMS:
        tile *= 2
    return tile


def k1_bf16_tile_for(value, loc) -> int:
    """`k1_bf16_tile` for these inputs on their card."""
    b, _, h, _ = value.shape
    q, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    return k1_bf16_tile(b, q, h, l * p, _sm_count(value.device))


def msda_tile_for(value, loc) -> int:
    """K1's and K3/K4's queries per block for these inputs: `k1_bf16_tile`
    on a bf16 value, `k1_tile` on an fp32 one."""
    return (k1_bf16_tile_for if value.dtype == torch.bfloat16 else k1_tile_for)(value, loc)


def _launch_fwd(value, spatial_shapes, loc, attw) -> torch.Tensor:
    bf16 = value.dtype == torch.bfloat16
    entry = "msda_fwd_bf16" if bf16 else "msda_fwd"
    out = _launch(entry, value, spatial_shapes, loc, attw, msda_tile_for(value, loc))
    (MSDA_FWD_BF16 if bf16 else ms_deform_attn).launches += 1
    QUERIES[entry][tuple(loc.shape[:2])] += 1
    return out


class _MSDeformAttn(torch.autograd.Function):
    """K1 forward, `msda_bwd` backward. Saves the three inputs; the
    backward recomputes each point's corners."""

    @staticmethod
    def forward(ctx, value, loc, attw, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, attw)
        return _launch_fwd(value, spatial_shapes, loc, attw)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attw = ctx.saved_tensors
        # autograd may hand over a strided view (a transpose downstream)
        dvalue, dloc, dattw = ms_deform_attn_backward(
            value, ctx.spatial_shapes, loc, attw, grad_out.contiguous()
        )
        return dvalue, dloc, dattw, None


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """msda forward: the plain version (under ordinary autograd) for a CPU
    tensor, the CUDA kernel for a CUDA tensor (fp32 or bf16 value, fp32
    locations and weights; anything else raises), differentiable through
    `msda_bwd` (no fallback between the two, nor between the dtypes)."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    spatial_shapes = _cuda_args("ms_deform_attn", value, spatial_shapes,
                                sampling_locations, attention_weights, VALUE_DTYPES)
    return _MSDeformAttn.apply(
        value, sampling_locations, attention_weights, spatial_shapes
    )


ms_deform_attn.launches = 0


def ms_deform_attn_backward_plain(value, spatial_shapes, loc, attw, grad_out):
    """(dValue, dLoc, dAttw) by autograd through `ms_deform_attn_plain`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (value, loc, attw)]
        out = ms_deform_attn_plain(leaves[0], spatial_shapes, leaves[1], leaves[2])
        return torch.autograd.grad(out, leaves, grad_out)


def _check_grad(value, loc, grad_out):
    b, _, h, d = value.shape
    want = (b, loc.shape[1], h * d)
    if tuple(grad_out.shape) != want:
        raise ValueError(f"grad_out must be {want}, got {tuple(grad_out.shape)}")
    if grad_out.device != value.device or grad_out.dtype != value.dtype:
        raise TypeError(f"grad_out must be {value.dtype} (the value's) on {value.device}")
    if not grad_out.is_contiguous():
        raise ValueError("grad_out must be contiguous")


def _launch_bwd(value, spatial_shapes, loc, attw, grad_out, tile: int):
    """One launch of `msda_bwd` (`msda_bwd_bf16` for a bf16 value) at `tile`
    queries per block: (dValue in the value's dtype, dLoc, dAttw). The
    kernel adds dValue into an fp32 workspace; a bf16 dValue is that sum
    rounded once."""
    b, k, h, d = value.shape
    q, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    entry = "msda_bwd_bf16" if value.dtype == torch.bfloat16 else "msda_bwd"
    dvalue = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    dloc = torch.empty_like(loc)
    dattw = torch.empty_like(attw)
    level_hw = _level_hw(spatial_shapes)
    lib = build.library()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            value.data_ptr(), loc.data_ptr(), attw.data_ptr(),
            grad_out.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
            dattw.data_ptr(), level_hw.ctypes.data, l, b, k, q, h, d, p, tile, stream,
        )
    build.check_launch(entry, rc)
    return dvalue.to(value.dtype), dloc, dattw


def ms_deform_attn_backward(value, spatial_shapes, loc, attw, grad_out):
    """msda backward: grad_out [B, Q, H*D] (the value's dtype) -> dValue
    [B, K, H, D] in the value's dtype, dLoc [B, Q, H, L, P, 2] and dAttw
    [B, Q, H, L, P] in fp32. The plain version for a CPU tensor, the CUDA
    kernel `msda_bwd` for a CUDA tensor, at the forward's tile for the shape
    (`msda_tile_for`)."""
    if value.device.type == "cpu":
        return ms_deform_attn_backward_plain(value, spatial_shapes, loc, attw, grad_out)
    spatial_shapes = _cuda_args("ms_deform_attn_backward", value, spatial_shapes, loc, attw,
                                VALUE_DTYPES)
    _check_grad(value, loc, grad_out)
    grads = _launch_bwd(value, spatial_shapes, loc, attw, grad_out, msda_tile_for(value, loc))
    bf16 = value.dtype == torch.bfloat16
    (MSDA_BWD_BF16 if bf16 else ms_deform_attn_backward).launches += 1
    QUERIES["msda_bwd_bf16" if bf16 else "msda_bwd"][tuple(loc.shape[:2])] += 1
    return grads


ms_deform_attn_backward.launches = 0


# ---------------------------------------------------------------- K7 and probes

PROBE_MODES = ("full", "gather", "weights", "noop")  # csrc/msda_fwd.cuh MsdaMode
# the (queries per block, accumulator sets per 8-lane group) that
# csrc/msda_fwd_ho.cu takes; its C entry refuses any other, and one too
# large for shared memory, with cudaErrorInvalidValue
HO_TILES = (8, 16, 32, 64)
HO_ACCS = (1, 2)
HO_TILE, HO_ACC = 16, 1  # ms_deform_attn_ho's, and the other modes' (the fastest of the sweep)


def msda_probe_plain(mode: str, value, spatial_shapes, loc, attw) -> torch.Tensor:
    """The plain version of each probe mode, [B, Q, H*D] fp32 (see
    csrc/msda_fwd.cuh): `full` the msda; `gather` the sum over (level,
    point) of the in-bounds corners' values; `weights` the sum of the
    in-bounds corners' bilinear weight * attw and `noop` the sum of attw,
    both the same in every channel."""
    if mode == "full":
        return ms_deform_attn_plain(value, spatial_shapes, loc, attw)
    if mode not in PROBE_MODES:
        raise ValueError(f"unknown probe mode {mode!r}: {PROBE_MODES}")
    b, k, h, d = value.shape
    q = loc.shape[1]
    attw = attw.float()
    if mode == "noop":
        per_head = attw.sum((3, 4))
    elif mode == "weights":
        per_head = attw.new_zeros((b, q, h))
        for lvl, (hh, ww) in enumerate(spatial_shapes):
            for _, wgt, valid in _corners(loc[:, :, :, lvl].float(), hh, ww):
                per_head += (wgt * attw[:, :, :, lvl] * valid.float()).sum(-1)
    else:  # gather: ms_deform_attn_plain with unit weights
        return _corner_sum(value, spatial_shapes, loc, attw, unit_weights=True)
    return per_head[..., None].expand(b, q, h, d).reshape(b, q, h * d)


def _launch_ho(value, spatial_shapes, loc, attw, mode: str, tile: int, acc: int):
    return _launch("msda_fwd_ho", value, spatial_shapes, loc, attw,
                   PROBE_MODES.index(mode), tile, acc)


def ms_deform_attn_ho(value, spatial_shapes, sampling_locations, attention_weights):
    """msda forward by the heads-outer kernel K7 (`csrc/msda_fwd_ho.cu`, at
    tile HO_TILE, HO_ACC accumulators): the plain version for a CPU tensor,
    the kernel for a CUDA tensor. Same function and layouts as
    `ms_deform_attn`. Forward only, not differentiable: the model's msda
    runs K1 and its backward kernel through `ms_deform_attn`."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    shapes = _cuda_args("ms_deform_attn_ho", value, spatial_shapes, sampling_locations,
                        attention_weights)
    out = _launch_ho(value, shapes, sampling_locations, attention_weights, "full",
                     HO_TILE, HO_ACC)
    ms_deform_attn_ho.launches += 1
    return out


ms_deform_attn_ho.launches = 0


def msda_probe(kernel: str, mode: str, value, spatial_shapes, sampling_locations,
               attention_weights, tile: int = HO_TILE, acc: int = HO_ACC) -> torch.Tensor:
    """One probe launch: `kernel` "hi" (K1, `csrc/msda_fwd.cu`; modes gather,
    weights, noop: its `full` is `ms_deform_attn`) or "ho" (K7,
    `csrc/msda_fwd_ho.cu`; `full` at any (tile, acc) of HO_TILES x HO_ACCS,
    the other modes at HO_TILE, HO_ACC). The plain version
    `msda_probe_plain(mode, ...)` for a CPU tensor, the kernel for a CUDA
    tensor. Forward only."""
    if kernel not in ("hi", "ho") or mode not in PROBE_MODES or (kernel, mode) == ("hi", "full"):
        raise ValueError(f"no probe {kernel!r} {mode!r}")
    if value.device.type == "cpu":
        return msda_probe_plain(mode, value, spatial_shapes, sampling_locations,
                                attention_weights)
    shapes = _cuda_args("msda_probe", value, spatial_shapes, sampling_locations,
                        attention_weights)
    if kernel == "ho":
        out = _launch_ho(value, shapes, sampling_locations, attention_weights, mode, tile, acc)
    else:
        out = _launch("msda_fwd_probe", value, shapes, sampling_locations, attention_weights,
                      PROBE_MODES.index(mode), k1_tile_for(value, sampling_locations))
    msda_probe.launches += 1
    return out


msda_probe.launches = 0
