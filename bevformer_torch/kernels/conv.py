"""Dense 2-D convolution forward with the per-channel affine, the residual
add and the ReLU after it: a backbone or neck conv with the norm that
follows it,

    out = act(conv2d(x, weight) * scale + shift (+ residual)).

Layouts are channels-last: x [B, H, W, Cin], the weight nn.Conv2d's [Cout,
Cin, KH, KW], scale and shift [Cout], the residual and the output [B, OH,
OW, Cout]; all fp32. Zero padding and any stride; no groups or dilation.

`conv2d_nhwc` runs the CUDA kernel `csrc/conv_fwd.cu` on a CUDA tensor, a
forward only (no gradient is recorded through it), and the plain version
`conv2d_nhwc_plain` (F.conv2d, then the affine, the add and the ReLU) on a
CPU tensor. The kernel reads the weight prepared once by `conv_weight_prep`
(split into its TF32 halves, in its tile order), which `cached` keeps per
parameter and makes again when the parameter's storage or version changes
(`load_state_dict`, an optimizer step, `.to()`).

`engage_rule` is the rule by which the model's convs take the kernel or
keep the present path (`models/resnet.py::conv_norm`).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from bevformer_torch.kernels import build
from bevformer_torch.kernels.dcn import _check_tensor

K_TILE = 32  # csrc/conv_fwd.cu: BK, a K tile within one tap: Cin a multiple of it
COUT_STEP = 64  # the narrower column block: Cout a multiple of it
MAX_ELEMENTS = 2**31  # csrc/conv_fwd.cu indexes x, the residual and the output in int32

# per owner (a weight parameter): {name: (key of the tensors it was made
# from, value)}
_CACHE = WeakIdKeyDictionary()


def engage_rule(device_type: str, dtype: torch.dtype, autocast: bool, records_grad: bool,
                norm_training: bool, cin: int, cout: int, plain: bool = True,
                elements: int = 0) -> bool:
    """Whether a conv (with the norm after it) takes the kernel: a CUDA
    fp32 call with autocast off, nothing recording a gradient, no norm in
    train mode, Cin a multiple of 32 and Cout of 64, a `plain` conv (no
    groups or dilation, zero padding, the same stride and padding along
    both axes), and fewer than 2^31 `elements` in x and in the output
    each. Anything else keeps the present path (cuDNN and the norm's own
    kernels)."""
    return (device_type == "cuda" and dtype == torch.float32 and not autocast
            and not records_grad and not norm_training and plain
            and cin % K_TILE == 0 and cout % COUT_STEP == 0 and elements < MAX_ELEMENTS)


M_TILE = 128  # csrc/conv_fwd.cu: BM, output pixels a tile


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def block_n(cout: int, m: int, sms: int) -> int:
    """The kernel's output channels a tile (the prepared weight's column
    block) for Cout and M output pixels on a card of `sms` SMs: 64 where
    Cout is no multiple of 128, or where 64 takes fewer rounds of the
    persistent grid, each round costed by the bytes a K tile copies (128
    pixels and 64 or 128 split weight columns); else 128."""
    if cout % 128:
        return COUT_STEP
    m_tiles = -(-m // M_TILE)

    def cost(bn):
        return -(-m_tiles * (cout // bn) // sms) * (M_TILE + 2 * bn)

    return COUT_STEP if cost(COUT_STEP) < cost(128) else 128


def _key(tensors: Sequence[Optional[torch.Tensor]]) -> tuple:
    return tuple(None if t is None else
                 (t.device, t.untyped_storage().data_ptr(), t.storage_offset(), t._version)
                 for t in tensors)


def cached(owner: torch.Tensor, name: str, tensors: Sequence[Optional[torch.Tensor]],
           make: Callable):
    """`make()`, kept for `owner` under `name` for as long as each of
    `tensors` keeps its storage, offset and version."""
    entry = _CACHE.setdefault(owner, {})
    key = _key(tensors)
    hit = entry.get(name)
    if hit is None or hit[0] != key:
        hit = entry[name] = (key, make())
    return hit[1]


def conv2d_nhwc_plain(x, weight, stride, padding, scale, shift, residual=None,
                      relu: bool = False) -> torch.Tensor:
    """The function in plain PyTorch (any device): F.conv2d on the NCHW view
    of x, then x * scale + shift per channel, the residual, the ReLU; the
    result as an NHWC view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=stride, padding=padding)
    y = y * scale[:, None, None] + shift[:, None, None]
    if residual is not None:
        y = y + residual.permute(0, 3, 1, 2)
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


def out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def _check(x, weight, stride, padding, scale, shift, residual):
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"x must be [B, H, W, Cin] and the weight [Cout, Cin, KH, KW], got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    b, h, w, cin = x.shape
    cout, wcin, kh, kw = weight.shape
    if wcin != cin:
        raise ValueError(f"weight has {wcin} input channels, x {cin}")
    if cin % K_TILE or cout % COUT_STEP:
        raise ValueError(f"Cin {cin} must be a multiple of {K_TILE} and Cout {cout} of {COUT_STEP}")
    if stride < 1 or padding < 0:
        raise ValueError(f"stride {stride}, padding {padding}")
    oh, ow = out_size(h, kh, stride, padding), out_size(w, kw, stride, padding)
    if oh < 1 or ow < 1:
        raise ValueError(f"no output at {h}x{w}, kernel {kh}x{kw}, stride {stride}")
    for name, t in (("x", x), ("weight", weight), ("scale", scale), ("shift", shift),
                    ("residual", residual)):
        if t is not None:
            _check_tensor(name, t, x.device)
    if scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError(f"scale and shift must be [{cout}]")
    if residual is not None and tuple(residual.shape) != (b, oh, ow, cout):
        raise ValueError(f"residual must be {(b, oh, ow, cout)}, got {tuple(residual.shape)}")
    if b * oh * ow * cout >= MAX_ELEMENTS:  # each tensor given: `_check_tensor`
        raise ValueError("output has 2^31 elements or more")
    return b, h, w, cin, oh, ow, cout, kh, kw


def _prepare(weight: torch.Tensor, bn: int) -> torch.Tensor:
    """The weight's TF32 halves in the kernel's tile order (one launch)."""
    cout, cin, kh, kw = weight.shape
    w = weight.detach().contiguous()
    prep = torch.empty(2 * w.numel(), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        rc = build.library().conv_weight_prep(
            w.data_ptr(), prep.data_ptr(), cout, cin, kh, kw, bn,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("conv_weight_prep", rc)
    return prep


def prepared_weight(weight: torch.Tensor, bn: int) -> torch.Tensor:
    """The kernel's copy of `weight` for column blocks of `bn`, made at
    most once per parameter version (`cached`)."""
    return cached(weight, f"prep{bn}", (weight,), lambda: _prepare(weight, bn))


def conv2d_nhwc(x, weight, stride: int, padding: int, scale, shift, residual=None,
                relu: bool = False) -> torch.Tensor:
    """`conv2d_nhwc_plain`'s function: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (contiguous fp32 x, weight, scale,
    shift and residual, Cin a multiple of 32, Cout of 64; anything else
    raises). Returns a contiguous [B, OH, OW, Cout] on the card."""
    if x.device.type == "cpu":
        return conv2d_nhwc_plain(x, weight, stride, padding, scale, shift, residual, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_nhwc: unsupported device {x.device}")
    b, h, w, cin, oh, ow, cout, kh, kw = _check(x, weight, stride, padding, scale, shift,
                                                residual)
    bn = block_n(cout, b * oh * ow, _sms(x.device.index or 0))
    prep = prepared_weight(weight, bn)
    out = torch.empty((b, oh, ow, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = build.library().conv_fwd(
            x.data_ptr(), prep.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            b, h, w, cin, oh, ow, cout, kh, kw, stride, padding, int(relu), bn,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("conv_fwd", rc)
    conv2d_nhwc.launches += 1
    return out


conv2d_nhwc.launches = 0
