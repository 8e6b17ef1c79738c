"""The least time the card could take for each kernel's call, from its shapes.

Plain Python on shapes; it runs anywhere and measures nothing. For each call
it counts the bytes the function must move and the operations it must do:

- every input byte is read once and every output byte written once, however
  often the kernel reads it again, each at its dtype's size (msda's value,
  output, grad_out and dValue, and the DCN's x, output, column and dx, in
  fp32 or bf16); for msda the whole value tensor counts as read once (the
  samples may touch any of it);
- operations are fp32 arithmetic, an FMA counted as two: per msda sample
  (batch, query, head, level, point) 14 for the pixel position and the four
  corner weights, and per channel 2 for each of the four corners it sums;
  per DCN tap and channel 8 for the four corners, and 2 * Cout for the
  contraction.

Each kind of operation counts against the units that can do it at fp32
accuracy:

- DCN's contraction (K2) and the dense convs' (`conv_fwd`) on the tensor
  cores in TF32, at three TF32
  products per fp32 multiply-add (3xTF32: big*big' + big*small' +
  small*big', the least that keeps fp32's accuracy; one TF32 product misses
  the port's 1e-4 tolerance at K = 9*256), against 495 TFLOP/s dense TF32;
  on a bf16 x one bf16 product per multiply-add, against 989 TFLOP/s dense
  bf16;
- everything else (sampling, msda, the backward kernels) on the fp32 SIMT
  units, against 67 TFLOP/s.

`bound_ms` is the largest of bytes over the memory rate and each kind of
operations over its rate, and `bound_by` names which of bytes and
operations. The rates are the NVIDIA H100 SXM data sheet's, at its 700 W
power limit; a card set below it runs slower under load, so a measurement
states its card's `nvidia-smi` name and power limit beside its share of the
bound.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
PEAKS = ("H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s fp32 (SIMT), "
         "495 TFLOP/s TF32 and 989 TFLOP/s bf16 tensor cores (dense), 700 W")

F32 = 4
BF16 = 2
SAMPLE_FLOPS = 14  # pixel position and four corner weights of one msda sample
TF32_PRODUCTS = 3  # TF32 tensor-core products per fp32-accurate multiply-add


@dataclass(frozen=True)
class Cost:
    bytes: float
    flops: float  # fp32 operations on the SIMT units
    tf32_flops: float = 0.0  # TF32 tensor-core operations, as issued
    bf16_flops: float = 0.0  # bf16 tensor-core operations

    @property
    def bytes_ms(self) -> float:
        return self.bytes / HBM_BYTES_PER_S * 1e3

    @property
    def flops_ms(self) -> float:
        return max(self.flops / FP32_FLOPS, self.tf32_flops / TF32_FLOPS,
                   self.bf16_flops / BF16_FLOPS) * 1e3

    @property
    def bound_ms(self) -> float:
        return max(self.bytes_ms, self.flops_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.flops_ms else "operations"

    def as_dict(self) -> dict:
        return dict(bytes=self.bytes, flops=self.flops, tf32_flops=self.tf32_flops,
                    bf16_flops=self.bf16_flops, bound_ms=self.bound_ms,
                    bound_by=self.bound_by)


def total(calls: Sequence[Tuple[Cost, int]]) -> dict:
    """The bound of `n` launches of each call, summed call by call; bound by
    what bounds the call that contributes most."""
    bound = sum(c.bound_ms * n for c, n in calls)
    top = max(calls, key=lambda cn: cn[0].bound_ms * cn[1])[0]
    return dict(bound_ms=bound, bound_by=top.bound_by)


def _msda_bytes(b, q, h, d, shapes, p, itemsize):
    """(samples, value, loc, attw, out bytes) of one msda call: value and
    out at `itemsize` bytes an element, loc and attw fp32."""
    k = sum(hh * ww for hh, ww in shapes)
    samples = b * q * h * len(shapes) * p
    return (samples, b * k * h * d * itemsize, samples * 2 * F32, samples * F32,
            b * q * h * d * itemsize)


def msda_fwd(b: int, q: int, h: int, d: int, shapes, p: int, mode: str = "full",
             itemsize: int = F32) -> Cost:
    """One msda forward (K1, K7) or one of its probe modes: value [b, K, h, d],
    loc [b, q, h, L, p, 2], attw [b, q, h, L, p] -> out [b, q, h*d]; value
    and out of `itemsize` bytes an element (4 fp32, 2 bf16), the arithmetic
    fp32 either way. `gather` needs no attw, `weights` and `noop` no value;
    `weights` adds the four corner weights, `noop` sums attw."""
    samples, value, loc, attw, out = _msda_bytes(b, q, h, d, shapes, p, itemsize)
    if mode == "full":
        return Cost(value + loc + attw + out, samples * (SAMPLE_FLOPS + 8 * d))
    if mode == "gather":
        return Cost(value + loc + out, samples * (SAMPLE_FLOPS + 4 * d))
    if mode == "weights":
        return Cost(loc + attw + out, samples * (SAMPLE_FLOPS + 4))
    if mode == "noop":
        return Cost(loc + attw + out, samples)
    raise ValueError(f"unknown mode {mode!r}")


def msda_bwd(b: int, q: int, h: int, d: int, shapes, p: int, itemsize: int = F32) -> Cost:
    """One msda backward (K3/K4): reads value, loc, attw and grad_out, writes
    dvalue, dloc and dattw; value, grad_out and dvalue of `itemsize` bytes
    an element, loc, attw and their gradients fp32. Per sample and channel:
    the four corners resampled (8), the dAttw dot (2), the dLoc dots of
    corner differences (8) and the four dValue adds (8)."""
    samples, value, loc, attw, out = _msda_bytes(b, q, h, d, shapes, p, itemsize)
    return Cost(2 * (value + loc + attw) + out, samples * (SAMPLE_FLOPS + 26 * d))


def _dcn_sizes(b, h, w, c, stride, itemsize):
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    taps = b * oh * ow * 9
    # x at `itemsize` bytes an element, and off_y, off_x and mask [b, oh, ow, 9]
    return b * oh * ow, taps, b * h * w * c * itemsize, 3 * taps * F32


def dcn_conv(b: int, h: int, w: int, c: int, cout: int, stride: int = 1,
             itemsize: int = F32) -> Cost:
    """One DCNv2 forward (K2): x [b, h, w, c], offsets and mask, weight
    [9c, cout] (fp32) -> out [b, oh, ow, cout]; x and out of `itemsize`
    bytes an element; sampling (8 per tap and channel) on the SIMT units and
    the contraction (2 * cout per tap and channel) on the tensor cores,
    three TF32 products each in fp32, one bf16 product on a bf16 x."""
    pixels, taps, x, offsets = _dcn_sizes(b, h, w, c, stride, itemsize)
    contraction = taps * c * 2 * cout
    return Cost(x + offsets + 9 * c * cout * F32 + pixels * cout * itemsize, taps * c * 8,
                TF32_PRODUCTS * contraction if itemsize == F32 else 0.0,
                contraction if itemsize == BF16 else 0.0)


def dcn_im2col(b: int, h: int, w: int, c: int, stride: int = 1, itemsize: int = F32) -> Cost:
    """One modulated im2col (K5): x and offsets -> cols [b*oh*ow, 9c], x and
    cols of `itemsize` bytes an element."""
    _, taps, x, offsets = _dcn_sizes(b, h, w, c, stride, itemsize)
    return Cost(x + offsets + taps * c * itemsize, taps * c * 8)


def dcn_col2im(b: int, h: int, w: int, c: int, stride: int = 1, itemsize: int = F32) -> Cost:
    """One DCN col2im (K6): x, offsets and dcols [b*oh*ow, 9c] (fp32) -> dx,
    d offsets, dmask; x and dx of `itemsize` bytes an element. Per tap and
    channel: dx's four corner adds (8), the resample for dmask (8) and the
    offset slopes (8)."""
    _, taps, x, offsets = _dcn_sizes(b, h, w, c, stride, itemsize)
    return Cost(2 * (x + offsets) + taps * c * F32, taps * c * 24)


def dcn_col2im_gw(b: int, h: int, w: int, c: int, cout: int, stride: int = 1) -> Cost:
    """One sampling backward of the DCN on a bf16 x from the output gradient
    (bf16 K6, `dcn_col2im_gw`): x (bf16), offsets, mask, g [b*oh*ow, cout]
    (bf16) and the fp32 weight [9c, cout] -> dx (bf16), d offsets, dmask.
    The column gradient g W^T [b*oh*ow, 9c] is made inside and never
    stored: its product (2 * cout per tap and channel) is one bf16 product
    per multiply-add on the tensor cores; the scatter is K6's 24 per tap
    and channel on the SIMT units. dx's fp32 workspace and its atomic adds
    are the kernel's, not the function's: not counted."""
    pixels, taps, x, offsets = _dcn_sizes(b, h, w, c, stride, BF16)
    return Cost(2 * (x + offsets) + pixels * cout * BF16 + 9 * c * cout * F32, taps * c * 24,
                bf16_flops=taps * c * 2 * cout)


def conv_fwd(b: int, h: int, w: int, cin: int, oh: int, ow: int, cout: int, k: int,
             residual: bool = False) -> Cost:
    """One dense conv with its epilogue (`conv_fwd`): x [b, h, w, cin], the
    weight [cout, cin, k, k], scale and shift [cout], and where added the
    residual [b, oh, ow, cout] -> out [b, oh, ow, cout], all fp32. Of x the
    pixels its taps touch are read (a quarter at a 1x1 stride-2 conv). The
    contraction (2 * cin * k * k an output) at three TF32 products each;
    the epilogue's affine (2 an output) and add (1) on the SIMT units."""
    m = b * oh * ow
    read = b * min(h * w, oh * ow * k * k) * cin
    contraction = 2.0 * m * cout * cin * k * k
    return Cost(F32 * (read + cout * cin * k * k + 2 * cout + m * cout * (2 if residual else 1)),
                m * cout * (3 if residual else 2), TF32_PRODUCTS * contraction)


def row_gather(b: int, m: int, r: int, e: int, itemsize: int) -> Cost:
    """One row gather: src [b, m, e], idx [b, r] int32 -> out [b, r, e]; no
    arithmetic."""
    return Cost(b * m * e * itemsize + b * r * 4 + b * r * e * itemsize, 0)
