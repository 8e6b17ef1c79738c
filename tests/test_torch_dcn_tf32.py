"""The arithmetic of K2 (`csrc/dcn_conv_fwd.cu`) on the CPU: its 3xTF32
contraction emulated in numpy.

The kernel splits each operand into big = rna(a) and small = rna(a - big),
both TF32 (cvt.rna.tf32.f32: round to 10 mantissa bits, to nearest, ties
away from zero), and for each 32-deep K tile adds small*big' and big*small' of its four
8-deep steps into fresh MMA accumulators, then big*big', one tensor-core
product each. The tensor
cores round each of those accumulations toward zero (on the H100 one
accumulator carried over K = 9*512 drifted ~4e-5 of the output's scale, as
the emulation below does), so the kernel sums each 32-deep K tile into
fresh accumulators and adds them into fp32 sums that round to nearest.

The emulation rounds by bit masks, takes each 8-deep product exactly
(float64 holds a product of two TF32 values), rounds each MMA accumulation
toward zero and each tile's add to nearest. Run on the plain sampled
column, it agrees with the JAX package's exact DCN path
(`ModulatedDeformConv(impl="off")`) to 1e-4 of scale, as the kernel must.
At K = 9*256 one TF32 product misses 1e-4 of scale while the split stays
within a few times the error of fp32 sums taken in the same order: why the
kernel splits. At K = 9*512 one truncating accumulator drifts, and the
kernel's tiles do not: why it sums per tile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.models.resnet import ModulatedDeformConv as JaxDCN
from bevformer_torch.kernels import dcn
from tests.test_torch_dcn import _port_dcn
from tests.torch_port_helpers import assert_close, t

K_STEP = 8  # the depth of one mma.m16n8k8
K_TILE = 32  # csrc/dcn_conv_fwd.cu: BK, the K tile summed in fresh accumulators


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 as cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties
    away from zero (add half the dropped ulp to the magnitude, then cut)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray):
    big = tf32_rna(a)
    return big, tf32_rna(a - big)


def f32_toward_zero(x: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _accumulate(pairs, k0: int, k1: int, acc: np.ndarray, rounding) -> np.ndarray:
    """Over K steps k0 .. k1: each (a, b) pair's exact 8-deep product added
    into `acc` and rounded by `rounding` (float64 -> float32), in order."""
    for k in range(k0, k1, K_STEP):
        s = slice(k, k + K_STEP)
        for a, b in pairs:
            acc = rounding(acc + a[:, s].astype(np.float64) @ b[s].astype(np.float64))
    return acc


def _to_nearest(x):
    return x.astype(np.float32)


def _pairs_3x(col, w):
    a_big, a_small = split(col)
    b_big, b_small = split(w)
    return [(a_small, b_big), (a_big, b_small), (a_big, b_big)]


def contract_kernel(col: np.ndarray, w: np.ndarray) -> np.ndarray:
    """col [M, K] @ w [K, N] as the kernel computes it: 3xTF32 products into
    MMA accumulators that truncate, fresh for each K tile (its small cross
    products first, then its big ones), each tile added into fp32 sums to
    nearest."""
    pairs = _pairs_3x(col, w)
    zeros = np.zeros((col.shape[0], w.shape[1]), np.float32)
    acc = zeros
    for k0 in range(0, col.shape[1], K_TILE):
        part = _accumulate(pairs[:2], k0, k0 + K_TILE, zeros, f32_toward_zero)
        part = _accumulate(pairs[2:], k0, k0 + K_TILE, part, f32_toward_zero)
        acc = (acc + part).astype(np.float32)
    return acc


def shrink(out: np.ndarray, ref: np.ndarray) -> float:
    """The systematic relative error: the slope of (out - ref) on ref."""
    e = out.astype(np.float64) - ref
    return float((e * ref).sum() / (ref * ref).sum())


def contract_one_accumulator(col, w):
    """3xTF32 into one truncating MMA accumulator over all of K (what the
    kernel does not do)."""
    zeros = np.zeros((col.shape[0], w.shape[1]), np.float32)
    return _accumulate(_pairs_3x(col, w), 0, col.shape[1], zeros, f32_toward_zero)


def contract_tf32(col, w):
    """One TF32 product per multiply-add, summed to nearest (what the kernel
    does not do)."""
    zeros = np.zeros((col.shape[0], w.shape[1]), np.float32)
    return _accumulate([(tf32_rna(col), tf32_rna(w))], 0, col.shape[1], zeros, _to_nearest)


def contract_fp32(col, w):
    """fp32 operands, fp32 sums to nearest in the kernel's order."""
    zeros = np.zeros((col.shape[0], w.shape[1]), np.float32)
    return _accumulate([(col, w)], 0, col.shape[1], zeros, _to_nearest)


def test_tf32_rounding_by_bit_masks():
    ulp = 2.0 ** -10  # of a TF32 value in [1, 2)
    a = np.array([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                  1 + 3 * ulp / 2, 3.0e-39, 0.0], np.float32)
    want = np.array([1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0e-39, 0.0], np.float32)
    got = tf32_rna(a)
    # the subnormal keeps its top 10 mantissa bits
    assert np.array_equal(got[:5], want[:5]) and got[6] == 0.0
    assert abs(got[5] - want[5]) <= 2.0 ** -136
    big, small = split(np.float32([np.pi]))
    assert big[0] + small[0] == pytest.approx(np.pi, rel=2.0 ** -21)
    assert tf32_rna(small)[0] == small[0] and tf32_rna(big)[0] == big[0]


@pytest.mark.parametrize("stride", [1, 2])
def test_3xtf32_contraction_of_the_plain_column_matches_jax(stride):
    rng = np.random.RandomState(20 + stride)
    b, h, w, cin, cout = 2, 9, 11, 32, 48
    x = rng.randn(b, h, w, cin).astype(np.float32)
    jmod = JaxDCN(cout, stride=stride, impl="off")
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    params = {"params": {
        "kernel": params["params"]["kernel"],
        "conv_offset": {
            "kernel": (rng.randn(3, 3, cin, 27) * 0.2).astype(np.float32),
            "bias": (rng.randn(27) * 1.0).astype(np.float32),
        },
    }}
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))

    mod = _port_dcn(params["params"], cin, cout, stride)
    with torch.no_grad():
        om = mod.conv_offset(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        off_y = om[..., 0:18:2].contiguous()
        off_x = om[..., 1:18:2].contiguous()
        mask = om[..., 18:].sigmoid().contiguous()
        col = dcn.dcn_im2col_plain(t(x), off_y, off_x, mask, stride).numpy()
        weight = mod.weight.permute(2, 3, 1, 0).reshape(9 * cin, cout).numpy()
    assert (np.abs(off_y.numpy()) > 2).mean() > 0.3, "too few |dy| > 2"
    out = contract_kernel(col, weight).reshape(ref.shape)
    assert_close(out, ref, 1e-4, f"3xTF32 stride {stride}")


def _stage_inputs(k: int, n: int, seed: int = 0):
    """A column of N(0, 1) * U(0, 1) values and N(0, 1/K) weights, and the
    float64 product's scale."""
    rng = np.random.RandomState(seed)
    col = (rng.randn(256, k) * rng.rand(256, k)).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    ref = col.astype(np.float64) @ w.astype(np.float64)
    return col, w, lambda out: float(np.abs(out - ref).max() / np.abs(ref).max())


def test_one_tf32_product_misses_the_tolerance_and_the_split_does_not():
    """K = 9 * 256 (stage 3), against the float64 product."""
    col, w, err = _stage_inputs(9 * 256, 256)
    one, kernel, fp32 = (err(f(col, w)) for f in (contract_tf32, contract_kernel, contract_fp32))
    assert one > 1e-4, one  # K2's tolerance
    assert kernel <= 4 * fp32 and kernel <= 1e-5, (kernel, fp32)


def test_one_truncating_accumulator_drifts_and_the_k_tiles_do_not():
    """K = 9 * 512 (stage 4): 1728 truncated adds into one accumulator drift
    past 2e-5 of scale, all the same way; fresh accumulators per 32-deep
    tile keep the error of fp32 sums."""
    col, w, err = _stage_inputs(9 * 512, 128)
    one, kernel, fp32 = (err(f(col, w)) for f in (
        contract_one_accumulator, contract_kernel, contract_fp32))
    assert one > 2e-5, one
    assert kernel <= 4 * fp32 and kernel <= 2e-6, (kernel, fp32)


def test_truncation_shrinks_the_output_and_the_tile_order_halves_it():
    """Truncated adds shrink every partial sum toward zero, so the output's
    error has a systematic part (a slope on the output) that fp32 sums to
    nearest do not have. Within a K tile, the small cross products go first:
    the big products' truncations then land on a running sum no larger than
    theirs, which halves the slope of interleaving the three."""
    col, w, _ = _stage_inputs(9 * 256, 128)
    ref = col.astype(np.float64) @ w.astype(np.float64)
    pairs = _pairs_3x(col, w)
    zeros = np.zeros(ref.shape, np.float32)
    interleaved = zeros
    for k0 in range(0, col.shape[1], K_TILE):
        interleaved = (interleaved + _accumulate(pairs, k0, k0 + K_TILE, zeros,
                                                 f32_toward_zero)).astype(np.float32)
    kernel, inter, fp32 = (shrink(o, ref) for o in (contract_kernel(col, w), interleaved,
                                                     contract_fp32(col, w)))
    assert inter < 2 * kernel < 0, (inter, kernel)
    assert abs(fp32) < abs(kernel) / 10, (fp32, kernel)
