"""The arithmetic of the dense conv kernel (`csrc/conv_fwd.cu`) on the CPU:
its prepared weight's layout and its 3xTF32 contraction emulated in numpy.

The kernel multiplies the implicit im2col of a channels-last x (k = (ky *
KW + kx) * Cin + c) with the weight prepared by `conv_weight_prep`: per
column block and 32-deep K tile, BN/8 x 8 core matrices of 8 columns x 4
k, with the k order permuted within each 8-deep step (logical k q and
q + 4 are channels 2q and 2q + 1), since a thread's A fragment holds
logical k tg and tg + 4 of a row and reads them as one 8-byte load of
channels 2tg and 2tg + 1. `prep_index` below is the prep kernel's index
arithmetic; the first tests hold it to the weight and to the fragment.

The contraction is K2's (`tests/test_torch_dcn_tf32.py`): each operand
split into big = rna(a) and small = rna(a - big) (cvt.rna.tf32.f32), each
32-deep K tile summed into fresh MMA accumulators that round toward zero
(its small cross products first, then its big ones), each tile added into
fp32 sums to nearest. Emulated on a real conv's im2col at the backbone's
deepest contractions, K = 9 x 512 (stage 4's 3x3 conv2 in R50) and K =
2048 (stage 4's 1x1 conv1), it stays within a few times the error of fp32
sums against the fp64 conv; one truncating accumulator carried over all
of K does not.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bevformer_torch.kernels import conv

BK = conv.K_TILE  # csrc/conv_fwd.cu: the K tile summed in fresh accumulators
K_STEP = 8  # the depth of one wgmma m64nNk8 .tf32
CORE = 32  # floats of one 8 x 4 core matrix


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


def prep_index(i: np.ndarray, cin: int, kh: int, kw: int, bn: int):
    """For elements `i` of the prepared weight (conv_weight_prep_kernel's
    arithmetic): (half: 0 big, 1 small; output channel n; input channel c;
    ky; kx)."""
    t = bn * BK
    chunk, within = i // (2 * t), i % (2 * t)
    e = within % t
    kt_count = kh * kw * cin // BK
    nb, kt = chunk // kt_count, chunk % kt_count
    core = e // CORE
    ng, kg = core // 8, core % 8
    r, q = (e % CORE) // 4, e % 4
    n = nb * bn + ng * 8 + r
    k = kt * BK + (kg >> 1) * 8 + 2 * q + (kg & 1)
    tap, c = k // cin, k % cin
    return within // t, n, c, tap // kw, tap % kw


@pytest.mark.parametrize("cout,bn", [(64, 64), (256, 128), (192, 64)])
@pytest.mark.parametrize("cin,k", [(32, 3), (64, 1), (96, 3)])
def test_prepared_weight_is_each_weight_split_once(cin, k, cout, bn):
    """Every weight element appears once as a big half and once as a small
    half, in the tile of its column block and K tile."""
    total = 2 * cout * cin * k * k
    half, n, c, ky, kx = prep_index(np.arange(total), cin, k, k, bn)
    assert n.max() < cout and c.max() < cin and ky.max() < k and kx.max() < k
    flat = ((n * cin + c) * k + ky) * k + kx
    for h in (0, 1):
        assert np.array_equal(np.sort(flat[half == h]), np.arange(total // 2))
    # a tile holds one column block and one tap's 32 channels
    tiles = np.arange(total) // (2 * bn * BK)
    for tile in np.unique(tiles)[:5]:
        sel = tiles == tile
        assert len(np.unique(n[sel] // bn)) == 1 and len(np.unique(ky[sel] * k + kx[sel])) == 1
        assert len(np.unique(c[sel] // BK)) == 1


def test_fragment_and_weight_agree_on_k():
    """Thread tg's fragment values of a row are channels 8ks + 2tg (its
    logical k tg) and 8ks + 2tg + 1 (logical k tg + 4); the weight's core
    matrices 2ks and 2ks + 1 of a K tile hold those channels at element q
    = tg, as wgmma pairs them."""
    cin, bn = 32, 64
    _, n, c, _, _ = prep_index(np.arange(bn * BK), cin, 1, 1, bn)
    e = np.arange(bn * BK)
    core, q = e // CORE, e % 4
    kg = core % 8
    for ks in range(BK // K_STEP):
        for tg in range(4):
            lo = (kg == 2 * ks) & (q == tg)  # logical k tg of step ks
            hi = (kg == 2 * ks + 1) & (q == tg)  # logical k tg + 4
            assert set(c[lo]) == {8 * ks + 2 * tg}
            assert set(c[hi]) == {8 * ks + 2 * tg + 1}


def im2col(x: np.ndarray, k: int, stride: int, pad: int) -> np.ndarray:
    """x [B, H, W, C] -> [B * OH * OW, k * k * C], k = (ky * k + kx) * C + c,
    zeros outside: the kernel's A."""
    b, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    cols = [xp[:, ky:ky + stride * oh:stride, kx:kx + stride * ow:stride, :]
            for ky in range(k) for kx in range(k)]
    return np.concatenate(cols, axis=-1).reshape(b * oh * ow, k * k * c)


def _accumulate(pairs, k0, k1, acc, rounding):
    for kk in range(k0, k1, K_STEP):
        s = slice(kk, kk + K_STEP)
        for a, b in pairs:
            acc = rounding(acc + a[:, s].astype(np.float64) @ b[s].astype(np.float64))
    return acc


def _pairs_3x(a, w):
    a_big, a_small = split(a)
    b_big, b_small = split(w)
    return [(a_small, b_big), (a_big, b_small), (a_big, b_big)]


def contract_kernel(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    """a [M, K] @ w [K, N] as the kernel computes it: per 32-deep K tile its
    small cross products, then its big ones, into fresh truncating
    accumulators; each tile added into fp32 sums to nearest."""
    pairs = _pairs_3x(a, w)
    zeros = np.zeros((a.shape[0], w.shape[1]), np.float32)
    acc = zeros
    for k0 in range(0, a.shape[1], BK):
        part = _accumulate(pairs[:2], k0, k0 + BK, zeros, f32_toward_zero)
        part = _accumulate(pairs[2:], k0, k0 + BK, part, f32_toward_zero)
        acc = (acc + part).astype(np.float32)
    return acc


def contract_one_accumulator(a, w):
    """The same products into one truncating accumulator over all of K
    (what the kernel does not do)."""
    zeros = np.zeros((a.shape[0], w.shape[1]), np.float32)
    return _accumulate(_pairs_3x(a, w), 0, a.shape[1], zeros, f32_toward_zero)


def contract_fp32(a, w):
    """fp32 operands, fp32 sums to nearest in the kernel's order."""
    zeros = np.zeros((a.shape[0], w.shape[1]), np.float32)
    return _accumulate([(a, w)], 0, a.shape[1], zeros, lambda x: x.astype(np.float32))


@pytest.mark.parametrize("cin,k,stride,drift", [(512, 3, 1, 2e-5), (2048, 1, 1, 1e-5)])
def test_tiles_keep_fp32_accuracy_and_one_accumulator_drifts(cin, k, stride, drift):
    """A conv's output against the fp64 conv (through F.conv2d, so the
    im2col's order is checked too), as a share of its largest magnitude:
    the kernel's tiles within 4x fp32 sums' error and 2e-6, one truncating
    accumulator past `drift`."""
    rng = np.random.RandomState(cin)
    b, h, w, cout = 1, 12, 12, 64
    x = np.maximum(rng.randn(b, h, w, cin), 0).astype(np.float32)  # post-ReLU activations
    wt = (rng.randn(cout, cin, k, k) * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)
    ref = F.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2),
                   torch.from_numpy(wt).double(), stride=stride, padding=k // 2)
    ref = ref.permute(0, 2, 3, 1).reshape(-1, cout).numpy()
    a = im2col(x, k, stride, k // 2)
    w2 = wt.transpose(2, 3, 1, 0).reshape(k * k * cin, cout)  # rows k = (ky, kx, c)
    scale = np.abs(ref).max()

    def err(out):
        return float(np.abs(out - ref).max() / scale)

    kernel, one, fp32 = (err(f(a, w2)) for f in (contract_kernel, contract_one_accumulator,
                                                  contract_fp32))
    assert kernel <= 4 * fp32 and kernel <= 2e-6, (kernel, fp32)
    assert one > drift, one
