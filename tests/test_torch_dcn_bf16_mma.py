"""The arithmetic of bf16 K2 (`csrc/dcn_conv_fwd.cu::dcn_conv_fwd_bf16`) on
the CPU: its contraction emulated in numpy.

The kernel contracts the bf16 column (the plain version's, bitwise) with
the weight rounded once to bf16, by wgmma m64n256k16: each 16-deep step's
products of two bf16 values are exact in fp32, and the emulation takes
their sum exactly in float64; the tensor cores add it into the fp32
accumulator rounding toward zero (`tests/test_torch_dcn_tf32.py`). The
kernel keeps one accumulator over the whole K = 9C, as no fresh
accumulator per K tile fits beside the 128 a thread holds for its 64 x 256
outputs; the output is rounded once to bf16.

fp32 K2 sums each 32-deep K tile into fresh accumulators because one
accumulator over K = 9 * 512 drifted 4e-5 of the output's scale against
its 1e-4 tolerance. bf16 K2 is held to one bf16 ulp at the output's scale
(2^-8 to 2^-7 of it), and its 16-deep steps make K / 16 truncated adds
(288 at K = 4608, where the fp32 path's 3xTF32 made 1728): here one
accumulator drifts 3.0e-6 (K = 2304) and 7.8e-6 (K = 4608) of scale from
the float64 product of the same bf16 operands, a slope of -2.8e-6 and
-5.8e-6 on the output, 0.0005 and 0.0011 bf16 ulps; the earlier kernel's
per-32 order (fresh accumulators per tile, added to nearest) drifts 2.7e-7
and 4.7e-7, slopes -3.8e-8 and -3.7e-8. Both round to within one bf16 ulp of JAX's
bf16 exact DCN, as the float64 product of the bf16 operands does: the
operands' rounding to bf16, not the sums, sets that error.

bf16 K6 (`csrc/dcn_col2im.cu::dcn_col2im_gw`) makes the DCN backward's
column gradient g W^T with the same wgmma on the bf16 output gradient and
the bf16 weight, one truncating accumulator over K = Cout (256 and 512 on
bevformer_base's stages), and scatters it through the sampling as
`dcn_col2im_plain` does: that composition is held here to JAX's bf16
gradient of its exact DCN.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.models.resnet import ModulatedDeformConv as JaxDCN
from bevformer_torch.kernels import dcn
from bevformer_torch.kernels.dcn import dcn_col2im_plain
from tests.test_torch_dcn import _port_dcn
from tests.test_torch_dcn_tf32 import f32_toward_zero
from tests.torch_port_helpers import assert_close, bf16_ulps, t

K_STEP = 16  # the depth of one bf16 wgmma


def bf16(a: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 (nearest even), kept in fp32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _step(acc, col, w, k):
    s = slice(k, k + K_STEP)
    return f32_toward_zero(acc + col[:, s].astype(np.float64) @ w[s].astype(np.float64))


def contract_kernel(col: np.ndarray, w: np.ndarray) -> np.ndarray:
    """col [M, K] @ w [K, N], bf16 values, as bf16 K2 sums them: one
    truncating accumulator over all of K (before the output's rounding)."""
    acc = np.zeros((col.shape[0], w.shape[1]), np.float32)
    for k in range(0, col.shape[1], K_STEP):
        acc = _step(acc, col, w, k)
    return acc


@pytest.mark.parametrize("cin", [256, 512])
def test_one_accumulator_of_the_plain_bf16_column_matches_jax_bf16(cin):
    """At K = 2304 and 4608 (bevformer_base's stages 3 and 4), on a few
    pixels and a narrow Cout: the emulated kernel on the plain bf16 column,
    rounded once, within one bf16 ulp of JAX's bf16 exact DCN at the
    output's scale; before that rounding, within 0.01 ulps of the float64
    product of the same bf16 operands."""
    rng = np.random.RandomState(cin)
    b, h, w, cout = 1, 5, 6, 16
    xb = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32)).bfloat16()
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    jmod = JaxDCN(cout, impl="off", dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jax.jit(jmod.init)(jax.random.PRNGKey(0), jx))
    params = {"params": {
        "kernel": params["params"]["kernel"],
        "conv_offset": {  # offsets of a few pixels, some outside the image
            "kernel": (rng.randn(3, 3, cin, 27) / np.sqrt(9 * cin)).astype(np.float32),
            "bias": rng.randn(27).astype(np.float32),
        },
    }}
    ref = np.asarray(jax.block_until_ready(jax.jit(jmod.apply)(params, jx)).astype(jnp.float32))

    mod = _port_dcn(params["params"], cin, cout, 1)
    with torch.no_grad():
        om = mod.conv_offset(xb.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        off_y = om[..., 0:18:2].contiguous()
        off_x = om[..., 1:18:2].contiguous()
        mask = om[..., 18:].sigmoid().contiguous()
        col = dcn.dcn_im2col_plain(xb, off_y, off_x, mask).float().numpy()
        weight = bf16(mod.weight.permute(2, 3, 1, 0).reshape(9 * cin, cout).numpy())
    assert (off_y.abs() > 1).float().mean() > 0.3, "too few |dy| > 1"
    out = contract_kernel(col, weight)
    err = bf16_ulps(bf16(out).reshape(ref.shape), ref)
    assert err <= 1.0, f"K = {9 * cin}: {err:.2f} bf16 ulps from JAX"
    exact = col.astype(np.float64) @ weight.astype(np.float64)
    assert bf16_ulps(out, exact) <= 0.01, bf16_ulps(out, exact)


@pytest.mark.parametrize("k", [9 * 256, 9 * 512])
def test_one_accumulator_drifts_within_a_hundredth_of_an_ulp(k):
    """A column of N(0, 1) * U(0, 1) values and N(0, 1/K) weights, both
    bf16, against their float64 product: one truncating accumulator over K
    drifts less than 1e-5 of scale (0.01 bf16 ulps; the module's docstring
    gives the figures)."""
    rng = np.random.RandomState(0)
    col = bf16(rng.randn(256, k) * rng.rand(256, k))
    w = bf16(rng.randn(k, 128) / np.sqrt(k))
    ref = col.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(ref).max()
    one = contract_kernel(col, w)
    one_err = float(np.abs(one - ref).max() / scale)
    assert one_err <= 1e-5 and bf16_ulps(one, ref) <= 0.01, (one_err, bf16_ulps(one, ref))


@pytest.mark.parametrize("cout", [256, 512])
def test_col2im_gw_sums_through_the_plain_scatter_match_jax_bf16_gradient(cout):
    """bf16 K6's arithmetic: its column gradient, the bf16 g times the bf16
    weight summed as the kernel sums them (`contract_kernel` over K = Cout),
    through `dcn_col2im_plain`, against `jax.vjp` of JAX's bf16 exact DCN
    (`ModulatedDeformConv(impl="off", dtype=bfloat16)`: its sampling of the
    bf16 x in fp32, the fp32 einsum, the bf16 output) at the same bf16 g,
    on a weight of bf16 values (the port rounds its weight once to bf16) and
    offsets N(0, 3) px: dx (bf16 on both sides) within one bf16 ulp at its
    scale, d offsets and dmask within 1e-3 of theirs (BF16_AUX_TOL of
    chip_smoke.py: fp32 sums in another order, and the truncating
    accumulator's drift of ~1e-6 of scale)."""
    rng = np.random.RandomState(cout + 1)
    b, h, w, c = 2, 5, 6, 32
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).bfloat16()
    off_y, off_x = ((rng.randn(b, h, w, 9) * 3).astype(np.float32) for _ in "yx")
    mask = rng.rand(b, h, w, 9).astype(np.float32)
    weight = bf16(rng.randn(9 * c, cout) / np.sqrt(9 * c))
    g = bf16(rng.randn(b, h, w, cout))
    jmod = JaxDCN(cout, impl="off", dtype=jnp.bfloat16)

    def jax_dcn(xx, oy, ox, mk):
        sampled = jmod._sample_gather(xx, oy, ox, mk, h, w).reshape(b, h, w, 9 * c)
        return jnp.einsum("bhwi,io->bhwo", sampled, jnp.asarray(weight)).astype(jnp.bfloat16)

    vjp = jax.jit(lambda *a: jax.vjp(jax_dcn, *a)[1](jnp.asarray(g).astype(jnp.bfloat16)))
    ref = jax.block_until_ready(vjp(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                    off_y, off_x, mask))
    dcols = contract_kernel(g.reshape(-1, cout), np.ascontiguousarray(weight.T))
    ours = dcn_col2im_plain(x, t(off_y), t(off_x), t(mask), t(dcols))
    assert ours[0].dtype == torch.bfloat16 and ref[0].dtype == jnp.bfloat16
    err = bf16_ulps(ours[0], np.asarray(ref[0].astype(jnp.float32)))
    assert err <= 1.0, f"Cout {cout}: dx {err:.2f} bf16 ulps from JAX"
    for name, a, r in zip(("doff_y", "doff_x", "dmask"), ours[1:], ref[1:]):
        assert_close(a, np.asarray(r), 1e-3, f"Cout {cout} {name}")
