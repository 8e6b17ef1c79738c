"""Gradients of the port's DCNv2 (`ModulatedDeformConv`, plain version on
the CPU) against `jax.grad` of the JAX package's exact path
(`ModulatedDeformConv(impl="off")`).

The loss is <out, G> for a seeded cotangent G; the gradients are taken
with respect to the input x, the conv weight and the offset conv
(`conv_offset` kernel and bias). Offsets have std ~3 px, so |dy| > 2 is
common (the JAX fused kernel would clip those; the port has no clip) and
many samples fall off the small maps. Tolerance: 1e-4 of each gradient's
scale (fp32 sums taken in another order; the same corners on both sides).

The edge cases put samples exactly on the bilinear cells' edges: py or px
= -1 (the row-0 corners carry weight 0 and a nonzero slope), 0, integers,
half-pixels, H - 1 and W - 1 (the last row's corners), and fully off the
map; there the sampling backward (`dcn_col2im_plain`) and the plain conv's
backward are held to `jax.vjp` of the JAX exact path's sampling
(`ModulatedDeformConv(impl="off")._sample_gather`) at 1e-5 of scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.models.resnet import ModulatedDeformConv as JaxDCN
from bevformer_torch.kernels import dcn
from tests.test_torch_dcn import _port_dcn
from tests.torch_port_helpers import assert_close, edge_offsets, t

TOL = 1e-4


@pytest.mark.parametrize("stride", [1, 2])
def test_modulated_deform_conv_grads_match_jax(stride):
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
    out_shape = jax.eval_shape(lambda: jmod.apply(params, jnp.asarray(x))).shape
    cot = rng.randn(*out_shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jmod.apply(p, xx) * cot)

    jg_params, jg_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    jg = jax.tree.map(np.asarray, jg_params)["params"]

    mod = _port_dcn(params["params"], cin, cout, stride)
    xt = t(x).permute(0, 3, 1, 2).requires_grad_()
    out = mod(xt)
    with torch.no_grad():
        off = mod.conv_offset(xt)[:, :18].numpy()
    assert (np.abs(off[:, 0::2]) > 2).mean() > 0.3, "too few |dy| > 2"
    (out.permute(0, 2, 3, 1) * t(cot)).sum().backward()

    assert_close(xt.grad.permute(0, 2, 3, 1), np.asarray(jg_x), TOL, "dx")
    wk = np.transpose(jg["kernel"].reshape(3, 3, cin, cout), (3, 2, 0, 1))
    assert_close(mod.weight.grad, wk, TOL, "dweight")
    ok = np.transpose(jg["conv_offset"]["kernel"], (3, 2, 0, 1))
    assert_close(mod.conv_offset.weight.grad, ok, TOL, "d conv_offset kernel")
    assert_close(mod.conv_offset.bias.grad, jg["conv_offset"]["bias"], TOL, "d conv_offset bias")


def test_backward_decomposes_into_im2col_and_col2im():
    """The backward the CUDA path runs (im2col, two products, col2im), in
    plain versions, equals autograd through the plain conv."""
    rng = np.random.RandomState(3)
    b, h, w, c, cout = 2, 7, 9, 32, 40
    x = t(rng.randn(b, h, w, c).astype(np.float32))
    off_y = t((rng.randn(b, h, w, 9) * 3).astype(np.float32))
    off_x = t((rng.randn(b, h, w, 9) * 3).astype(np.float32))
    mask = t(rng.rand(b, h, w, 9).astype(np.float32))
    weight = t((rng.randn(9 * c, cout) / np.sqrt(9 * c)).astype(np.float32))
    g = t(rng.randn(b, h, w, cout).astype(np.float32))
    ref = dcn.dcn_conv_backward_plain(x, off_y, off_x, mask, weight, g)
    cols = dcn.dcn_im2col(x, off_y, off_x, mask)
    assert tuple(cols.shape) == (b * h * w, 9 * c)
    gm = g.reshape(-1, cout)
    dcols = gm @ weight.t()
    ours = (*dcn.dcn_col2im(x, off_y, off_x, mask, dcols), cols.t() @ gm)
    for name, a, r in zip(("dx", "doff_y", "doff_x", "dmask", "dweight"), ours, ref):
        assert_close(a, r, 1e-5, name)


EDGE_TOL = 1e-5


def _edge_inputs(stride):
    """Power-of-two maps (8 x 16), C 32, offsets on the cell edges."""
    rng = np.random.RandomState(40 + stride)
    b, h, w, c, cout = 2, 8, 16, 32, 24
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(b, h, w, c).astype(np.float32)
    off_y = edge_offsets(rng, b, oh, ow, h)
    off_x = edge_offsets(rng, b, oh, ow, w)
    mask = rng.rand(b, oh, ow, 9).astype(np.float32)
    weight = (rng.randn(9 * c, cout) / np.sqrt(9 * c)).astype(np.float32)
    g = rng.randn(b, oh, ow, cout).astype(np.float32)
    return x, off_y, off_x, mask, weight, g


def _jax_column(stride):
    """The JAX exact path's modulated column [B*OH*OW, 9C] as a function of
    (x, off_y, off_x, mask)."""
    mod = JaxDCN(8, stride=stride, impl="off")

    def column(x, off_y, off_x, mask):
        b, oh, ow, _ = off_y.shape
        sampled = mod._sample_gather(x, off_y, off_x, mask, oh, ow)
        return sampled.reshape(b * oh * ow, -1)

    return column


@pytest.mark.parametrize("stride", [1, 2])
def test_col2im_plain_matches_jax_at_exact_pixel_edges(stride):
    x, off_y, off_x, mask, _, _ = _edge_inputs(stride)
    ky = np.repeat(np.arange(3), 3)
    oy = np.arange(off_y.shape[1])[None, :, None, None] * stride
    py = oy - 1 + ky + off_y
    h = x.shape[1]
    for where, hit in (("-1", py == -1), ("H - 1", py == h - 1), ("off the map", py >= h),
                       ("a half pixel", py % 1 == 0.5)):
        assert hit.any(), f"no sample at py = {where}"
    dcols = np.random.RandomState(7).randn(off_y.size // 9, 9 * x.shape[3]).astype(np.float32)
    _, vjp = jax.vjp(_jax_column(stride), *map(jnp.asarray, (x, off_y, off_x, mask)))
    ref = vjp(jnp.asarray(dcols))
    ours = dcn.dcn_col2im_plain(t(x), t(off_y), t(off_x), t(mask), t(dcols), stride)
    for name, a, r in zip(("dx", "doff_y", "doff_x", "dmask"), ours, ref):
        assert_close(a, np.asarray(r), EDGE_TOL, f"stride {stride} {name}")
    # at py == -1 the row-0 corners carry weight 0 but a slope: d off_y is
    # not 0 there wherever the sample's row-0 corners lie on the map
    px = np.arange(off_x.shape[2])[None, None, :, None] * stride - 1 + np.tile(np.arange(3), 3)
    px = px + off_x
    sloped = (py == -1) & (px > -1) & (px < x.shape[2] - 1)
    assert sloped.any() and (ours[1].numpy()[sloped] != 0).all()


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_backward_plain_matches_jax_at_exact_pixel_edges(stride):
    x, off_y, off_x, mask, weight, g = _edge_inputs(stride)
    column = _jax_column(stride)

    def conv(x, off_y, off_x, mask, weight):
        b, oh, ow, _ = off_y.shape
        return (column(x, off_y, off_x, mask) @ weight).reshape(b, oh, ow, -1)

    _, vjp = jax.vjp(conv, *map(jnp.asarray, (x, off_y, off_x, mask, weight)))
    ref = vjp(jnp.asarray(g))
    ours = dcn.dcn_conv_backward_plain(*map(t, (x, off_y, off_x, mask, weight, g)), stride)
    for name, a, r in zip(("dx", "doff_y", "doff_x", "dmask", "dweight"), ours, ref):
        assert_close(a, np.asarray(r), EDGE_TOL, f"stride {stride} {name}")
