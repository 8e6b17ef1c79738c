"""Gradients of the port's DCNv2 (`ModulatedDeformConv`, plain version on
the CPU) against `jax.grad` of the JAX package's exact path
(`ModulatedDeformConv(impl="off")`).

The loss is <out, G> for a seeded cotangent G; the gradients are taken
with respect to the input x, the conv weight and the offset conv
(`conv_offset` kernel and bias). Offsets have std ~3 px, so |dy| > 2 is
common (the JAX fused kernel would clip those; the port has no clip) and
many samples fall off the small maps. Tolerance: 1e-4 of each gradient's
scale (fp32 sums taken in another order; the same corners on both sides).
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
