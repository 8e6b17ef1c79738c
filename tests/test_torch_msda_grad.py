"""Gradients of the port's msda (`ms_deform_attn`, plain version under
autograd on the CPU, and `ms_deform_attn_backward_plain`) against
`jax.grad` of the JAX package's exact op `ms_deform_attn_jnp`, for the
value, the sampling locations and the attention weights.

The layouts are those of the three call sites (TSA, SCA, decoder) at small
sizes, with locations spilling out of [0, 1] on every side, so that many
corners fall off the maps. Locations avoid pixel edges by 1e-3 px (the
gradient with respect to a location jumps there), except in the test of
the edges themselves, where both sides take the same one-sided slope (that
of the cell whose corner the position is). Tolerance: 1e-5 of each
gradient's scale (the same corners in fp32, sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.kernels.msda import ms_deform_attn_jnp
from bevformer_torch.kernels import msda
from tests.test_torch_msda import CASES, _inputs
from tests.torch_port_helpers import assert_close, edge_locations, t

TOL = 1e-5


def _off_edges(loc, shapes, margin=1e-3):
    """Move every pixel position at least `margin` px away from an integer
    edge of the bilinear cell (loc * size - 0.5 not within margin of an
    integer), level by level."""
    loc = loc.copy()
    for lvl, (hh, ww) in enumerate(shapes):
        for axis, size in ((0, ww), (1, hh)):
            px = loc[:, :, :, lvl, :, axis].astype(np.float64) * size - 0.5
            frac = px - np.floor(px)
            px = np.where(frac < margin, px + margin, np.where(frac > 1 - margin, px - margin, px))
            loc[:, :, :, lvl, :, axis] = ((px + 0.5) / size).astype(np.float32)
    return loc


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", CASES, ids=[c[0] for c in CASES])
def test_msda_grads_match_jax(name, b, q, h, d, shapes, p):
    value, loc, attw = _inputs(b, q, h, d, shapes, p, seed=len(name) + 11)
    loc = _off_edges(loc, shapes)
    g = np.random.RandomState(5).randn(b, q, h * d).astype(np.float32)

    def loss(v, lc, aw):
        return jnp.sum(ms_deform_attn_jnp(v, shapes, lc, aw) * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attw)
    )
    leaves = [t(a).requires_grad_() for a in (value, loc, attw)]
    (msda.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]) * t(g)).sum().backward()
    plain = msda.ms_deform_attn_backward(t(value), shapes, t(loc), t(attw), t(g))
    for what, leaf, direct, r in zip(("dvalue", "dloc", "dattw"), leaves, plain, ref):
        assert_close(leaf.grad, np.asarray(r), TOL, f"{name} {what} (autograd)")
        assert_close(direct, np.asarray(r), TOL, f"{name} {what} (backward wrapper)")


EDGE_SHAPES = ((8, 16), (4, 8))  # powers of two: exact locations in fp32


def test_msda_grads_match_jax_at_exact_pixel_edges():
    """The plain backward against `jax.grad` where every pixel position lies
    exactly on a cell edge (x or y = -1, 0, integers, size - 1, and
    positions off the map), which the test above avoids. At x == -1 with y
    inside, the sample is 0 but its slope toward x is not: both give a
    nonzero dLoc.x there, and the backward kernel's bounds test (-1 <= x)
    keeps it."""
    rng = np.random.RandomState(9)
    b, q, h, d, p = 2, 24, 2, 32, 4
    value, _, attw = _inputs(b, q, h, d, EDGE_SHAPES, p, seed=9)
    loc = edge_locations(rng, b, q, h, EDGE_SHAPES, p)
    g = rng.randn(b, q, h * d).astype(np.float32)

    def loss(v, lc, aw):
        return jnp.sum(ms_deform_attn_jnp(v, EDGE_SHAPES, lc, aw) * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attw)
    )
    plain = msda.ms_deform_attn_backward_plain(t(value), EDGE_SHAPES, t(loc), t(attw), t(g))
    for what, ours, r in zip(("dvalue", "dloc", "dattw"), plain, ref):
        assert_close(ours, np.asarray(r), TOL, what)
    hh, ww = EDGE_SHAPES[0]
    x = loc[:, :, :, 0, :, 0] * ww - 0.5
    y = loc[:, :, :, 0, :, 1] * hh - 0.5
    at_left_edge = (x == -1) & (y >= 0) & (y <= hh - 1)
    assert at_left_edge.sum() >= 10
    for dloc in (np.asarray(ref[1]), plain[1].numpy()):
        assert (dloc[:, :, :, 0, :, 0][at_left_edge] != 0).all()


def test_backward_wrapper_takes_plain_version_for_cpu_tensors():
    value, loc, attw = (t(a) for a in _inputs(1, 7, 2, 32, ((4, 5),), 2, seed=0))
    g = torch.randn(1, 7, 64)
    before = msda.ms_deform_attn_backward.launches
    ours = msda.ms_deform_attn_backward(value, ((4, 5),), loc, attw, g)
    ref = msda.ms_deform_attn_backward_plain(value, ((4, 5),), loc, attw, g)
    assert msda.ms_deform_attn_backward.launches == before
    for a, r in zip(ours, ref):
        assert torch.equal(a, r)
