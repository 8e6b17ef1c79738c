"""Port's attention modules against the JAX package's exact paths
(`fused_msda="off"`), on the CPU: TSA, SCA dense and with capacity routing
(one camera over capacity), the decoder's deformable cross-attention and its
self-attention.

The zero-initialised offset and weight projections get seeded noise, so
sampling leaves the grid. Tolerance: 1e-5 of each output's scale (fp32,
sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.models import attention as jatt
from bevformer_tpu.models.layers import MultiheadAttention as JaxMHA
from bevformer_torch.models import attention as att
from bevformer_torch.models.layers import MultiheadAttention
from tests.torch_port_helpers import (
    assert_close,
    dense_state_dict,
    perturb,
    t,
    to_numpy_tree,
)

E, H = 64, 8
TOL = 1e-5


def _init(mod, rng, *args):
    params = to_numpy_tree(mod.init(jax.random.PRNGKey(0), *args)["params"])
    return perturb(params, rng)


def test_temporal_self_attention_matches_jax():
    rng = np.random.RandomState(0)
    bs, bev_h, bev_w = 1, 10, 12
    q = bev_h * bev_w
    query = rng.randn(bs, q, E).astype(np.float32)
    value_queue = rng.randn(bs, 2, q, E).astype(np.float32)
    pos = rng.randn(bs, q, E).astype(np.float32)
    ref = rng.uniform(-0.05, 1.05, (bs, 2, q, 1, 2)).astype(np.float32)
    args = [jnp.asarray(a) for a in (query, value_queue, pos, ref)]
    jmod = jatt.TemporalSelfAttention(embed_dims=E, num_heads=H, fused_msda="off")
    params = _init(jmod, rng, *args, bev_h, bev_w)
    expect = jmod.apply({"params": params}, *args, bev_h, bev_w)

    mod = att.TemporalSelfAttention(E, H)
    mod.load_state_dict(dense_state_dict(params))
    with torch.no_grad():
        out = mod(t(query), t(value_queue), t(pos), t(ref), bev_h, bev_w)
    assert_close(out, np.asarray(expect), TOL, "tsa")


SHAPES = ((12, 20), (6, 10), (3, 5), (2, 3))


def _sca_inputs(seed, bev=16, cams=6, nz=4):
    rng = np.random.RandomState(seed)
    q = bev * bev
    k = sum(h * w for h, w in SHAPES)
    query = rng.randn(1, q, E).astype(np.float32)
    value = rng.randn(1, cams, k, E).astype(np.float32)
    ref_cam = rng.uniform(-0.1, 1.1, (1, cams, q, nz, 2)).astype(np.float32)
    # camera 0 sees ~87% of the queries: more than the capacity of 128
    p_anchor = np.array([0.4] + [0.05] * (cams - 1))[None, :, None, None]
    bev_mask = rng.rand(1, cams, q, nz) < p_anchor
    return rng, query, value, ref_cam, bev_mask


@pytest.mark.parametrize("capacity", [0.0, 0.25])
def test_spatial_cross_attention_matches_jax(capacity):
    rng, query, value, ref_cam, bev_mask = _sca_inputs(1)
    if capacity:
        assert bev_mask.any(-1).sum(-1).max() > 128  # one camera over capacity
    jmod = jatt.SpatialCrossAttention(
        embed_dims=E, num_heads=H, num_levels=4, num_points=8,
        capacity_ratio=capacity, fused_msda="off",
    )
    args = [jnp.asarray(query), jnp.asarray(value), None,
            jnp.asarray(ref_cam), jnp.asarray(bev_mask)]
    params = _init(jmod, rng, *args, SHAPES)
    expect = jmod.apply({"params": params}, *args, SHAPES)

    mod = att.SpatialCrossAttention(E, 6, H, 4, 8)
    mod.load_state_dict(dense_state_dict(params))
    routing = att.sca_capacity_routing(t(bev_mask), capacity) if capacity else None
    with torch.no_grad():
        out = mod(t(query), t(value), t(ref_cam), t(bev_mask), SHAPES, routing)
    assert_close(out, np.asarray(expect), TOL, f"sca capacity {capacity}")


def test_capacity_routing_equals_jax_selection():
    _, _, _, ref_cam, bev_mask = _sca_inputs(2)
    pre = jatt.sca_capacity_precompute(
        jnp.asarray(ref_cam), jnp.asarray(bev_mask), 0.25, with_sort=False
    )
    ours = att.sca_capacity_routing(t(bev_mask), 0.25)
    for key in ("top_idx", "vis_sel", "inv", "found", "anyz"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(pre[key]), key)


def test_decoder_cross_attention_matches_jax():
    rng = np.random.RandomState(3)
    bs, q, bev_h, bev_w = 1, 30, 10, 12
    query = rng.randn(bs, q, E).astype(np.float32)
    value = rng.randn(bs, bev_h * bev_w, E).astype(np.float32)
    pos = rng.randn(bs, q, E).astype(np.float32)
    ref = rng.uniform(0, 1, (bs, q, 1, 2)).astype(np.float32)
    shapes = ((bev_h, bev_w),)
    jmod = jatt.CustomMSDeformableAttention(embed_dims=E, num_heads=H, fused_msda="off")
    args = [jnp.asarray(a) for a in (query, value, pos, ref)]
    params = _init(jmod, rng, *args, shapes)
    expect = jmod.apply({"params": params}, *args, shapes)

    mod = att.CustomMSDeformableAttention(E, H)
    mod.load_state_dict(dense_state_dict(params))
    with torch.no_grad():
        out = mod(t(query), t(value), t(pos), t(ref), shapes)
    assert_close(out, np.asarray(expect), TOL, "decoder cross-attention")


def test_decoder_self_attention_matches_jax():
    rng = np.random.RandomState(4)
    query = rng.randn(1, 30, E).astype(np.float32)
    pos = rng.randn(1, 30, E).astype(np.float32)
    jmod = JaxMHA(embed_dims=E, num_heads=H)
    params = to_numpy_tree(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(query), query_pos=jnp.asarray(pos))["params"]
    )
    expect = jmod.apply({"params": params}, jnp.asarray(query), query_pos=jnp.asarray(pos))

    mod = MultiheadAttention(E, H)
    names = ("q_proj", "k_proj", "v_proj")
    mod.load_state_dict({
        "attn.in_proj_weight": t(np.concatenate([params[n]["kernel"].T for n in names])),
        "attn.in_proj_bias": t(np.concatenate([params[n]["bias"] for n in names])),
        "attn.out_proj.weight": t(params["out_proj"]["kernel"].T),
        "attn.out_proj.bias": t(params["out_proj"]["bias"]),
    })
    with torch.no_grad():
        out = mod(t(query), t(pos))
    assert_close(out, np.asarray(expect), TOL, "decoder self-attention")
