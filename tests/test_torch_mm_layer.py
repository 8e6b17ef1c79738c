"""The port's MMBEVFormerLayer (`bevformer_torch/models/mm_layer.py`) and
RelPositionEmbedding (`models/position_embedding.py`) against the JAX
package's, on the CPU, through the weight bridge
(`runtime.checkpoint.mm_layer_state_dict`, `rel_position_state_dict`).

The layer at `test_mm_layer.py`'s sizes (16 queries, 32 channels, 2
cameras) with SCA routing every query (capacity 0, the default), and at a
16 x 16 BEV with capacity 0.25 (a camera over its 128 rows drops
queries), JAX at `fused_msda="off"`: the output, and the gradients of a
seeded projection of it with respect to every input and parameter. The
zero-initialised offset and weight projections get seeded noise, so
sampling leaves the grid. Tolerance: 1e-5 of each output's scale forward,
1e-4 for the gradients (fp32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tpu.models.mm_layer import MMBEVFormerLayer as JaxMMLayer
from bevformer_tpu.models.position_embedding import RelPositionEmbedding as JaxRelPos
from bevformer_torch.models.mm_layer import MMBEVFormerLayer
from bevformer_torch.models.position_embedding import RelPositionEmbedding
from bevformer_torch.runtime.checkpoint import mm_layer_state_dict, rel_position_state_dict
from tests.torch_port_helpers import assert_close, perturb, t, to_numpy_tree

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
E, HEADS, CAMS = 32, 4, 2
SHAPES = ((6, 4),)
LAYER = dict(embed_dims=E, num_heads=HEADS, feedforward_channels=64, num_cams=CAMS,
             num_levels=1, sca_num_points=4, tsa_num_points=2, lidar_num_points=2)


@pytest.mark.parametrize("num_pos_feats,pos_norm,h,w", [(32, True, 6, 5), (32, False, 6, 5),
                                                         (64, True, 1, 7)])
def test_rel_position_embedding_matches_jax(num_pos_feats, pos_norm, h, w):
    jmod = JaxRelPos(num_pos_feats=num_pos_feats, pos_norm=pos_norm)
    expect, variables = jax.jit(
        lambda: jmod.init_with_output(jax.random.PRNGKey(0), h, w))()
    params = to_numpy_tree(variables["params"])
    if pos_norm:
        rng = np.random.RandomState(1)
        params["norm"] = {k: v + 0.1 * rng.randn(*v.shape).astype(np.float32)
                          for k, v in params["norm"].items()}
        expect = jmod.apply({"params": params}, h, w)
    mod = RelPositionEmbedding(num_pos_feats, pos_norm)
    mod.load_state_dict({k: t(v) for k, v in rel_position_state_dict(params).items()})
    with torch.no_grad():
        out = mod(h, w)
    assert tuple(out.shape) == (h * w, num_pos_feats)
    assert_close(out, np.asarray(expect), FWD_TOL, "rel pos")


def _inputs(seed, bev):
    rng = np.random.RandomState(seed)
    q = bev * bev
    k = sum(h * w for h, w in SHAPES)
    arrays = dict(
        query=rng.randn(1, q, E), value=rng.randn(1, CAMS, k, E),
        lidar=rng.randn(1, q, E), bev_pos=rng.randn(1, q, E), vq=rng.randn(1, 2, q, E),
        ref2d=rng.uniform(-0.05, 1.05, (1, 2, q, 1, 2)),
        ref_cam=rng.uniform(-0.1, 1.1, (1, CAMS, q, 4, 2)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    # camera 0 sees most queries: over a capacity of 128 at the 16 x 16 BEV
    p_anchor = np.array([0.5] + [0.1] * (CAMS - 1))[None, :, None, None]
    arrays["bev_mask"] = rng.rand(1, CAMS, q, 4) < p_anchor
    arrays["proj"] = rng.randn(1, q, E).astype(np.float32)
    return rng, arrays


ORDER = ("query", "value", "lidar", "bev_pos", "vq", "ref2d", "ref_cam", "bev_mask")
GRAD_INPUTS = ("query", "value", "lidar", "bev_pos", "vq")


@pytest.fixture(scope="module", params=[(0.0, 4), (0.25, 16)], ids=["capacity0", "capacity0.25"])
def case(request):
    capacity, bev = request.param
    rng, a = _inputs(0, bev)
    if capacity:
        assert a["bev_mask"].any(-1).sum(-1).max() > 128
    jmod = JaxMMLayer(**LAYER, sca_capacity_ratio=capacity, fused_msda="off")
    args = [jnp.asarray(a[k]) for k in ORDER]
    tail = (SHAPES, bev, bev)
    params = to_numpy_tree(jax.jit(lambda *x: jmod.init(jax.random.PRNGKey(0), *x, *tail))(
        *args)["params"])
    params = perturb(params, rng)
    params["cross_model_weights"] = np.asarray(0.3, np.float32)

    def loss(p, *x):
        return (jmod.apply({"params": p}, *x, *args[5:], *tail)
                * jnp.asarray(a["proj"])).sum()

    out = jax.jit(lambda p, *x: jmod.apply({"params": p}, *x, *tail))(params, *args)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(params, *args[:5])
    grads = [to_numpy_tree(g) for g in jax.block_until_ready(grads)]
    return capacity, bev, a, params, np.asarray(out), grads


def _port(case):
    capacity, bev, a, params, *_ = case
    mod = MMBEVFormerLayer(**LAYER, sca_capacity_ratio=capacity).eval()
    mod.load_state_dict({k: t(v) for k, v in mm_layer_state_dict(params).items()})
    xs = {k: t(a[k]).requires_grad_(k in GRAD_INPUTS) for k in ORDER}
    out = mod(*[xs[k] for k in ORDER], SHAPES, bev, bev)
    return mod, xs, out


def test_mm_layer_matches_jax(case):
    capacity, _, _, params, expect, _ = case
    _, _, out = _port(case)
    assert_close(out, expect, FWD_TOL, f"mm layer, capacity {capacity}")


def test_mm_layer_gradients_match_jax(case):
    capacity, _, a, params, _, grads = case
    mod, xs, out = _port(case)
    (out * t(a["proj"])).sum().backward()
    for name, g in zip(GRAD_INPUTS, grads[1:]):
        assert_close(xs[name].grad, g, GRAD_TOL, f"d{name}, capacity {capacity}")
    ours = {k: v.grad for k, v in mod.named_parameters()}
    ref = mm_layer_state_dict(grads[0])  # the bridge maps gradients as it maps weights
    assert sorted(ours) == sorted(ref)
    for k, g in ref.items():
        assert_close(ours[k], g, GRAD_TOL, f"d{k}, capacity {capacity}")


def test_mm_layer_blend_weight_gates_the_lidar_branch(case):
    """At w = 1 the output does not depend on the lidar map (as the JAX
    test checks); at the learned w it does, and every attention runs."""
    capacity, bev, a, params, *_ = case
    mod = MMBEVFormerLayer(**LAYER, sca_capacity_ratio=capacity).eval()
    mod.load_state_dict({k: t(v) for k, v in mm_layer_state_dict(params).items()})
    args = [t(a[k]) for k in ORDER]
    other = args.copy()
    other[2] = t(np.random.RandomState(5).randn(*a["lidar"].shape).astype(np.float32))
    with torch.no_grad():
        assert (mod(*args, SHAPES, bev, bev) - mod(*other, SHAPES, bev, bev)).abs().max() > 1e-3
        mod.cross_model_weights.fill_(1.0)
        assert_close(mod(*args, SHAPES, bev, bev), mod(*other, SHAPES, bev, bev), 1e-6, "w=1")
