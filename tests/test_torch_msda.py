"""Port's msda (`bevformer_torch/kernels/msda.py`) against the JAX package's
exact op `ms_deform_attn_jnp`, on the CPU.

Tolerance: 1e-5 of the output's scale. Both sides gather the same corners
in fp32 and sum the same terms, in another order. On a bf16 value both read
it exactly in fp32, sum in fp32 and round the output to bf16 once: within
one bf16 ulp at the output's scale.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bevformer_tpu.kernels.msda import ms_deform_attn_jnp
from bevformer_torch.kernels import msda
from tests.torch_port_helpers import assert_close, bf16_ulps, t

# (name, batch, queries, heads, head dim, spatial shapes, points) in the
# layouts of the three call sites, at small sizes
CASES = [
    ("tsa", 2, 96, 8, 32, ((8, 12),), 4),
    ("sca", 6, 40, 8, 32, ((12, 20), (6, 10), (3, 5), (2, 3)), 8),
    ("decoder", 1, 30, 8, 32, ((10, 10),), 4),
    ("narrow_head", 1, 17, 2, 8, ((5, 7), (3, 4)), 3),
]


def _inputs(b, q, h, d, shapes, p, seed):
    rng = np.random.RandomState(seed)
    k = sum(hh * ww for hh, ww in shapes)
    value = rng.randn(b, k, h, d).astype(np.float32)
    # locations spill out of [0, 1] on every side
    loc = rng.uniform(-0.2, 1.2, (b, q, h, len(shapes), p, 2)).astype(np.float32)
    logits = rng.randn(b, q, h, len(shapes) * p).astype(np.float32)
    attw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, attw.reshape(b, q, h, len(shapes), p).astype(np.float32)


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", CASES, ids=[c[0] for c in CASES])
def test_plain_msda_matches_jax(name, b, q, h, d, shapes, p):
    value, loc, attw = _inputs(b, q, h, d, shapes, p, seed=len(name))
    ref = ms_deform_attn_jnp(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attw)
    )
    out = msda.ms_deform_attn_plain(t(value), shapes, t(loc), t(attw))
    assert out.shape == (b, q, h * d)
    assert_close(out, np.asarray(ref), 1e-5, name)


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_plain_msda_on_a_bf16_value_matches_jax(name, b, q, h, d, shapes, p):
    """The function bf16 K1 is held to on the card: the plain version on a
    bf16 value against `ms_deform_attn_jnp` on the same bf16 value."""
    value, loc, attw = _inputs(b, q, h, d, shapes, p, seed=len(name) + 40)
    v16 = t(value).bfloat16()
    ref = ms_deform_attn_jnp(jnp.asarray(v16.float().numpy()).astype(jnp.bfloat16), shapes,
                             jnp.asarray(loc), jnp.asarray(attw))
    assert ref.dtype == jnp.bfloat16
    out = msda.ms_deform_attn_plain(v16, shapes, t(loc), t(attw))
    assert out.dtype == torch.bfloat16 and out.shape == (b, q, h * d)
    assert bf16_ulps(out, np.asarray(ref.astype(jnp.float32))) <= 1, name


def test_wrapper_takes_plain_version_for_cpu_tensors():
    value, loc, attw = _inputs(1, 9, 8, 32, ((6, 7),), 4, seed=3)
    before = msda.ms_deform_attn.launches
    out = msda.ms_deform_attn(t(value), ((6, 7),), t(loc), t(attw))
    ref = msda.ms_deform_attn_plain(t(value), ((6, 7),), t(loc), t(attw))
    assert torch.equal(out, ref)
    assert msda.ms_deform_attn.launches == before  # no kernel launched


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "levels", "head_dim"])
def test_wrapper_checks_reject_what_the_kernel_cannot_take(bad):
    value, loc, attw = (t(x) for x in _inputs(1, 5, 8, 32, ((4, 5),), 2, seed=4))
    shapes = ((4, 5),)
    if bad == "dtype":
        value = value.double()
    elif bad == "contiguity":
        loc = loc.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "levels":
        shapes = ((2, 5), (2, 5))
    else:
        value = value[..., :16].contiguous()
    with pytest.raises((TypeError, ValueError)):
        msda._check(value, shapes, loc, attw)


@pytest.mark.parametrize("shape,want", [
    ((2, 40000, 8, 1 * 4), 128),   # TSA: 4 samples per query
    ((6, 10112, 8, 4 * 8), 16),    # SCA: 32
    ((1, 900, 8, 1 * 4), 16),      # decoder: halved until 2 blocks per SM
    ((1, 5, 8, 4), 8),             # tiny Q: not below 8
    ((2, 1000, 8, 8 * 64), 1),     # a payload of 512 samples per query
    ((2, 1000, 8, 8 * 100), 1),    # more than K1_ITEMS: still one query
], ids=["tsa", "sca", "decoder", "tiny_q", "wide", "wider"])
def test_k1_tile_per_shape(shape, want):
    """K1's queries per block on a 132-SM card (an H100 SXM)."""
    b, q, h, samples = shape
    tile = msda.k1_tile(b, q, h, samples, 132)
    assert tile == want and tile in msda.K1_TILES
    assert tile * samples * 32 <= 227 * 1024  # the payload fits shared memory


@pytest.mark.parametrize("shape,want", [
    ((2, 40000, 8, 1 * 4), 128),    # base TSA: K1's tile
    ((6, 10112, 8, 4 * 8), 32),     # base SCA: K1's 16 doubled to a pass of 32
    ((1, 900, 8, 1 * 4), 32),       # base and tiny_fp16 decoder
    ((2, 2500, 8, 1 * 4), 128),     # tiny_fp16 TSA
    ((6, 2500, 8, 1 * 8), 64),      # tiny_fp16 dense SCA (one level)
    ((1, 5, 8, 4), 32),             # tiny Q
    ((2, 1000, 8, 8 * 100), 1),     # wide: doubled only within 1024 samples a block
    ((2, 1000, 8, 8 * 60), 2),
], ids=["base_tsa", "base_sca", "decoder", "tiny_tsa", "tiny_sca", "tiny_q", "wide", "wide2"])
def test_k1_bf16_tile_per_shape(shape, want):
    """bf16 K1's (and K3/K4's) queries per block on a 132-SM card (an H100
    SXM): bf16 K1 gives each 8-lane group whole queries, so K1's tile is
    doubled to at least the 32 queries a pass of the block's 8 warps covers,
    within K1_BF16_ITEMS samples."""
    b, q, h, samples = shape
    tile = msda.k1_bf16_tile(b, q, h, samples, 132)
    assert tile == want and tile in msda.K1_TILES
    k1 = msda.k1_tile(b, q, h, samples, 132)
    assert tile == k1 or tile * samples <= msda.K1_BF16_ITEMS
    assert tile * samples * 32 + tile * 32 * 4 <= 227 * 1024  # K3/K4's payload fits too
