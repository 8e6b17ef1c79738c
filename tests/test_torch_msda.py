"""Port's msda (`bevformer_torch/kernels/msda.py`) against the JAX package's
exact op `ms_deform_attn_jnp`, on the CPU.

Tolerance: 1e-5 of the output's scale. Both sides gather the same corners
in fp32 and sum the same terms, in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bevformer_tpu.kernels.msda import ms_deform_attn_jnp
from bevformer_torch.kernels import msda
from tests.torch_port_helpers import assert_close, t

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
