"""K7, the port's heads-outer msda forward (`ms_deform_attn_ho`), and the
probe modes' plain versions (`msda_probe_plain`), on the CPU.

On a CPU tensor the wrappers run their plain versions; the CUDA kernels are
held against those on the card (`tests/test_torch_kernels.py`). Here:

- the port against the JAX package's K7, `msda_pallas.ms_deform_attn_pallas`
  (interpreted off the TPU), on y-coherent items whose every sample lies in
  its tile's row window (`window_drop_mass` reads 0): 1e-5 max abs;
- on y-incoherent items with locations outside [0, 1], where the TPU kernel
  drops mass, the port against the exact spec `ms_deform_attn_jnp`: 1e-5;
- each probe mode's plain version against a hand computation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_torch.kernels import msda
from bevformer_tpu.kernels import msda_pallas as mp
from bevformer_tpu.kernels.msda import ms_deform_attn_jnp
from tests.torch_port_helpers import t

TOL = 1e-5  # fp32 sums of the same products in another order


def _coherent(rng, b, q, h, shapes, p, jitter_rows=2.0):
    """y grows with the query index, each sample within `jitter_rows` image
    rows of it; x spills past both edges."""
    base = (np.arange(q) + 0.5) / q
    y = np.empty((b, q, h, len(shapes), p), np.float32)
    for lvl, (hh, _) in enumerate(shapes):
        y[:, :, :, lvl] = base[None, :, None, None] + rng.uniform(
            -jitter_rows, jitter_rows, (b, q, h, p)) / hh
    x = rng.uniform(-0.2, 1.2, (b, q, h, len(shapes), p))
    return np.stack([x, y], -1).astype(np.float32)


def _inputs(rng, b, q, h, d, shapes, p):
    k = sum(hh * ww for hh, ww in shapes)
    value = rng.randn(b, k, h, d).astype(np.float32)
    attw = rng.rand(b, q, h, len(shapes), p).astype(np.float32)
    return value, attw


@pytest.mark.parametrize("shapes,q,h,d", [
    (((30, 25),), 96, 2, 32),
    (((30, 25), (15, 13)), 128, 2, 16),
])
def test_ho_matches_jax_pallas_kernel_where_it_drops_nothing(shapes, q, h, d):
    rng = np.random.RandomState(len(shapes))
    b, p = 1, 4
    value, attw = _inputs(rng, b, q, h, d, shapes, p)
    loc = _coherent(rng, b, q, h, shapes, p)
    kw = dict(stride=4, halo=8, cap_tile=64)
    assert mp.window_drop_mass(shapes, jnp.asarray(loc), jnp.asarray(attw), **kw) == [0.0] * len(shapes)
    ref = np.asarray(mp.ms_deform_attn_pallas(jnp.asarray(value), shapes, jnp.asarray(loc),
                                              jnp.asarray(attw), **kw))
    ours = msda.ms_deform_attn_ho(t(value), shapes, t(loc), t(attw))
    assert ours.shape == ref.shape
    assert float(np.abs(ours.numpy() - ref).max()) <= TOL


def test_ho_keeps_the_mass_the_tpu_kernel_drops():
    """Uniform locations (10% of the coordinates outside [0, 1]) in no
    order: the TPU kernel's windows lose mass, the port matches the exact
    spec."""
    rng = np.random.RandomState(5)
    shapes, b, q, h, d, p = ((30, 25), (15, 13)), 1, 128, 2, 32, 4
    value, attw = _inputs(rng, b, q, h, d, shapes, p)
    loc = rng.uniform(-1 / 18, 1 + 1 / 18, (b, q, h, len(shapes), p, 2)).astype(np.float32)
    drops = mp.window_drop_mass(shapes, jnp.asarray(loc), jnp.asarray(attw),
                                stride=4, halo=8, cap_tile=128)
    assert sum(drops) > 0, drops
    ref = np.asarray(ms_deform_attn_jnp(jnp.asarray(value), shapes, jnp.asarray(loc),
                                        jnp.asarray(attw)))
    ours = msda.ms_deform_attn_ho(t(value), shapes, t(loc), t(attw))
    assert float(np.abs(ours.numpy() - ref).max()) <= TOL


def _hand_corners(loc, shapes):
    """Per sample (b, q, h, l, p), the in-bounds corners as (pixel index in
    the level-concatenated map, bilinear weight), by explicit loops."""
    out = {}
    starts = np.cumsum([0] + [hh * ww for hh, ww in shapes])
    for idx in np.ndindex(loc.shape[:-1]):
        lvl = idx[3]
        hh, ww = shapes[lvl]
        x = np.float32(loc[idx][0]) * np.float32(ww) - np.float32(0.5)
        y = np.float32(loc[idx][1]) * np.float32(hh) - np.float32(0.5)
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        tx, ty = x - x0, y - y0
        corners = []
        for cy, cx, wgt in ((y0, x0, (1 - tx) * (1 - ty)), (y0, x0 + 1, tx * (1 - ty)),
                            (y0 + 1, x0, (1 - tx) * ty), (y0 + 1, x0 + 1, tx * ty)):
            if 0 <= cx < ww and 0 <= cy < hh:
                corners.append((starts[lvl] + cy * ww + cx, wgt))
        out[idx] = corners
    return out


SMALL = (((4, 5), (2, 3)), 2, 3, 2, 32, 2)  # shapes, b, q, h, d, p


def _small(seed, lo=-0.3, hi=1.3):
    shapes, b, q, h, d, p = SMALL
    rng = np.random.RandomState(seed)
    value, attw = _inputs(rng, b, q, h, d, shapes, p)
    loc = rng.uniform(lo, hi, (b, q, h, len(shapes), p, 2)).astype(np.float32)
    return shapes, value, loc, attw


@pytest.mark.parametrize("mode", ["gather", "weights", "noop"])
def test_probe_mode_plain_matches_hand_computation(mode):
    shapes, value, loc, attw = _small(11)
    b, q, h, l, p = attw.shape
    d = value.shape[3]
    want = np.zeros((b, q, h, d), np.float64)
    corners = _hand_corners(loc, shapes)
    for (bi, qi, hi, li, pi), cs in corners.items():
        a = attw[bi, qi, hi, li, pi]
        if mode == "noop":
            want[bi, qi, hi] += a
        elif mode == "weights":
            want[bi, qi, hi] += sum(w for _, w in cs) * a
        else:
            want[bi, qi, hi] += sum(value[bi, k, hi] for k, _ in cs)
    assert any(len(cs) < 4 for cs in corners.values())  # some corners fall off the map
    got = msda.msda_probe_plain(mode, t(value), shapes, t(loc), t(attw))
    assert got.shape == (b, q, h * d)
    np.testing.assert_allclose(got.numpy(), want.reshape(b, q, h * d), rtol=0, atol=TOL)


def test_gather_is_full_with_unit_weights_where_all_corners_are_inside():
    """Samples midway between four pixel centres, all inside: every bilinear
    weight is 1/4, so with attw = 1 `full` is a quarter of `gather`."""
    shapes, value, _, attw = _small(12)
    rng = np.random.RandomState(13)
    loc = np.empty(attw.shape + (2,), np.float32)
    for lvl, (hh, ww) in enumerate(shapes):
        # pixel x0 + 0.5 <=> loc = (x0 + 1) / w, with x0 in [0, w - 2]
        loc[:, :, :, lvl, :, 0] = (rng.randint(0, ww - 1, attw.shape[:3] + (attw.shape[4],)) + 1) / ww
        loc[:, :, :, lvl, :, 1] = (rng.randint(0, hh - 1, attw.shape[:3] + (attw.shape[4],)) + 1) / hh
    ones = np.ones_like(attw)
    gather = msda.msda_probe_plain("gather", t(value), shapes, t(loc), t(attw))
    full = msda.msda_probe_plain("full", t(value), shapes, t(loc), t(ones))
    np.testing.assert_allclose(gather.numpy(), 4 * full.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("kernel,mode", [("ho", m) for m in msda.PROBE_MODES]
                         + [("hi", m) for m in msda.PROBE_MODES[1:]])
def test_probe_wrapper_takes_the_plain_version_on_the_cpu(kernel, mode):
    shapes, value, loc, attw = _small(14)
    args = (t(value), shapes, t(loc), t(attw))
    before = msda.msda_probe.launches
    got = msda.msda_probe(kernel, mode, *args)
    assert msda.msda_probe.launches == before  # no kernel launched
    assert torch.equal(got, msda.msda_probe_plain(mode, *args))


def test_probe_wrapper_refuses_what_has_no_kernel():
    shapes, value, loc, attw = _small(15)
    args = (t(value), shapes, t(loc), t(attw))
    with pytest.raises(ValueError):
        msda.msda_probe("hi", "full", *args)  # K1's full is ms_deform_attn
    with pytest.raises(ValueError):
        msda.msda_probe("ho", "scatter", *args)
