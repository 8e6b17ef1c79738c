"""Shared pieces of the `test_torch_*` files, which hold the PyTorch port
(`bevformer_torch`) against the JAX package on the same numpy inputs.

Importing this module limits torch to one thread: the fast tier runs
several pytest workers side by side.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def assert_close(ours, ref, tol, name=""):
    """max |ours - ref| <= tol * max(|ref|, 1e-6): an error relative to the
    tensor's scale."""
    a = ours.detach().cpu().numpy() if hasattr(ours, "detach") else np.asarray(ours)
    b = ref.detach().cpu().numpy() if hasattr(ref, "detach") else np.asarray(ref)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-6)
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, f"{name}: max abs err {err:.3e} > {tol:.0e} x {scale:.3e}"


def edge_locations(rng, b, q, h, shapes, p) -> np.ndarray:
    """msda sampling locations [b, q, h, L, p, 2], fp32, whose pixel
    positions (loc * size - 0.5) lie exactly on the edges of the bilinear
    cells: -1, 0, integers inside the map, size - 1, and, around them,
    half-pixels and positions off the map (-1.5 and size). Each map size
    must be a power of two, so that every location and its pixel position
    are exact in fp32."""
    loc = np.empty((b, q, h, len(shapes), p, 2), np.float32)
    for lvl, (hh, ww) in enumerate(shapes):
        for axis, size in ((0, ww), (1, hh)):
            assert size & (size - 1) == 0, size
            px = np.array([-1.5, -1.0, -0.5, 0.0, 1.0, 2.0, size / 2, size - 1.5,
                           size - 1.0, size - 0.5, size, 0.25])
            loc[:, :, :, lvl, :, axis] = (rng.choice(px, (b, q, h, p)) + 0.5) / size
    return loc


def edge_offsets(rng, b, oh, ow, size):
    """Offsets [b, oh, ow, 9] from {-size, -1.5, -1, -0.5, 0, 0.5, 1, size}
    and a few quarter pixels: the sample positions oy*s - 1 + ky + offset
    land exactly on -1, integers (H - 1 among them), half and quarter pixels,
    and off the map; every value is exact in fp32."""
    vals = np.array([-size, -1.5, -1.0, -0.5, 0.0, 0.5, 1.0, size, -0.25, 0.25, 0.75],
                    np.float32)
    return rng.choice(vals, (b, oh, ow, 9))


def to_numpy_tree(tree):
    """Flax params (FrozenDict or dict, jax leaves) -> nested dicts of numpy."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def perturb(tree, rng, names=("sampling_offsets", "attention_weights", "conv_offset"),
            std=0.05):
    """Add seeded noise to the kernels (and biases) of the layers the JAX
    package zero-initialises, so that sampling leaves the grid. Leaves are
    numpy; the tree is changed in place and returned."""
    def walk(node, hit):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, hit or k in names)
            elif hit:
                node[k] = (v + rng.standard_normal(v.shape) * std).astype(v.dtype)
    walk(tree, False)
    return tree


def dense_state_dict(tree, prefix="") -> dict:
    """Flax params of Dense/LayerNorm-only modules -> torch state dict with
    the same dotted names (kernel [in, out] -> weight [out, in])."""
    sd = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            sd.update(dense_state_dict(v, key + "."))
        elif k == "kernel":
            sd[f"{prefix}weight"] = t(np.transpose(v))
        elif k == "scale":
            sd[f"{prefix}weight"] = t(v)
        else:
            sd[key] = t(v)
    return sd


# JAX config fields whose v1 value the port hard-codes
PORT_FIXED = dict(rotate_prev_bev=True, use_shift=True, use_can_bus=True)


def port_config(jcfg, **kw):
    """The port's config with the values of a JAX config, which must hold
    the values the port hard-codes."""
    from bevformer_torch.configs import BEVFormerConfig, DataConfig, OptimConfig

    fixed = {k: getattr(jcfg, k) for k in PORT_FIXED}
    assert fixed == PORT_FIXED, fixed

    def fields(cls, src):
        return {f.name: getattr(src, f.name) for f in dataclasses.fields(cls)}

    top = fields(BEVFormerConfig, jcfg)
    top.update(data=DataConfig(**fields(DataConfig, jcfg.data)),
               optim=OptimConfig(**fields(OptimConfig, jcfg.optim)), **kw)
    return BEVFormerConfig(**top)
