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


# JAX config fields whose bevformer_base value the port hard-codes
PORT_FIXED = dict(backbone_style="caffe", rotate_prev_bev=True, use_shift=True,
                  use_can_bus=True, video_test_mode=True)


def port_config(jcfg, **kw):
    """The port's config with the values of a JAX config, which must hold
    the values the port hard-codes."""
    from bevformer_torch.configs import BEVFormerConfig, DataConfig

    fixed = {k: getattr(jcfg, k) for k in PORT_FIXED}
    assert fixed == PORT_FIXED and not jcfg.data.to_rgb, (fixed, jcfg.data.to_rgb)
    data = {
        f.name: getattr(jcfg.data, f.name) for f in dataclasses.fields(DataConfig)
    }
    top = {
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(BEVFormerConfig) if f.name != "data"
    }
    top.update(kw)
    return BEVFormerConfig(data=DataConfig(**data), **top)
