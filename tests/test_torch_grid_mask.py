"""The port's GridMask (`bevformer_torch/models/grid_mask.py`) against the
JAX package's `grid_mask`, on the CPU.

The two frameworks draw different random numbers, so the mask is compared
on JAX's own draws: the test repeats `grid_mask`'s key splits and draws,
hands (d, st_h, st_w, apply) to the port's `grid_mask_keep`, and compares
the masked images exactly (the mask is 0 or 1). Then the module: its draws
follow its generator's seed, and the detector masks only in train mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.models.grid_mask import grid_mask as jax_grid_mask
from bevformer_torch.models.grid_mask import GridMask, grid_mask_keep


def _jax_draws(key, h, prob=0.7):
    """(d, st_h, st_w, apply) exactly as `grid_mask` draws them."""
    k_apply, k_d, k_st_h, k_st_w = jax.random.split(key, 4)
    apply = bool(jax.random.uniform(k_apply, ()) < prob)
    d = int(jax.random.randint(k_d, (), 2, h))
    st_h = int(jax.random.randint(k_st_h, (), 0, 1 << 30)) % d
    st_w = int(jax.random.randint(k_st_w, (), 0, 1 << 30)) % d
    return d, st_h, st_w, apply


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("hw", [(32, 48), (45, 80)])
def test_mask_matches_jax_on_its_draws(seed, hw):
    h, w = hw
    images = np.random.RandomState(seed).rand(2, h, w, 3).astype(np.float32) + 1.0
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax_grid_mask(key, jnp.asarray(images)))
    d, st_h, st_w, apply = _jax_draws(key, h)
    keep = grid_mask_keep(h, w, d, st_h, st_w, apply)
    ours = torch.from_numpy(images) * keep[None, :, :, None]
    np.testing.assert_array_equal(ours.numpy(), ref)
    if apply:
        assert 0.0 < float(keep.mean()) < 1.0


def test_module_draws_follow_its_seed():
    images = torch.ones(2, 40, 64, 3)
    a, b, c = GridMask(seed=3), GridMask(seed=3), GridMask(seed=4)
    outs = [[m(images) for _ in range(4)] for m in (a, b, c)]
    assert all(torch.equal(x, y) for x, y in zip(outs[0], outs[1]))
    assert not all(torch.equal(x, y) for x, y in zip(outs[0], outs[2]))
    # prob 0.7: over many draws most calls mask, some do not
    applied = [GridMask(seed=s)(images).mean() < 1 for s in range(200)]
    assert 0.55 < np.mean(applied) < 0.85


def test_detector_masks_only_in_train_mode():
    from bevformer_torch.configs import DataConfig, get_config
    from bevformer_torch.runtime import build_model, init_state_dict

    cfg = get_config("bevformer_base", backbone_depth=10, bev_h=8, bev_w=8,
                     encoder_layers=1, decoder_layers=1, num_query=20,
                     data=DataConfig(raw_size=(64, 96)))
    model = build_model(cfg, init_state_dict(cfg, seed=0), "cpu")
    seen = []
    model.img_backbone.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    images = torch.ones(1, cfg.data.num_cams, 64, 96, 3)
    model.grid_mask.generator.manual_seed(0)  # this seed's first call masks
    with torch.no_grad():
        model.eval().extract_feat(images)
        model.train().extract_feat(images)
    assert float(seen[0].min()) == 1.0
    assert float(seen[1].min()) == 0.0
