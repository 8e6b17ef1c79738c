"""The port's config and weight bridge against the JAX package, on the CPU.

* The port's `bevformer_base` preset holds the JAX preset's values.
* `state_dict_from_jax` equals `export_reference_state_dict` key for key and
  value for value (depth 50, so the scanned `layer{i}_rest` blocks and the
  scanned encoder layers are unstacked), and that dict loads into the
  port's model with nothing missing or unexpected.
* `init_state_dict` covers every key of the port's model.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.configs import BEVFormerConfig as JaxConfig
from bevformer_tpu.configs import DataConfig as JaxData
from bevformer_tpu.configs import get_config as jax_get_config
from bevformer_tpu.models import BEVFormer as JaxBEVFormer
from bevformer_tpu.runtime.checkpoint import export_reference_state_dict
from bevformer_torch.configs import BEVFormerConfig, DataConfig, OptimConfig, get_config
from bevformer_torch.models import BEVFormer
from bevformer_torch.runtime.checkpoint import (
    build_model,
    init_state_dict,
    state_dict_from_jax,
)
from tests.torch_port_helpers import port_config


@pytest.mark.parametrize("cls", [BEVFormerConfig, DataConfig, OptimConfig])
def test_base_preset_holds_the_jax_values(cls):
    ours, ref = get_config("bevformer_base"), jax_get_config("bevformer_base")
    if cls is DataConfig:
        ours, ref = ours.data, ref.data
    elif cls is OptimConfig:
        ours, ref = ours.optim, ref.optim
    for f in dataclasses.fields(cls):
        if f.name not in ("data", "optim"):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    if cls is DataConfig:
        assert ours.img_size == ref.img_size == (928, 1600)
    elif cls is BEVFormerConfig:
        assert ours.grid_length == ref.grid_length
        assert port_config(ref) == ours  # and the hard-coded settings agree


def _jax_cfg(depth):
    return JaxConfig(
        name="bridge", backbone_depth=depth, backbone_dcn_stages=(2, 3),
        bev_h=6, bev_w=8, encoder_layers=3, decoder_layers=2, num_query=20,
        sca_capacity_ratio=0.25, fused_msda="off", fused_dcn="off",
        use_grid_mask=False, data=JaxData(raw_size=(64, 96)),
    )


def test_state_dict_from_jax_equals_the_jax_exporter():
    jcfg = _jax_cfg(50)
    model = JaxBEVFormer(cfg=jcfg)
    h, w = jcfg.data.img_size
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 6, h, w, 3)), jnp.zeros((1, 18)), jnp.zeros((1, 6, 4, 4)),
        jnp.zeros((1, 48, 256)), jnp.zeros((1,), bool),
    )
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes
    )
    ref = export_reference_state_dict(params, jcfg)
    ours = state_dict_from_jax(jax.tree.map(np.asarray, params), jcfg)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)

    port = BEVFormer(port_config(jcfg))
    missing, unexpected = port.load_state_dict(
        {k: torch.from_numpy(v) for k, v in ours.items()}, strict=False
    )
    assert not missing and not unexpected, (missing[:5], unexpected[:5])


def test_init_state_dict_covers_the_model():
    cfg = port_config(_jax_cfg(10))
    sd = init_state_dict(cfg, seed=1)
    ref = BEVFormer(cfg).state_dict()
    assert sorted(sd) == sorted(ref)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k
        assert np.isfinite(v).all(), k
    # the offset layers are nonzero, unlike the JAX package's init
    assert np.abs(sd["img_backbone.layer3.0.conv2.conv_offset.weight"]).max() > 0
    assert np.abs(
        sd["pts_bbox_head.transformer.encoder.layers.0.attentions.0.sampling_offsets.weight"]
    ).max() > 0
    again = init_state_dict(cfg, seed=1)
    assert all(np.array_equal(sd[k], again[k]) for k in sd)
    model = build_model(cfg, sd, "cpu")
    assert torch.equal(model.state_dict()["pts_bbox_head.bev_embedding.weight"],
                       torch.from_numpy(sd["pts_bbox_head.bev_embedding.weight"]))
