"""The SCA capacity audit (`bevformer_torch/tools/audit_sca_capacity.py`)
and the dropped-query count (`models.attention.capacity_count`) on the
CPU, against the JAX package: the per-camera visible-query and
visible-pair fractions equal those of JAX's `tools/audit_sca_capacity.py`
(its `audit`, and the same sums over JAX's `point_sampling` mask) on the
synthetic and real nuScenes rigs at base and tiny, to 1e-6; the count of
visible queries past capacity equals a numpy count over JAX's mask, 0 on
the synthetic rig at base's ratio 0.25 and positive at 0.1; and
`tools.test`'s timing line carries it.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.configs import get_config as jax_get_config
from bevformer_tpu.core import geometry as jax_geometry
from bevformer_torch.data.synth import rig_lidar2img
from bevformer_torch.models.attention import capacity_count, sca_capacity_routing
from bevformer_torch.tools import audit_sca_capacity as audit

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6


@pytest.fixture(scope="module")
def jax_audit():
    """The JAX package's `tools/audit_sca_capacity.py` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_audit_sca_capacity", ROOT / "tools" / "audit_sca_capacity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def geometries():
    base, tiny = jax_get_config("bevformer_base"), jax_get_config("bevformer_tiny")
    return {
        "base_synthetic": (base, (928, 1600), None),
        "base_real": (base, (928, 1600), "real"),
        "tiny_synthetic": (tiny, (480, 800), None),
    }


def jax_mask(jax_audit, cfg, img_hw, rigs):
    """[cams, q, nz] of JAX's `point_sampling` on the audit's pillars, as
    JAX's `audit` computes it."""
    h_img, w_img = img_hw
    rigs = jax_audit.real_rigs(1600, h_img) if rigs == "real" else None
    l2i = jnp.asarray(jax_audit.lidar2img_stack(w_img, h_img, rigs)[None], jnp.float32)
    nz, bev_h, bev_w = audit.NUM_Z, cfg.bev_h, cfg.bev_w
    zs = jnp.linspace(0.5, nz - 0.5, nz) / nz
    gx, gy = jnp.meshgrid((jnp.arange(bev_w) + 0.5) / bev_w, (jnp.arange(bev_h) + 0.5) / bev_h)
    q = bev_h * bev_w
    ref = jnp.stack([jnp.broadcast_to(gx.reshape(-1), (nz, q)),
                     jnp.broadcast_to(gy.reshape(-1), (nz, q)),
                     jnp.broadcast_to(zs[:, None], (nz, q))], axis=-1)[None]
    sample = jax.jit(jax_geometry.point_sampling, static_argnums=(1, 3))
    _, mask = sample(ref, tuple(cfg.pc_range), l2i, tuple(img_hw))
    return np.asarray(mask[0])


@pytest.mark.parametrize("name", list(geometries()))
def test_audit_matches_jax(jax_audit, name, capsys):
    cfg, img_hw, rigs = geometries()[name]
    h_img, w_img = img_hw
    port_rigs = audit.real_rigs(1600, h_img) if rigs == "real" else None
    jrigs = jax_audit.real_rigs(1600, h_img) if rigs == "real" else None
    np.testing.assert_allclose(rig_lidar2img(w_img, h_img, port_rigs),
                               jax_audit.lidar2img_stack(w_img, h_img, jrigs), rtol=1e-12,
                               atol=1e-9)
    ours = audit.audit(cfg.bev_h, cfg.bev_w, cfg.pc_range, img_hw, rigs=port_rigs)
    max_q, max_pair = jax_audit.audit(name, cfg.bev_h, cfg.bev_w, cfg.pc_range, img_hw,
                                      rigs=jrigs)
    capsys.readouterr()
    assert ours["max_query_fraction"] == pytest.approx(float(max_q), abs=TOL)
    assert ours["max_pair_fraction"] == pytest.approx(float(max_pair), abs=TOL)
    mask = jax_mask(jax_audit, cfg, img_hw, rigs)
    anyq = mask.any(-1)
    np.testing.assert_allclose(ours["visible_query_fraction"], anyq.mean(1), atol=TOL)
    np.testing.assert_allclose(ours["visible_pair_fraction"], mask.mean((1, 2)), atol=TOL)
    np.testing.assert_allclose(ours["pair_visibility_of_visible"],
                               mask.sum((1, 2)) / np.maximum(anyq.sum(1) * mask.shape[-1], 1),
                               atol=TOL)


def test_the_audit_reads_what_the_jax_tool_read():
    """BENCH_NOTES.md round 3: at most 0.180 of a camera's queries visible on
    the synthetic rig, 0.233 on the real focals (the 110-degree CAM_BACK),
    against base's capacity 0.25."""
    out = audit.cases("cpu")
    assert round(out["base_synthetic"]["max_query_fraction"], 3) == 0.180
    assert round(out["base_real"]["max_query_fraction"], 3) == 0.233
    assert np.argmax(out["base_real"]["visible_query_fraction"]) == 3  # CAM_BACK


@pytest.mark.parametrize("ratio,dropped", [(0.25, False), (0.1, True)])
def test_capacity_count_matches_a_numpy_count(jax_audit, ratio, dropped):
    """The count through the port's routing equals sum over cameras of
    max(visible - cap, 0) over JAX's mask, and its largest visible count."""
    cfg, img_hw, _ = geometries()["base_synthetic"]
    ours = audit.audit(cfg.bev_h, cfg.bev_w, cfg.pc_range, img_hw, capacity_ratio=ratio)
    mask = jax_mask(jax_audit, cfg, img_hw, None)
    q = cfg.bev_h * cfg.bev_w
    cap = min((int(q * ratio) + 127) // 128 * 128, q)
    visible = mask.any(-1).sum(-1)
    assert ours["sca_capacity"] == cap
    assert ours["max_capacity_clipped"] == int(np.maximum(visible - cap, 0).sum())
    assert ours["max_visible"] == int(visible.max())
    assert (ours["max_capacity_clipped"] > 0) == dropped


def test_capacity_count_over_frames_and_outside_the_block():
    """Over several routings the count keeps the largest of each; routings
    outside the block are not counted; dense SCA counts nothing."""
    q = 512
    masks = [torch.zeros((2, 3, q, 4), dtype=torch.bool) for _ in range(3)]
    masks[0][0, 1, :200, 0] = True  # 200 visible, cap 128: 72 dropped
    masks[1][1, 2, :300, 1] = True  # 172 dropped, and 150 more in another camera
    masks[1][0, 0, 50:328, 2] = True
    masks[2][0, 0, :10, 3] = True
    with capacity_count() as count:
        for m in masks:
            sca_capacity_routing(m, 0.25)
        assert sca_capacity_routing(masks[0], 0.0) is None
    sca_capacity_routing(masks[1], 0.01)
    assert count.read() == dict(max_capacity_clipped=172 + 150, max_visible=300,
                                sca_capacity=128, routings=3)
    with capacity_count() as none:
        pass
    assert none.read() == dict(max_capacity_clipped=0, max_visible=None, sca_capacity=None,
                               routings=0)


def test_tools_test_reports_the_count(tmp_path, capsys):
    """`tools.test`'s timing line carries the count over its frames."""
    from bevformer_torch.tools import create_data, test as test_cli

    data = str(tmp_path / "data")
    create_data.main(["synth", "--out-dir", data, "--scenes", "2", "--frames", "2",
                      "--img-w", "160", "--img-h", "96"])
    options = ["backbone_depth=10", "bev_h=16", "bev_w=16", "encoder_layers=1",
               "decoder_layers=1", "data.raw_size=(96,160)"]
    res = test_cli.main(["bevformer_base", "--data-root", data, "--device", "cpu", "--eval",
                         "none", "--out", os.path.join(str(tmp_path), "r.json"),
                         "--cfg-options", *options])
    assert res is None  # --eval none: no metrics
    timing = [json.loads(x) for x in capsys.readouterr().out.splitlines()
              if x.startswith('{"frames"')]
    assert len(timing) == 1
    t = timing[0]
    assert t["frames"] == 2 and t["routings"] == 2 and t["sca_capacity"] == 128
    assert t["max_capacity_clipped"] == 0 and 0 < t["max_visible"] <= 128
