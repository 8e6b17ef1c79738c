"""`use_remat` in the port: the backbone's blocks after each stage's first
and the encoder's layers recomputed in backward (`models.layers.remat`,
`torch.utils.checkpoint`), as JAX's `nn.remat` wraps them. On the CPU, at
a small size with R50 (blocks to recompute in every stage): a v1
bevformer_base and a V2 t1 `Trainer` step with dropout and GridMask on
(V2: BatchNorm in train mode) gives the same losses, gradients, parameters,
running statistics and random generators' states with `use_remat=True` as
without it; the recomputed blocks and layers run twice a step and the
others once; each BatchNorm counts one batch; `--cfg-options
use_remat=True` is accepted.
"""

import pytest
import torch

from bevformer_torch.configs import DataConfig, apply_overrides, get_config
from bevformer_torch.data import train_batch
from bevformer_torch.data.synth import train_batch_v2
from bevformer_torch.models.encoder import BEVFormerLayer
from bevformer_torch.models.resnet import Bottleneck
from bevformer_torch.runtime import Trainer, build_model, init_state_dict
from tests.torch_port_helpers import assert_close  # noqa: F401  (one torch thread)

SMALL = dict(backbone_depth=50, bev_h=8, bev_w=8, encoder_layers=2, decoder_layers=2,
             num_query=20, max_gt=16)
CONFIGS = {
    "v1": get_config("bevformer_base", **SMALL, data=DataConfig(raw_size=(64, 96),
                                                                queue_length=2)),
    "v2": get_config("bevformerv2-r50-t1", **SMALL, group_detr=2,
                     data=DataConfig(raw_size=(64, 96), queue_length=1)),
}


def _batch(cfg):
    if cfg.version == "v2":
        return train_batch_v2(cfg, seed=1, device="cpu", rung=64)
    return train_batch(cfg, seed=1, device="cpu")


def _step(cfg, remat: bool):
    """One `Trainer.step` (seed 0) from seeded weights; the step's output,
    the model, each block's and layer's forward calls, and the generators'
    states after it."""
    cfg = cfg.replace(use_remat=remat)
    model = build_model(cfg, init_state_dict(cfg, seed=0), "cpu")
    calls = {}

    def count(name):
        calls[name] = calls.get(name, 0) + 1

    for name, m in model.named_modules():
        if isinstance(m, (Bottleneck, BEVFormerLayer)):
            m.register_forward_pre_hook(lambda m, a, name=name: count(name))
    trainer = Trainer(model, total_steps=10, seed=0)
    out = trainer.step(_batch(cfg))
    rng = (torch.get_rng_state(), model.grid_mask.generator.get_state())
    return out, model, calls, rng


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    return request.param, _step(cfg, False), _step(cfg, True)


def test_remat_gives_the_same_step(pair):
    tag, (out, model, _, rng), (out_r, model_r, _, rng_r) = pair
    assert out.keys() == out_r.keys() and any(k.startswith("d0.") for k in out)
    for k, v in out.items():
        assert out_r[k] == pytest.approx(v, rel=1e-6, abs=1e-7), (tag, k)
    params_r = dict(model_r.named_parameters())
    moved = 0
    for name, p in model.named_parameters():
        if p.grad is None:
            assert params_r[name].grad is None, name
            continue
        assert_close(params_r[name].grad, p.grad, 1e-5, name)
        assert_close(params_r[name], p, 1e-6, name)
        moved += 1
    assert moved > 100
    # dropout's and GridMask's draws: the recomputation replays, and leaves
    # the generators where the step without it leaves them
    assert all(torch.equal(a, b) for a, b in zip(rng, rng_r)), tag


def test_remat_recomputes_the_blocks_and_layers(pair):
    """Forward calls a step: without remat each block and encoder layer
    runs once a frame (v1: the history frame's pass, without gradient, and
    the trained frame's); with it, the trained frame's encoder layers and
    every backbone block but a stage's first run once more, where a
    gradient reaches it (v1 freezes the stem and stage 1, which backward
    never enters)."""
    tag, (_, _, calls, _), (_, _, calls_r, _) = pair
    frames = 2 if tag == "v1" else 1
    frozen = ("img_backbone.layer1.",) if tag == "v1" else ()
    assert sum(1 for n in calls if n.startswith("img_backbone.")) == 16
    assert sum(1 for n in calls if n.startswith("pts_bbox_head.")) == 2
    for name, n in calls.items():
        recomputed = name.startswith("pts_bbox_head.") or (
            int(name.split(".")[-1]) > 0 and not name.startswith(frozen))
        assert n == frames, (name, n)
        assert calls_r[name] == n + recomputed, (name, calls_r[name], n)


def test_remat_moves_batch_norm_statistics_once(pair):
    """V2's train-mode BatchNorms: running statistics equal to the step
    without remat, and one batch counted (v1's FrozenBN has none)."""
    tag, (_, model, _, _), (_, model_r, _, _) = pair
    sd, sd_r = model.state_dict(), model_r.state_dict()
    tracked = [k for k in sd if k.endswith("num_batches_tracked")]
    assert bool(tracked) == (tag == "v2")
    for k in tracked:
        assert int(sd_r[k]) == int(sd[k]) == 1, k
        stem = k[: -len("num_batches_tracked")]
        for stat in ("running_mean", "running_var"):
            assert_close(sd_r[stem + stat], sd[stem + stat], 1e-6, stem + stat)


def test_use_remat_is_a_config_option():
    cfg = apply_overrides(get_config("bevformer_base"), {"use_remat": "True"})
    assert cfg.use_remat is True
    small = CONFIGS["v1"]
    model = build_model(small.replace(use_remat=True), init_state_dict(small, seed=0), "cpu")
    assert model.img_backbone.use_remat and model.pts_bbox_head.transformer.encoder.use_remat
    with pytest.raises(ValueError, match="not a bool"):
        apply_overrides(cfg, {"use_remat": "Ture"})
