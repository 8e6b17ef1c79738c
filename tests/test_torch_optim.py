"""The port's optimizer (`bevformer_torch/runtime/optim.py`) against the JAX
package's (`bevformer_tpu/runtime/optim.py`), on the CPU.

- The parameter groups: JAX's `label_params`, carried through the weight
  bridge `state_dict_from_jax`, give every port parameter its group; FrozenBN
  entries, buffers in the port, are 'frozen' in JAX.
- The schedule: the lr at steps 0, 250, 500, 1000 and the last step equals
  optax's `cosine_schedule` to 1e-6 of the base lr (optax evaluates it in
  float32), in both groups (backbone x0.1).
- AdamW: two steps from the same parameters and gradients (the first
  clipped at norm 35) equal optax's updates to 1e-6 of scale.
- The clip norm: the port's `grad_norm` of an eval-mode step on a mini
  bevformer_base equals `optax.global_norm` of JAX's gradients over the
  parameters the optimizer trains, to 1e-4 relative. (The JAX clip also
  counts the gradients of the FrozenBN affines, which JAX computes but never
  applies; the reference and the port give those no gradient.)
"""

import numpy as np
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
import optax

from bevformer_tpu.configs import DataConfig as JaxData
from bevformer_tpu.configs import OptimConfig as JaxOptim
from bevformer_tpu.models import BEVFormer as JaxBEVFormer
from bevformer_tpu.runtime import optim as jax_optim
from bevformer_torch.configs import OptimConfig
from bevformer_torch.data import train_batch
from bevformer_torch.runtime import (
    build_model,
    label_params,
    make_optimizer,
    state_dict_from_jax,
    train_step,
)
from tests.test_torch_slice import JCFG as SLICE_CFG
from tests.test_torch_train_step import jax_batch, jax_deterministic_loss, jax_params
from tests.torch_port_helpers import port_config, to_numpy_tree

CODES = {"frozen": 0, "backbone": 1, "main": 2}


def test_labels_match_jax_through_the_weight_bridge():
    cfg = port_config(SLICE_CFG)
    model = JaxBEVFormer(cfg=SLICE_CFG)
    h, w = SLICE_CFG.data.img_size
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 6, h, w, 3)), jnp.zeros((1, 18)),
        jnp.zeros((1, 6, 4, 4)), jnp.zeros((1, SLICE_CFG.bev_h * SLICE_CFG.bev_w, 256)),
        jnp.zeros((1,), bool),
    )
    labels = jax_optim.label_params(shapes, SLICE_CFG.optim.frozen_stages)
    codes = jax.tree.map(lambda s, lab: np.full(s.shape, CODES[lab], np.float32), shapes, labels)
    bridged = state_dict_from_jax(to_numpy_tree(codes), SLICE_CFG)

    port = build_model(cfg, {k: np.zeros(v.shape, np.float32) for k, v in bridged.items()},
                       "cpu")
    ours = label_params(port, cfg.optim.frozen_stages)
    params = dict(port.named_parameters())
    assert set(bridged) == set(port.state_dict())
    for key, code in bridged.items():
        assert np.unique(code).size == 1, key
        want = {v: k for k, v in CODES.items()}[int(code.flat[0])]
        got = ours[key] if key in params else "frozen"  # FrozenBN: buffers
        assert got == want, (key, got, want)
    assert {"frozen", "backbone", "main"} == set(ours.values())


def test_schedule_matches_optax():
    from bevformer_torch.runtime import init_state_dict

    total = 2000
    jcfg = SLICE_CFG.optim
    sched = jax_optim.cosine_schedule(jcfg, total)
    cfg = port_config(SLICE_CFG)
    optimizer, scheduler, _ = make_optimizer(
        build_model(cfg, init_state_dict(cfg, seed=0), "cpu"), cfg.optim, total
    )
    checks = {0, 250, 500, 1000, total - 1}
    for step in range(total):
        if step in checks:
            want = float(sched(step))
            main, backbone = (g["lr"] for g in optimizer.param_groups)
            # optax evaluates the schedule in float32
            np.testing.assert_allclose(main, want, atol=1e-6 * jcfg.lr, err_msg=f"step {step}")
            np.testing.assert_allclose(backbone, want * jcfg.backbone_lr_mult,
                                       atol=1e-6 * jcfg.lr * jcfg.backbone_lr_mult)
        optimizer.step()  # no gradients: moves nothing
        scheduler.step()


class _Tiny(nn.Module):
    """Parameters named as the port names them, one per group."""

    def __init__(self, rng):
        super().__init__()
        self.img_backbone = nn.Module()
        self.img_backbone.conv1 = nn.Conv2d(3, 4, 3, bias=False)
        self.img_backbone.layer2 = nn.Conv2d(4, 5, 3, bias=False)
        self.head = nn.Linear(6, 7)
        for p in self.parameters():
            p.data = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))


def test_adamw_steps_match_optax():
    rng = np.random.RandomState(0)
    model = _Tiny(rng)
    cfg = OptimConfig()
    total = 1000
    optimizer, scheduler, params = make_optimizer(model, cfg, total)
    assert not model.img_backbone.conv1.weight.requires_grad

    # the same tree in JAX, labelled by the JAX rules
    def tree_of(fn):
        backbone = {
            "stem_conv": {"kernel": fn("img_backbone.conv1.weight")},
            "layer2_block0": {"conv1": {"kernel": fn("img_backbone.layer2.weight")}},
        }
        head = {"fc": {"kernel": fn("head.weight"), "bias": fn("head.bias")}}
        return {"params": {"img_backbone": backbone, "pts_bbox_head": head}}

    named = dict(model.named_parameters())
    # copies: jnp.asarray may share a numpy array's memory, which the
    # in-place torch step would then change under JAX
    jparams = tree_of(lambda n: jnp.asarray(named[n].detach().numpy().copy()))
    tx, _ = jax_optim.make_optimizer(JaxOptim(), jparams, total)
    state = tx.init(jparams)
    for step, scale in enumerate((30.0, 0.5)):  # the first step's norm exceeds 35
        grads = {n: (rng.randn(*p.shape) * scale).astype(np.float32) for n, p in named.items()}
        grads["img_backbone.conv1.weight"][:] = 0  # frozen: no gradient
        for n, p in named.items():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[n].copy())
        jgrads = tree_of(lambda n: jnp.asarray(grads[n].copy()))
        norm = float(optax.global_norm(jgrads))
        assert (norm > cfg.grad_clip_norm) == (step == 0)
        out = torch.nn.utils.clip_grad_norm_(params, cfg.grad_clip_norm)
        np.testing.assert_allclose(float(out), norm, rtol=1e-6)
        optimizer.step()
        scheduler.step()
        updates, state = tx.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want = tree_of(lambda n: n)
        for path, ref in zip(jax.tree.leaves(want), jax.tree.leaves(jparams)):
            ours = named[path].detach().numpy()
            ref = np.asarray(ref)
            scale_ = max(np.abs(ref).max(), 1e-6)
            assert np.abs(ours - ref).max() <= 1e-6 * scale_, (step, path)


def test_grad_norm_matches_optax_global_norm():
    jcfg = SLICE_CFG.replace(encoder_layers=1, decoder_layers=1, max_gt=16,
                             data=JaxData(raw_size=(96, 160), queue_length=1))
    cfg = port_config(jcfg)
    batch = train_batch(cfg, seed=6, device="cpu")
    jb = jax_batch(batch)
    jmodel, params = jax_params(jcfg, jb, seed=3)
    # blocked on at once: JAX's matcher calls back into JAX from a host
    # callback, which can deadlock with JAX work dispatched meanwhile
    jgrads = jax.block_until_ready(
        jax.jit(jax.grad(lambda p: jax_deterministic_loss(jmodel, p, jb)[0]))(params))
    labels = jax_optim.label_params(jgrads, jcfg.optim.frozen_stages)
    trained = jax.tree.map(lambda g, lab: g if lab != "frozen" else jnp.zeros_like(g),
                           jgrads, labels)
    want = float(optax.global_norm(trained))

    model = build_model(cfg, state_dict_from_jax(params, jcfg), "cpu").eval()
    optimizer, scheduler, trainable = make_optimizer(model, cfg.optim, 100)
    out = train_step(model, optimizer, scheduler, trainable, cfg.optim.grad_clip_norm, batch)
    np.testing.assert_allclose(out["grad_norm"], want, rtol=1e-4)
    # JAX's own clip also counts the FrozenBN affines' gradients
    assert float(optax.global_norm(jgrads)) >= want
