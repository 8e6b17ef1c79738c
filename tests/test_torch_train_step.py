"""The port's training step against the JAX package, on the CPU.

A bevformer_base-shaped mini detector (the `mini_base` config of
`tests/test_torch_slice.py`: caffe R10 with DCN in stages 3-4, 4 FPN
levels, SCA capacity 0.25, 2 encoder and 2 decoder layers, base widths)
takes a seeded `train_batch` of queue 3 with a scene break at frame 1, so
that frame 2 carries the BEV of frame 1 alone.

Dropout and GridMask draw other random numbers in the two frameworks, so
the comparison runs in eval mode: JAX's deterministic loss is composed here
from `history_bev`, `model.apply(training=False)` and `bevformer_loss`, and
differentiated with `jax.value_and_grad`; the port runs `loss_fn` on the
model in eval mode and `backward`. Both load the same weights (the JAX init
with seeded noise on the layers it zero-initialises, bridged by
`state_dict_from_jax`), and the JAX gradients go through the same bridge.

The Hungarian matches are compared first and must be equal (the costs are
well separated at these inputs); then every loss term and every trainable
parameter's gradient must agree to 1e-3 of its scale. The frozen stem and
stage 1 have no gradient in the port and an all-zero one in JAX.

The seeds are fixed. The gradient of this network is discontinuous where a
ReLU's input crosses 0 or a bilinear sample crosses a pixel edge, and at
random weights and inputs some such point often lies within fp32 rounding
(~1e-6 relative) of its switch: the two frameworks then take different
sides, and the gradient of a whole receptive field moves by up to a few
percent of its scale, while the loss agrees to 1e-6. (A float64 run of the
port lands on either side as well.) At these seeds no switch lies that
close, and the gradients agree to about 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.configs import BEVFormerConfig as JaxConfig
from bevformer_tpu.configs import DataConfig as JaxData
from bevformer_tpu.core.assigner import hungarian_match as jax_match
from bevformer_tpu.core.losses import bevformer_loss as jax_loss
from bevformer_tpu.models import BEVFormer as JaxBEVFormer
from bevformer_tpu.runtime import train as jax_train
from bevformer_torch.core.assigner import hungarian_match
from bevformer_torch.data import train_batch
from bevformer_torch.runtime import build_model, label_params, loss_fn, state_dict_from_jax
from tests.torch_port_helpers import assert_close, perturb, port_config, to_numpy_tree

TOL = 1e-3

JCFG = JaxConfig(
    name="mini_base", backbone_depth=10, bev_h=16, bev_w=16,
    encoder_layers=2, decoder_layers=2, sca_capacity_ratio=0.25,
    fused_msda="off", fused_dcn="off", use_grid_mask=False, max_gt=16,
    data=JaxData(raw_size=(96, 160), queue_length=3),
)


def jax_batch(batch):
    """The port's `Batch` (torch, CPU) as the JAX `Batch`."""
    a = {k: v.numpy() for k, v in batch._asdict().items()}
    return jax_train.Batch(
        images=jnp.asarray(a["images"]), can_bus=jnp.asarray(a["can_bus"]),
        lidar2img=jnp.asarray(a["lidar2img"]),
        prev_exists=jnp.asarray(a["prev_exists"]),
        gt_boxes=jnp.asarray(a["gt_boxes"]),
        gt_labels=jnp.asarray(a["gt_labels"].astype(np.int32)),
        num_gt=jnp.asarray(a["num_gt"].astype(np.int32)),
    )


def jax_params(cfg, batch, seed=0):
    model = JaxBEVFormer(cfg=cfg)
    b = batch
    params = jax.jit(model.init)(
        jax.random.PRNGKey(seed), b.images[:, -1], b.can_bus[:, -1],
        b.lidar2img[:, -1], jnp.zeros((1, cfg.bev_h * cfg.bev_w, cfg.embed_dims)),
        jnp.zeros((1,), bool),
    )
    params = to_numpy_tree(params)
    rng = np.random.RandomState(seed)
    perturb(params, rng, names=("sampling_offsets", "attention_weights"), std=0.02)
    perturb(params, rng, names=("conv_offset",), std=1e-3)
    return model, params


def jax_deterministic_loss(model, params, batch):
    """JAX's training loss with dropout and GridMask off, and the head
    outputs of the trained frame."""
    c = model.cfg
    prev, has = jax_train.history_bev(model, params, batch)
    preds = model.apply(params, batch.images[:, -1], batch.can_bus[:, -1],
                        batch.lidar2img[:, -1], prev, has, training=False)
    losses = jax_loss(
        preds, batch.gt_boxes, batch.gt_labels, batch.num_gt, c.code_weights,
        num_classes=c.num_classes, cls_loss_weight=c.cls_loss_weight,
        bbox_loss_weight=c.bbox_loss_weight, focal_alpha=c.focal_alpha,
        focal_gamma=c.focal_gamma, group_detr=1, num_query=c.num_query,
    )
    return losses["total"], (losses, preds)


@pytest.fixture(scope="module")
def runs():
    cfg = port_config(JCFG)
    batch = train_batch(cfg, seed=6, device="cpu", scene_break_at=1)
    jb = jax_batch(batch)
    jmodel, params = jax_params(JCFG, jb, seed=3)
    # blocked on at once: JAX's matcher calls back into JAX from a host
    # callback, which can deadlock with JAX work dispatched meanwhile
    (_, (jlosses, jpreds)), jgrads = jax.block_until_ready(jax.jit(jax.value_and_grad(
        lambda p: jax_deterministic_loss(jmodel, p, jb), has_aux=True
    ))(params))

    model = build_model(cfg, state_dict_from_jax(params, JCFG), "cpu")
    labels = label_params(model, cfg.optim.frozen_stages)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    preds = []
    hook = model.register_forward_hook(
        lambda m, i, out: preds.append(out) if isinstance(out, dict) else None
    )
    total, losses = loss_fn(model.eval(), batch)
    total.backward()
    hook.remove()
    return dict(
        cfg=cfg, batch=batch, jb=jb, model=model, labels=labels,
        losses=losses, preds=preds[0],
        jlosses=jax.tree.map(np.asarray, jlosses),
        jpreds=jax.tree.map(np.asarray, jpreds),
        jgrads=state_dict_from_jax(to_numpy_tree(jgrads), JCFG),
    )


def test_assignments_match_jax(runs):
    cfg, jb = runs["cfg"], runs["jb"]
    ours, ref = runs["preds"], runs["jpreds"]
    batch = runs["batch"]
    for lid in range(cfg.decoder_layers):
        a = hungarian_match(ours["all_cls_scores"][lid].detach(),
                            ours["all_bbox_preds"][lid].detach(),
                            batch.gt_boxes, batch.gt_labels, batch.num_gt)
        # one jitted call, blocked on (see the fixture)
        b = jax.block_until_ready(jax.jit(jax_match)(
            jnp.asarray(ref["all_cls_scores"][lid]), jnp.asarray(ref["all_bbox_preds"][lid]),
            jb.gt_boxes, jb.gt_labels, jb.num_gt))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"layer {lid}")
        assert int((a >= 0).sum()) == int(batch.num_gt.sum())


def test_loss_terms_match_jax(runs):
    losses, jlosses = runs["losses"], runs["jlosses"]
    assert set(losses) == set(jlosses)
    for key, ref in jlosses.items():
        assert_close(losses[key], ref, TOL, key)


def test_gradients_match_jax(runs):
    model, labels, jgrads = runs["model"], runs["labels"], runs["jgrads"]
    checked = 0
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            assert p.grad is None, name
            assert not np.any(jgrads[name]), f"{name}: JAX gradient of a frozen parameter"
            continue
        assert p.grad is not None, name
        assert_close(p.grad, jgrads[name], TOL, name)
        checked += 1
    assert checked > 100


def test_frozen_params_stay_frozen():
    """A few train-mode steps (dropout and GridMask on) move every
    trainable parameter and leave the frozen stem and stage 1 and every
    FrozenBN buffer bitwise unchanged."""
    from bevformer_torch.runtime import Trainer, init_state_dict

    cfg = dataclasses.replace(port_config(JCFG), use_grid_mask=True)
    model = build_model(cfg, init_state_dict(cfg, seed=1), "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, total_steps=10, seed=0)
    batch = train_batch(cfg, seed=4, device="cpu")
    for _ in range(2):
        out = trainer.step(batch)
        assert all(np.isfinite(v) for v in out.values()), out
    assert model.training
    labels = label_params(model, cfg.optim.frozen_stages)
    params = dict(model.named_parameters())
    for key, value in model.state_dict().items():
        frozen = key not in params or labels[key] == "frozen"
        same = torch.equal(value, before[key])
        assert same == frozen, f"{key}: {'moved' if not same else 'did not move'}"


def test_train_batch_layout():
    """`train_batch`: the JAX `Batch` shapes; GT boxes inside pc_range with
    positive sizes and labels 0-9, padded with zeros to max_gt; union2one
    CAN-bus deltas that restart at the scene break."""
    from bevformer_torch.data.synth import NUM_OBJECTS, rig_lidar2img

    cfg = port_config(JCFG)
    t_len, cams = cfg.data.queue_length, cfg.data.num_cams
    b = train_batch(cfg, seed=0, device="cpu", scene_break_at=1)
    h, w = cfg.data.img_size
    assert b.images.shape == (1, t_len, cams, h, w, 3)
    assert b.can_bus.shape == (1, t_len, 18) and b.lidar2img.shape == (1, t_len, cams, 4, 4)
    assert b.gt_boxes.shape == (1, cfg.max_gt, 9) and b.gt_labels.shape == (1, cfg.max_gt)
    assert b.prev_exists.tolist() == [[False, False, True]]
    n = int(b.num_gt[0])
    assert n == NUM_OBJECTS
    boxes, labels = b.gt_boxes[0].numpy(), b.gt_labels[0].numpy()
    x0, y0, z0, x1, y1, z1 = cfg.pc_range
    assert (boxes[:n, 0] > x0).all() and (boxes[:n, 0] < x1).all()
    assert (boxes[:n, 1] > y0).all() and (boxes[:n, 1] < y1).all()
    assert (boxes[:n, 2] > z0).all() and (boxes[:n, 2] < z1).all()
    assert (boxes[:n, 3:6] > 0).all() and ((labels[:n] >= 0) & (labels[:n] < 10)).all()
    assert not boxes[n:].any() and not labels[n:].any()
    cb = b.can_bus[0].numpy()
    # scene starts carry no motion; the continuing frame moves 0.5 s at 3-8 m/s
    assert not cb[0, :3].any() and not cb[1, :3].any() and cb[0, -1] == cb[1, -1] == 0
    assert 1.5 <= np.linalg.norm(cb[2, :2]) <= 4.0
    rh, rw = cfg.data.resized_size
    np.testing.assert_allclose(
        b.lidar2img[0, 0].numpy(), rig_lidar2img(rw, rh)[:cams].astype(np.float32), rtol=1e-6
    )
    assert torch.equal(train_batch(cfg, seed=0, device="cpu", scene_break_at=1).images,
                       b.images)
