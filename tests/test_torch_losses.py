"""The port's box codec, matching costs, Hungarian assignment and detection
loss (`bevformer_torch/core/{boxes,assigner,losses}.py`) against the JAX
package's, on the CPU, on the same numpy inputs.

Costs are compared first; the assignments must be equal (the seeded costs
are well separated: random logits and boxes give no near-ties); the loss
terms and their gradients with respect to the predictions must then agree
to 1e-5 of their scale (fp32 elementwise math and sums in another order).
A batch element with no GT (and a batch with none at all) is covered.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.core import assigner as jax_assigner
from bevformer_tpu.core import boxes as jax_boxes
from bevformer_tpu.core import losses as jax_losses
from bevformer_torch.core import assigner, boxes, losses
from tests.torch_port_helpers import assert_close, t

TOL = 1e-5
CODE_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)


def _gt(rng, b, g, num_gt):
    gt = np.zeros((b, g, 9), np.float32)
    labels = np.zeros((b, g), np.int32)
    for i, n in enumerate(num_gt):
        gt[i, :n, 0:2] = rng.uniform(-40, 40, (n, 2))
        gt[i, :n, 2] = rng.uniform(-1.5, 0.5, n)
        gt[i, :n, 3:6] = np.abs(rng.randn(n, 3)) * 0.8 + np.array([1.9, 4.5, 1.7])
        gt[i, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        gt[i, :n, 7:9] = rng.randn(n, 2) * 0.5
        labels[i, :n] = rng.randint(0, 10, n)
    return gt, labels, np.asarray(num_gt, np.int32)


def _preds(rng, layers, b, q):
    cls = rng.randn(layers, b, q, 10).astype(np.float32) * 2
    box = np.concatenate([
        rng.uniform(-45, 45, (layers, b, q, 2)), rng.randn(layers, b, q, 2) * 0.5 + 1,
        rng.randn(layers, b, q, 2), rng.uniform(-1, 1, (layers, b, q, 2)),
        rng.randn(layers, b, q, 2),
    ], -1).astype(np.float32)
    return cls, box


def test_normalize_bbox_matches_jax():
    rng = np.random.RandomState(0)
    gt, _, _ = _gt(rng, 2, 7, [7, 7])
    assert_close(boxes.normalize_bbox(t(gt)), np.asarray(jax_boxes.normalize_bbox(jnp.asarray(gt))),
                 TOL, "normalize_bbox")
    # round trip through the decode codec
    assert_close(boxes.denormalize_bbox(boxes.normalize_bbox(t(gt))), gt, TOL, "round trip")


def test_match_costs_match_jax():
    rng = np.random.RandomState(1)
    cls, box = _preds(rng, 1, 1, 30)
    gt, labels, _ = _gt(rng, 1, 8, [8])
    gn = jax_boxes.normalize_bbox(jnp.asarray(gt[0]))
    ref_cls = jax_assigner.focal_cls_cost(jnp.asarray(cls[0, 0]), jnp.asarray(labels[0]))
    ref_l1 = jax_assigner.bbox3d_l1_cost(jnp.asarray(box[0, 0]), gn)
    assert_close(assigner.focal_cls_cost(t(cls[0, 0]), t(labels[0]).long()), np.asarray(ref_cls),
                 TOL, "focal cost")
    assert_close(assigner.bbox3d_l1_cost(t(box[0, 0]), t(np.asarray(gn))), np.asarray(ref_l1),
                 TOL, "l1 cost")


@pytest.mark.parametrize("num_gt", [[5, 8], [0, 6], [0, 0]], ids=["full", "one_empty", "all_empty"])
def test_assignment_and_loss_match_jax(num_gt):
    rng = np.random.RandomState(sum(num_gt) + 2)
    cls, box = _preds(rng, 3, 2, 30)
    gt, labels, ngt = _gt(rng, 2, 8, num_gt)

    for lid in range(3):
        ours = assigner.hungarian_match(t(cls[lid]), t(box[lid]), t(gt), t(labels), t(ngt))
        ref = jax_assigner.hungarian_match(
            jnp.asarray(cls[lid]), jnp.asarray(box[lid]), jnp.asarray(gt),
            jnp.asarray(labels), jnp.asarray(ngt), impl="scipy",
        )
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref), err_msg=f"layer {lid}")
        assert int((ours >= 0).sum()) == sum(num_gt)

    def jloss(c, bx):
        out = jax_losses.bevformer_loss(
            {"all_cls_scores": c, "all_bbox_preds": bx}, jnp.asarray(gt),
            jnp.asarray(labels), jnp.asarray(ngt), CODE_WEIGHTS,
        )
        return out["total"], out

    (_, ref_terms), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(box)
    )
    c, bx = t(cls).requires_grad_(), t(box).requires_grad_()
    terms = losses.bevformer_loss(
        {"all_cls_scores": c, "all_bbox_preds": bx}, t(gt), t(labels), t(ngt), CODE_WEIGHTS,
    )
    assert set(terms) == set(ref_terms) == {
        "d0.loss_cls", "d0.loss_bbox", "d1.loss_cls", "d1.loss_bbox",
        "loss_cls", "loss_bbox", "total",
    }
    for key, ref in ref_terms.items():
        assert torch.isfinite(terms[key])
        assert_close(terms[key], np.asarray(ref), TOL, key)
    terms["total"].backward()
    assert_close(c.grad, np.asarray(ref_grads[0]), TOL, "d cls")
    assert_close(bx.grad, np.asarray(ref_grads[1]), TOL, "d bbox")
    if sum(num_gt) == 0:
        assert float(terms["loss_bbox"].detach()) == 0.0


def test_sigmoid_focal_loss_matches_jax():
    rng = np.random.RandomState(4)
    logits = (rng.randn(40, 10) * 3).astype(np.float32)
    labels = rng.randint(0, 11, 40).astype(np.int32)  # 10 = background
    ref = jax_losses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert_close(losses.sigmoid_focal_loss(t(logits), t(labels)), np.asarray(ref), TOL, "focal")
