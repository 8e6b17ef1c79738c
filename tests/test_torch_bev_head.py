"""The port's BEVHead with the FreeAnchor loss (`bevformer_torch/models/
bev_head.py`) against the JAX package's, on the CPU at `mini_config`'s
8 x 8 BEV (1,280 anchors), through the weight bridge
(`runtime.checkpoint.bev_head_state_dict`): the anchors, the delta codec and
the nearest-BEV IoU; the head's outputs; the loss (padded ground truth
included) and its gradients; `get_bboxes`.

The tie order: JAX's `lax.top_k` puts equal values in ascending index
order. A ground-truth box that overlaps fewer anchors than the bag's 25 has
its bag filled with IoU-0 anchors, which enter the loss; `get_bboxes` over
saturated scores (sigmoid = 1) ties the same way. Both are pinned here: the
bags' anchor indices and the decoded indices equal JAX's exactly.

Tolerance: 1e-5 of scale for outputs and losses, 1e-4 for gradients (fp32
sums in another order); indices exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tpu.models import bev_head as jbh
from bevformer_torch.models import bev_head as bh
from bevformer_torch.runtime.checkpoint import bev_head_state_dict
from tests.test_model import mini_config
from tests.torch_port_helpers import assert_close, port_config, t, to_numpy_tree

TOL = 1e-5
GRAD_TOL = 1e-4
G = 6


def _boxes(rng, small_at=None):
    """[1, G, 9] bottom-z boxes; with `small_at` (a cell index), box 0 a
    0.3 m square at that cell's centre: it overlaps only that cell's 20
    anchors, fewer than the bag's 25."""
    boxes = rng.randn(1, G, 9).astype(np.float32)
    boxes[..., :2] *= 20
    boxes[..., 3:6] = np.abs(boxes[..., 3:6]) + 1.0
    if small_at is not None:
        cell = 102.4 / 8
        r, c = divmod(small_at, 8)
        boxes[0, 0, :7] = [-51.2 + (c + 0.5) * cell, -51.2 + (r + 0.5) * cell, -1.0,
                           0.3, 0.3, 1.0, 0.2]
    return boxes


@pytest.fixture(scope="module")
def setup():
    jcfg = mini_config()
    cfg = port_config(jcfg)
    jhead = jbh.BEVHead(cfg=jcfg)
    rng = np.random.RandomState(0)
    bev = (rng.randn(1, jcfg.bev_h * jcfg.bev_w, jcfg.embed_dims) * 0.1).astype(np.float32)
    params = to_numpy_tree(jax.jit(jhead.init)(jax.random.PRNGKey(0), jnp.asarray(bev)))
    params = jax.tree_util.tree_map(
        lambda v: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32), params)
    head = bh.BEVHead(cfg)
    head.load_state_dict({k: t(v) for k, v in bev_head_state_dict(params["params"]).items()})
    return jcfg, cfg, jhead, head, params, bev


def test_anchors_codec_and_iou_match_jax():
    pc = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    anc = bh.generate_anchors(4, 6, pc)
    assert np.array_equal(anc.numpy(), np.asarray(jbh.generate_anchors(4, 6, pc)))
    rng = np.random.RandomState(0)
    a = rng.randn(50, 9).astype(np.float32) * 2
    a[:, 3:6] = np.abs(a[:, 3:6]) + 1.0
    b = rng.randn(50, 9).astype(np.float32) * 2
    b[:, 3:6] = np.abs(b[:, 3:6]) + 0.5
    d = bh.encode_deltas(t(a), t(b))
    assert_close(d, np.asarray(jbh.encode_deltas(jnp.asarray(a), jnp.asarray(b))), TOL, "enc")
    assert_close(bh.decode_deltas(t(a), d), b, 1e-4, "round trip")
    assert_close(bh.decode_deltas(t(a), t(b)),
                 np.asarray(jbh.decode_deltas(jnp.asarray(a), jnp.asarray(b))), TOL, "dec")
    assert_close(bh.bev_iou_aligned_free(t(a), t(b[:7])),
                 np.asarray(jbh.bev_iou_aligned_free(jnp.asarray(a), jnp.asarray(b[:7]))),
                 TOL, "iou")


def test_head_holds_jax_anchors_outside_its_state_dict(setup):
    """The head builds its anchors once, on the host, as JAX's; they are a
    buffer that moves with the module and no checkpoint key."""
    jcfg, cfg, _, head, _, _ = setup
    assert np.array_equal(head.anchors.numpy(), np.asarray(
        jbh.generate_anchors(jcfg.bev_h, jcfg.bev_w, jcfg.pc_range)))
    assert "anchors" not in head.state_dict()
    assert head.anchors.shape == (cfg.bev_h * cfg.bev_w * bh.NUM_ANCHORS, 9)


@pytest.mark.parametrize("k", [1, 5, 25])
def test_top_k_takes_jax_tie_order(k):
    rng = np.random.RandomState(k)
    x = rng.randint(0, 4, (3, 200)).astype(np.float32)  # many ties
    x[1] = 0.0  # all tied
    v, i = bh.top_k(t(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    assert np.array_equal(i.numpy(), np.asarray(ji)) and np.array_equal(v.numpy(), np.asarray(jv))


def test_bev_head_forward_matches_jax(setup):
    jcfg, cfg, jhead, head, params, bev = setup
    expect = jax.jit(jhead.apply)(params, jnp.asarray(bev))
    with torch.no_grad():
        preds = head(t(bev))
    for key in ("cls", "reg", "dir"):
        assert_close(preds[key], np.asarray(expect[key]), TOL, key)


@pytest.mark.parametrize("small_at,num_gt", [(None, 4), (27, 6), (0, 3)],
                         ids=["random", "small-box", "small-box-corner"])
def test_free_anchor_loss_and_gradients_match_jax(setup, small_at, num_gt):
    jcfg, cfg, jhead, head, params, bev = setup
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, small_at)
    labels = rng.randint(0, 10, (1, G)).astype(np.int32)
    ng = np.array([num_gt], np.int32)
    gt = [jnp.asarray(x) for x in (boxes, labels, ng)]

    def jloss(p, x):
        return jhead.loss(jhead.apply(p, x), *gt)

    ref = jax.jit(jloss)(params, jnp.asarray(bev))
    gp, gx = jax.jit(jax.grad(lambda p, x: jloss(p, x)["total"], argnums=(0, 1)))(
        params, jnp.asarray(bev))

    x = t(bev).requires_grad_(True)
    ours = head.loss(head(x), t(boxes), t(labels), t(ng))
    for key in ("loss_positive_bag", "loss_negative_bag", "total"):
        assert_close(ours[key], np.asarray(ref[key]), TOL, key)
    ours["total"].backward()
    assert_close(x.grad, np.asarray(gx), GRAD_TOL, "dbev")
    for k, g in bev_head_state_dict(to_numpy_tree(gp)["params"]).items():
        p = dict(head.named_parameters())[k]
        if k.startswith("conv_dir_cls"):  # the loss does not read the direction
            assert p.grad is None and not np.abs(g).any(), k
            continue
        assert_close(p.grad, g, GRAD_TOL, f"d{k}")
    head.zero_grad()

    # the bags: the same anchors in the same order as JAX's lax.top_k
    anchors = bh.generate_anchors(cfg.bev_h, cfg.bev_w, cfg.pc_range)
    iou, topv, topi = bh.positive_bags(anchors, t(boxes[0]), num_gt, 25)
    jiou = jbh.bev_iou_aligned_free(jnp.asarray(anchors.numpy()), jnp.asarray(boxes[0]))
    jiou = jnp.where((jnp.arange(G) < num_gt)[None, :], jiou, -1.0)
    jv, ji = jax.lax.top_k(jiou.T, 25)
    assert np.array_equal(topi.numpy(), np.asarray(ji))
    assert_close(topv, np.asarray(jv), TOL, "bag iou")
    if small_at is not None:
        overlapping = int((iou[:, 0] > 0).sum())
        assert 0 < overlapping < 25, overlapping  # the bag is filled with IoU-0 anchors
        assert (topv[0, overlapping:] == 0).all()


def test_get_bboxes_matches_jax_with_saturated_ties(setup):
    jcfg, cfg, jhead, head, params, bev = setup
    sat = jax.tree_util.tree_map(np.copy, params)
    bias = sat["params"]["conv_cls"]["bias"]
    bias[::7] = 40.0  # sigmoid(40) == 1 in fp32: hundreds of tied top scores
    head_sat = bh.BEVHead(cfg)
    head_sat.load_state_dict({k: t(v) for k, v in bev_head_state_dict(sat["params"]).items()})
    for p, mod in ((params, head), (sat, head_sat)):
        ref = jax.jit(lambda p, x: jhead.get_bboxes(jhead.apply(p, x), max_num=50))(
            p, jnp.asarray(bev))
        with torch.no_grad():
            ours = mod.get_bboxes(mod(t(bev)), max_num=50)
        assert np.array_equal(ours["labels"].numpy(), np.asarray(ref["labels"]))
        assert_close(ours["scores"], np.asarray(ref["scores"]), TOL, "scores")
        assert_close(ours["bboxes"], np.asarray(ref["bboxes"]), 1e-4, "bboxes")
    assert (ours["scores"] == 1.0).sum() == 50  # every pick was a tie at 1
