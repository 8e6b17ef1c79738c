"""The gradient surrogates of `bevformer_torch/tools/bench_train2.py` and
`bench_train_bisect.py` against `jax.grad` of the same surrogates of the
JAX tools, on the CPU at the mini size of `tests/test_torch_train_step.py`
(caffe R10 with DCN in stages 3-4, 16 x 16 BEV, 2 + 2 layers): backbone +
neck (the sum of the levels' means), BEV only without history (the BEV's
mean) and the head without a match (the mean of the class scores plus that
of the boxes), on the last frame of one seeded `train_batch`.

Dropout and GridMask draw other random numbers in the two frameworks, so
both run deterministic (the port in eval mode, JAX with `training=False`).
The gradients of the port's trainable parameters, as `Trainer` freezes
them, must equal JAX's to 1e-3 in relative L2 norm over all of them (a
ReLU input within rounding of 0 can move one receptive field's gradient
by a few percent between two fp32 computations, PERF.md; the norm over
the whole model keeps such a flip inside the tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.configs import BEVFormerConfig as JaxConfig
from bevformer_tpu.configs import DataConfig as JaxData
from bevformer_tpu.models import BEVFormer as JaxBEVFormer
from bevformer_torch.data import train_batch
from bevformer_torch.runtime import build_model, state_dict_from_jax
from bevformer_torch.tools import bench_train2, common
from tests.torch_port_helpers import perturb, port_config, to_numpy_tree

TOL = 1e-3

JCFG = JaxConfig(
    name="mini_base", backbone_depth=10, bev_h=16, bev_w=16,
    encoder_layers=2, decoder_layers=2, sca_capacity_ratio=0.25,
    fused_msda="off", fused_dcn="off", use_grid_mask=False, max_gt=16,
    data=JaxData(raw_size=(96, 160), queue_length=3),
)


def jax_surrogates(model, images, can_bus, l2i):
    """The JAX tools' surrogates (deterministic) on one frame."""
    c = model.cfg
    prev = jnp.zeros((1, c.bev_h * c.bev_w, c.embed_dims), jnp.float32)
    has = jnp.zeros((1,), bool)

    def backbone(p):
        feats = model.apply(p, images, method="extract_feat")
        return sum(f.astype(jnp.float32).mean() for f in feats)

    def bev(p):
        return model.apply(p, images, can_bus, l2i, prev, has, only_bev=True).mean()

    def head(p):
        preds = model.apply(p, images, can_bus, l2i, prev, has)
        return preds["all_cls_scores"].mean() + preds["all_bbox_preds"].mean()

    return dict(backbone=backbone, bev=bev, head=head)


@pytest.fixture(scope="module")
def mini():
    cfg = port_config(JCFG)
    batch = train_batch(cfg, seed=6, device="cpu")
    frame = [jnp.asarray(t.numpy()) for t in bench_train2.last_frame(batch)]
    jmodel = JaxBEVFormer(cfg=JCFG)
    c = JCFG
    params = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), *frame, jnp.zeros((1, c.bev_h * c.bev_w, c.embed_dims)),
        jnp.zeros((1,), bool)))
    rng = np.random.RandomState(3)
    perturb(params, rng, names=("sampling_offsets", "attention_weights"), std=0.02)
    perturb(params, rng, names=("conv_offset",), std=1e-3)
    # LayerNorms off their identity init: the BEV's mean over its channels
    # then depends on the layers before the last norm (at scale 1 and bias 0
    # it is 0 whatever they compute, and so is its gradient)
    perturb(params, rng, names=("norm1", "norm2", "norm3"), std=0.1)
    model = common.frozen_as_trainer(build_model(cfg, state_dict_from_jax(params, JCFG), "cpu"))
    return dict(cfg=cfg, batch=batch, frame=frame, jmodel=jmodel, params=params,
                model=model.eval())


@pytest.mark.parametrize("name,loss", [
    ("backbone", bench_train2.backbone_loss),
    ("bev", bench_train2.bev_loss),
    ("head", bench_train2.head_loss),
])
def test_surrogate_gradients_match_jax(mini, name, loss):
    model, batch = mini["model"], mini["batch"]
    value = common.grad_step(model, lambda: loss(model, batch))()
    jloss = jax_surrogates(mini["jmodel"], *mini["frame"])[name]
    jvalue, jgrads = jax.block_until_ready(jax.jit(jax.value_and_grad(jloss))(mini["params"]))
    # a mean over features of magnitude ~10: fp32 sums differ by ~1e-5 of it
    assert float(value) == pytest.approx(float(jvalue), rel=1e-4, abs=1e-6)
    ref = state_dict_from_jax(to_numpy_tree(jgrads), JCFG)
    ours, theirs = [], []
    for key, p in model.named_parameters():
        if not p.requires_grad:
            continue
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        ours.append(g.ravel())
        theirs.append(np.asarray(ref[key], np.float32).ravel())
    ours, theirs = np.concatenate(ours), np.concatenate(theirs)
    assert np.linalg.norm(theirs) > 0
    rel = np.linalg.norm(ours - theirs) / np.linalg.norm(theirs)
    assert rel <= TOL, f"{name}: relative L2 error {rel:.3e}"


def test_shallower_keeps_the_first_layers(mini):
    """`bench_train2.shallower` keeps every weight of the model but those of
    the encoder layers past the first, and trains as `Trainer` would."""
    model, cfg = mini["model"], mini["cfg"]
    one = bench_train2.shallower(model, cfg, 1, "cpu")
    assert one.training and one.cfg.encoder_layers == 1
    full = model.state_dict()
    for key, value in one.state_dict().items():
        assert torch.equal(value, full[key]), key
    dropped = set(full) - set(one.state_dict())
    assert dropped and all(k.startswith(bench_train2.ENCODER + "1.") for k in dropped)
    frozen = [n for n, p in one.named_parameters() if not p.requires_grad]
    assert frozen and all(n.startswith(("img_backbone.conv1", "img_backbone.layer1"))
                          for n in frozen)
