"""BEVFormerV2 training in the port against the JAX package, on the CPU.

The mini V2 detector of `tests/test_torch_v2.py` (R10 with BatchNorm, 8 x 8
BEV, 1 + 2 layers, 12 queries in 3 GroupDETR groups, smooth-L1 boxes) with
the DD3D head over 5 levels, t1-shaped (frames (0,)) and t2-shaped (frames
(-1, 0), ResNetFusion), on the JAX exact paths (`fused_msda="off"`). The
JAX variables come from `train_v2.init_state_v2` (the DD3D head included),
with seeded noise on the sampling layers and the running statistics seeded
away from 0 and 1, carried by `state_dict_from_jax_v2`. Dropout and
GridMask draw other random numbers in the two frameworks, so both run with
them off (the port: every `nn.Dropout` in eval mode; JAX: `flax.linen.
Dropout` patched to the identity, `use_grid_mask=False`), with BatchNorm in
train mode and every GroupDETR group, as JAX's `train_v2.loss_fn` runs;
Flax's batch variance runs in two passes, as torch computes it.

* One step of each (seeded numpy inputs; random DD3D targets as JAX's
  `tests/test_dd3d.py` makes them): every loss term, `grad_norm` and the
  gradient of every parameter equal `jax.value_and_grad` of JAX's
  `loss_fn` at TOL of scale. JAX's DD3D has a `box3d_depth` bias the
  reference does not (`fcos3d.py:128`); the bridge leaves it out, and so
  does the norm compared.
* The BatchNorms' running statistics after the step: torch updates the
  running variance with the unbiased batch variance, Flax with the biased
  one; the expected value is JAX's with the factor n / (n - 1) written out.
* The parameters after the AdamW step equal optax's where the gradient's
  sign is resolved (Adam's first step moves each element by lr x sign).
* The history frame runs in eval mode: the running statistics after a t2
  step equal those of the same step with the history BEVs handed in.
* A history frame missing from the scene (the dataset fills it with the
  current frame) is encoded, not zeroed as JAX's training step does.
* `NuscenesDD3D`'s losses and `assign_targets`, the quaternion and corner
  helpers, folded-group self-attention, `bevformer_loss` with GroupDETR
  and smooth-L1, and the optimizer's labels equal JAX's; a
  reference-layout V2 `.pth` with the DD3D head loads whole and gives JAX's
  mono losses; `Trainer` takes each V2 preset.
"""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import flax.linen.normalization as flax_normalization
import jax
import jax.numpy as jnp

from bevformer_tpu.core import losses as jax_losses
from bevformer_tpu.models import dd3d as jax_dd3d
from bevformer_tpu.models.detector_v2 import BEVFormerV2 as JaxBEVFormerV2
from bevformer_tpu.runtime import optim as jax_optim
from bevformer_tpu.runtime import train_v2 as jax_train_v2
from bevformer_tpu.runtime.checkpoint import (
    convert_reference_state_dict_v2,
    export_reference_state_dict_v2,
)
from bevformer_torch.configs import get_config
from bevformer_torch.core import losses
from bevformer_torch.data.synth import rig_lidar2img
from bevformer_torch.models import dd3d
from bevformer_torch.models.layers import MultiheadAttention
from bevformer_torch.runtime import (
    BatchV2,
    Trainer,
    build_model,
    label_params,
    load_reference_pth,
    loss_fn_v2,
    state_dict_from_jax_v2,
    train_v2,
)
from tests.test_dd3d import _mk_targets
from tests.test_torch_v2 import JCFG1, JCFG2, seed_batch_stats
from tests.torch_port_helpers import assert_close, perturb, port_config, t, to_numpy_tree

_COMPUTE_STATS = flax_normalization._compute_stats
TOL = 1e-4
EXACT_TOL = 1e-5
WITNESS = 10.0  # gradients behind a train-mode BatchNorm: this multiple of the noisy witness
WITNESS_NOISE = 1e-6  # relative noise on each BatchNorm output in the witness
WITNESS_CAP = 0.1  # ... but never more than this, and no witness above it
ZERO_TOL = 1e-10  # a gradient zero in exact arithmetic: norm within this of the global norm
# V2's training recipe: the whole backbone trains (`frozen_stages=-1`)
JCFGS = {tag: c.replace(use_grid_mask=False, optim=dataclasses.replace(c.optim, frozen_stages=-1))
         for tag, c in (("t1", JCFG1), ("t2", JCFG2))}


class _NoTx:
    def init(self, params):
        return ()


def _numpy_batch(jcfg, seed):
    """Seeded inputs of one sample: noise images of every frame, the rigs'
    lidar2img, 6 GT boxes (4 counted), random DD3D targets and intrinsics."""
    rng = np.random.RandomState(seed)
    h, w = jcfg.data.img_size
    n_t, cams = len(jcfg.frames), jcfg.data.num_cams
    gt = rng.randn(1, 6, 9).astype(np.float32) * np.float32(8)
    gt[..., 3:6] = np.abs(gt[..., 3:6]) / 8 + 0.5
    targets = {k: np.array(v) for k, v in _mk_targets(rng, cams, 4, w, h).items()}
    f = 60.0
    inv_k = np.linalg.inv(np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]))
    return dict(
        images=rng.randn(1, n_t, cams, h, w, 3).astype(np.float32),
        lidar2img=np.stack([rig_lidar2img(w, h)] * n_t).astype(np.float32)[None],
        frame_valid=np.ones((1, n_t), bool), flip=np.array([True]),
        bda_mat=np.array([[[0.9986, -0.3245], [0.3245, 0.9986]]], np.float32),
        gt_boxes=gt, gt_labels=rng.randint(0, 10, (1, 6)).astype(np.int32),
        num_gt=np.array([4], np.int32),
        inv_intrinsics=np.tile(inv_k[None, None], (1, cams, 1, 1)).astype(np.float32),
        mono_targets=targets)


def _port_batch(b) -> BatchV2:
    mono = {k: t(v) for k, v in b["mono_targets"].items()}
    for k in ("classes", "attributes", "num_gt"):
        mono[k] = mono[k].long()
    return BatchV2(**{k: t(v) for k, v in b.items() if k != "mono_targets"},
                   mono_targets=mono)._replace(gt_labels=t(b["gt_labels"]).long(),
                                               num_gt=t(b["num_gt"]).long())


def _jax_batch(b):
    return jax_train_v2.BatchV2(**{k: (jax.tree.map(jnp.asarray, v)) for k, v in b.items()})


def _deterministic(model):
    """Train mode with every dropout off."""
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    return model


def _bn_counts(model, batch):
    """Elements per channel (n) of each BatchNorm's input in a train-mode
    run of the loss, by module name."""
    counts = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: counts.__setitem__(name, i[0].numel() // i[0].shape[1])
        if m.training else None)
        for name, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        with torch.no_grad():
            loss_fn_v2(copy.deepcopy(model), batch)
    finally:
        for h in hooks:
            h.remove()
    return counts


@contextlib.contextmanager
def _noisy_batch_norms(model, noise, seed=0):
    """Every BatchNorm's output x (1 + noise N(0, 1)) within the block: a
    perturbation of a few fp32 roundings at each ReLU's input."""
    gen = torch.Generator().manual_seed(seed)
    hooks = [m.register_forward_hook(
        lambda m, i, out: out * (1 + noise * torch.randn(out.shape, generator=gen)))
        for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def _two_pass_stats(*args, **kwargs):
    """Flax's batch statistics with the two-pass variance mean((x -
    mean)^2), torch's: Flax's default E[x^2] - E[x]^2 loses the variance
    of a channel whose mean dwarfs its spread, as on the DD3D towers'
    coarsest levels here (6 and 12 values a channel)."""
    return _COMPUTE_STATS(*args, **dict(kwargs, use_fast_variance=False))


def _merge_forward_and_mono_stats(forward, mono):
    """The statistics of JAX's training step: the forward's updates, and the
    DD3D head's from the mono apply. (JAX's `_merge_stats` takes every
    entry of the mono apply's `batch_stats`, which Flax returns whole, the
    unchanged backbone's included: see
    `test_jax_merge_drops_the_forward_statistics`.)"""
    stats = dict(forward["batch_stats"])
    stats["fcos3d_bbox_head"] = mono["batch_stats"]["fcos3d_bbox_head"]
    return {**forward, "batch_stats": stats}


@pytest.fixture(scope="module")
def runs():
    """Per tag: JAX's loss terms, gradients (and a noisy witness of them)
    and updated statistics; the port's; and optax's AdamW step on the
    port's gradients."""
    patch = pytest.MonkeyPatch()
    patch.setattr(flax_nn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    patch.setattr(jax_train_v2, "_merge_stats", _merge_forward_and_mono_stats)
    patch.setattr(flax_normalization, "_compute_stats", _two_pass_stats)
    out = {}
    try:
        # one init (t2's, with the fusion and the DD3D head) for both
        rng = np.random.RandomState(1)
        state = jax_train_v2.init_state_v2(JaxBEVFormerV2(cfg=JCFGS["t2"]), _NoTx(),
                                           jax.random.PRNGKey(0),
                                           _jax_batch(_numpy_batch(JCFGS["t2"], seed=2)))
        params = perturb(to_numpy_tree(state.params), rng,
                         names=("sampling_offsets", "attention_weights"), std=0.02)
        stats = to_numpy_tree(state.batch_stats)
        seed_batch_stats(stats, rng)
        for tag, jcfg in JCFGS.items():
            if tag == "t1":  # the same weights without the fusion
                variables = {c: {**tree, "pts_bbox_head": {
                    **tree["pts_bbox_head"], "transformer": {
                        k: x for k, x in tree["pts_bbox_head"]["transformer"].items()
                        if k != "fusion"}}} for c, tree in (("params", params), ("batch_stats", stats))}
            else:
                variables = {"params": params, "batch_stats": stats}
            b = _numpy_batch(jcfg, seed=2)
            jmodel = JaxBEVFormerV2(cfg=jcfg)

            def loss(p, jb, variables=variables, jmodel=jmodel):
                return jax_train_v2.loss_fn(jmodel, p, variables["batch_stats"], jb,
                                            jax.random.PRNGKey(5))

            p0 = jax.tree.map(jnp.asarray, variables["params"])
            # blocked on at once: JAX's matcher calls back into JAX from a host
            # callback, which can deadlock with JAX work dispatched meanwhile
            (_, (jlosses, new_stats)), jgrads = jax.block_until_ready(
                jax.jit(jax.value_and_grad(loss, has_aux=True))(p0, _jax_batch(b)))
            cfg = port_config(jcfg)
            model = _deterministic(build_model(cfg, state_dict_from_jax_v2(variables, jcfg), "cpu"))

            def bridged(tree, stats_tree=variables["batch_stats"], jcfg=jcfg):
                return state_dict_from_jax_v2({"params": to_numpy_tree(tree),
                                               "batch_stats": to_numpy_tree(stats_tree)}, jcfg)

            out[tag] = dict(
                jcfg=jcfg, cfg=cfg, batch=_port_batch(b), variables=variables, p0=p0,
                model=model, jlosses=jax.tree.map(np.asarray, jlosses), jgrads=bridged(jgrads),
                jstats=bridged(variables["params"], new_stats))
    finally:
        patch.undo()
    for r in out.values():
        model = copy.deepcopy(r["model"])
        r["bn_n"] = _bn_counts(model, r["batch"])
        total, terms = loss_fn_v2(model, r["batch"])
        total.backward()
        r.update(grad_model=model, losses={k: float(v.detach()) for k, v in terms.items()})
        noisy = copy.deepcopy(r["model"])
        with _noisy_batch_norms(noisy, WITNESS_NOISE):
            loss_fn_v2(noisy, r["batch"])[0].backward()
        r["noisy_grads"] = {n: p.grad for n, p in noisy.named_parameters()}
        trainer = Trainer(copy.deepcopy(r["model"]), total_steps=100)
        _deterministic(trainer.model)
        r.update(step_out=trainer.step(r["batch"]), stepped_model=trainer.model)
        # optax's AdamW (JAX `optim.make_optimizer(bn_trainable=True)`) on
        # the port's gradients, read by JAX's own reference-layout reader
        sd = {k: v.detach().numpy() for k, v in r["model"].state_dict().items()}
        sd.update({n: p.grad.numpy() for n, p in model.named_parameters()})
        grads = jax.tree.map(jnp.asarray, convert_reference_state_dict_v2(sd, r["jcfg"])["params"])
        tx, _ = jax_optim.make_optimizer(r["jcfg"].optim, r["p0"], 100, bn_trainable=True)
        # jitted init, numpy add: one compile each, not one per parameter shape
        updates, _ = jax.jit(tx.update)(grads, jax.jit(tx.init)(r["p0"]), r["p0"])
        stepped = jax.tree.map(lambda p, u: np.asarray(p) + np.asarray(u), r["p0"], updates)
        r["optax_stepped"] = state_dict_from_jax_v2(
            {"params": stepped, "batch_stats": r["variables"]["batch_stats"]}, r["jcfg"])
    return out


@pytest.mark.parametrize("tag", ["t1", "t2"])
def test_loss_terms_match_jax(runs, tag):
    r = runs[tag]
    assert set(r["losses"]) == set(r["jlosses"]) and any(k.endswith("_mono") for k in r["losses"])
    assert len([k for k in r["losses"] if k.endswith("loss_bbox")]) == r["cfg"].decoder_layers
    for key, ref in r["jlosses"].items():
        assert_close(torch.tensor(r["losses"][key]), ref, TOL, key)
    assert r["step_out"]["total"] == pytest.approx(r["losses"]["total"], rel=1e-6)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("tag", ["t1", "t2"])
def test_gradients_and_grad_norm_match_jax(runs, tag):
    """Each gradient within TOL of JAX's in relative L2 norm, or within
    WITNESS x what WITNESS_NOISE on every BatchNorm's output moves the
    port's own gradient, and never beyond WITNESS_CAP: BatchNorm on batch
    statistics standardises each ReLU's input (the backbone's, the DD3D
    towers', the fusion's), so many sit within fp32 rounding of 0 and flip
    between any two computations, and the gradients behind them move by
    ~1e-2 (JAX's own jitted and op-by-op gradients of this backbone differ
    by ~5e-3 in L2). The largest witness is 0.029 (t1, a DD3D tower's
    BatchNorm), so a zero, sign-flipped or halved gradient fails. The
    box towers' per-level parameters of the levels no target reaches are
    0 on both sides. One gradient is zero in exact arithmetic: the last
    FPN level's conv bias (1 x 1 at this size), whose shift DD3D's tower
    BatchNorm removes whole; both sides hold rounding (~1e-13) there, and
    are held to ZERO_TOL of the global norm instead."""
    r = runs[tag]
    model, jgrads, noisy = r["grad_model"], r["jgrads"], r["noisy_grads"]
    names = dict(model.named_parameters())
    norm = float(np.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in names.values())))
    moved, zero = 0, []
    for name, p in names.items():
        assert p.grad is not None, name
        if max(float(p.grad.norm()), float(np.linalg.norm(jgrads[name]))) <= ZERO_TOL * norm:
            zero.append(name)
            continue
        err, witness = _rel_l2(p.grad, jgrads[name]), _rel_l2(noisy[name], p.grad)
        assert witness <= WITNESS_CAP, (name, witness)
        assert err <= min(WITNESS_CAP, max(TOL, WITNESS * witness)), (name, err, witness)
        moved += witness > TOL
    exact = [n for n in zero if not names[n].grad.any() and not jgrads[n].any()]
    assert [n for n in zero if n not in exact] == ["img_neck.fpn_convs.4.conv.bias"], zero
    # the noise moves what lies behind a BatchNorm in train mode, and
    # leaves the rest (the encoder, the decoder, the heads) below TOL
    assert 50 < moved < len(names) - 50
    assert any(n.startswith("fcos3d_bbox_head.") for n in names)
    if tag == "t2":
        assert any(".fusion." in n for n in names)
    ref_norm = float(np.sqrt(sum(float((jgrads[n].astype(np.float64) ** 2).sum()) for n in names)))
    assert r["step_out"]["grad_norm"] == pytest.approx(ref_norm, rel=1e-3)


@pytest.mark.parametrize("tag", ["t1", "t2"])
def test_running_statistics_after_the_step(runs, tag):
    """torch: r' = 0.9 r + 0.1 var_unbiased; Flax: r' = 0.9 r + 0.1
    var_biased, and var_unbiased = var_biased * n / (n - 1), n the
    elements per channel of the BN's input."""
    r = runs[tag]
    old = r["model"].state_dict()
    ours = r["grad_model"].state_dict()
    ref = r["jstats"]
    checked = 0
    for name, n in r["bn_n"].items():
        assert_close(ours[f"{name}.running_mean"], ref[f"{name}.running_mean"], EXACT_TOL, name)
        prev = old[f"{name}.running_var"].double().numpy()
        batch_var = (ref[f"{name}.running_var"].astype(np.float64) - 0.9 * prev) / 0.1
        want = 0.9 * prev + 0.1 * batch_var * n / (n - 1)
        assert_close(ours[f"{name}.running_var"], want, EXACT_TOL, name)
        assert int(ours[f"{name}.num_batches_tracked"]) == 1
        checked += 1
    assert checked == sum(isinstance(m, torch.nn.BatchNorm2d) for m in r["model"].modules())


@pytest.mark.parametrize("tag", ["t1", "t2"])
def test_parameters_after_the_adamw_step(runs, tag):
    """The step's clip, AdamW (backbone lr x 0.1, weight decay on every
    parameter) and warmup lr equal optax's transform applied to the port's
    own gradients, to the float32 rounding of the parameter."""
    r = runs[tag]
    before = r["model"].state_dict()
    for name, p in r["stepped_model"].named_parameters():
        ours, ref = p.detach().numpy(), r["optax_stepped"][name]
        # a zero stays put only where its gradient is zero (a DD3D level
        # without positives)
        assert (not np.array_equal(ours, before[name].numpy())
                or not before[name].any() and not p.grad.any()), name
        # torch decays, then steps (two roundings), optax adds one update
        # (float32 ulps of the parameter); optax corrects the second
        # moment's bias by 1 - 0.999^t in float32, where 0.999 rounds by
        # 1.3e-8, which is 1.3e-5 of 1 - 0.999 (6.4e-6 of the step)
        ulp = np.spacing(np.maximum(np.abs(ours), np.abs(ref)))
        step = np.abs(ref.astype(np.float64) - before[name].numpy())
        assert np.all(np.abs(ours.astype(np.float64) - ref) <= 4 * ulp + 3e-5 * step), name


def test_jax_merge_drops_the_forward_statistics():
    """JAX's `_merge_stats` (`train_v2.py:177-194`) overlays every entry of
    the mono apply's `batch_stats`; Flax returns a mutable collection whole,
    so the backbone's statistics come back as they were before the step
    (ROADMAP.md §3). The port updates every BatchNorm that ran in train
    mode, as torch (the reference) does."""
    new, old, head = np.ones(2), np.zeros(2), np.full(2, 5.0)
    merged = jax_train_v2._merge_stats(
        {"batch_stats": {"img_backbone": {"bn": {"mean": new}}}},
        {"batch_stats": {"img_backbone": {"bn": {"mean": old}}, "fcos3d_bbox_head": head}})
    assert merged["batch_stats"]["img_backbone"]["bn"]["mean"] is old


def test_history_runs_in_eval_mode(runs, monkeypatch):
    """A t2 step's BatchNorm statistics equal those of the same step with
    the history BEVs computed beforehand: the history frame moves none."""
    r = runs["t2"]
    prev = train_v2.history_bevs(copy.deepcopy(r["model"]), r["batch"])
    assert prev[0] is not None and prev[1] is None
    whole = copy.deepcopy(r["model"])
    with torch.no_grad():
        loss_fn_v2(whole, r["batch"])
    alone = copy.deepcopy(r["model"])
    monkeypatch.setattr(train_v2, "history_bevs", lambda m, b: prev)
    with torch.no_grad():
        loss_fn_v2(alone, r["batch"])
    assert alone.training and all(m.training for m in alone.modules()
                                  if isinstance(m, torch.nn.BatchNorm2d))
    ours, ref = whole.state_dict(), alone.state_dict()
    for key in ours:
        assert torch.equal(ours[key], ref[key]), key


def test_missing_history_is_encoded_not_zeroed(runs):
    """The dataset fills a history frame outside the scene with the
    current frame's images (frame_valid False). The port encodes it, as
    the reference and JAX's `VideoEvaluatorV2` do; JAX's training step
    multiplies it by 0 (`train_v2.py:153-162`), a departure ROADMAP.md §3
    records."""
    r = runs["t2"]
    b = r["batch"]
    filled = b._replace(images=b.images[:, [1, 1]].contiguous(),
                        lidar2img=b.lidar2img[:, [1, 1]].contiguous(),
                        frame_valid=torch.tensor([[False, True]]))
    model = copy.deepcopy(r["model"])
    prev = train_v2.history_bevs(model, filled)
    with train_v2.eval_mode(model), torch.no_grad():
        cur = model.bev_only(filled.images[:, 1], filled.lidar2img[:, 1], filled.flip,
                             filled.bda_mat)
    assert torch.equal(prev[0], cur) and float(cur.abs().max()) > 0
    valid = filled._replace(frame_valid=torch.ones(1, 2, dtype=torch.bool))
    with torch.no_grad():
        a = loss_fn_v2(copy.deepcopy(r["model"]), filled)[0]
        b2 = loss_fn_v2(copy.deepcopy(r["model"]), valid)[0]
    assert torch.equal(a, b2)


# ---------------------------------------------------------------- DD3D

def _dd3d_pair(seed=0, n=6, h=16, w=32, g=5):
    """JAX `NuscenesDD3D` variables (running statistics seeded) and the
    port's head with them, on seeded 5-level features and targets."""
    from bevformer_torch.runtime.checkpoint import dd3d_state_dict

    rng = np.random.RandomState(seed)
    jcfg = JCFGS["t1"]
    feats = [rng.randn(n, h // 2 ** i, w // 2 ** i, jcfg.embed_dims).astype(np.float32)
             for i in range(5)]
    targets = _mk_targets(rng, n, g, w * 8, h * 8)
    f = 40.0
    inv_k = np.tile(np.linalg.inv([[f, 0, w * 4], [0, f, h * 4], [0, 0, 1]])[None], (n, 1, 1))
    inv_k = inv_k.astype(np.float32)
    jhead = jax_dd3d.NuscenesDD3D(cfg=jcfg)
    # jitted, as the JAX package inits its models: op by op, the init
    # compiles each of its operations on its own
    init = jax.jit(lambda key, fs, ik, tg: jhead.init(key, fs, ik, tg, train=False))
    v = to_numpy_tree(init(jax.random.PRNGKey(1), [jnp.asarray(x) for x in feats],
                           jnp.asarray(inv_k), targets))
    perturb(v["params"], rng, names=("box3d_quat", "box3d_ctr", "box3d_size"), std=0.05)
    seed_batch_stats(v["batch_stats"], rng)
    head = dd3d.NuscenesDD3D(jcfg.embed_dims, jcfg.num_classes, 5)
    sd = dd3d_state_dict(v["params"], v["batch_stats"], 5, prefix="")
    keys = head.load_state_dict({k: t(x) for k, x in sd.items()}, strict=False)
    assert not keys.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in keys.missing_keys)
    tt = {k: t(np.asarray(x)) for k, x in targets.items()}
    for k in ("classes", "attributes", "num_gt"):
        tt[k] = tt[k].long()
    return jhead, v, head, feats, inv_k, targets, tt


@pytest.mark.parametrize("train", [True, False], ids=["train_bn", "eval_bn"])
def test_dd3d_losses_match_jax(train):
    jhead, v, head, feats, inv_k, targets, tt = _dd3d_pair()
    ref = jax.jit(lambda v, fs, ik, tg: jhead.apply(
        v, fs, ik, tg, train=train, mutable=["batch_stats"] if train else False))(
        v, [jnp.asarray(x) for x in feats], jnp.asarray(inv_k), targets)
    ref = ref[0] if train else ref
    head.train(train)
    ours = head([t(x).permute(0, 3, 1, 2) for x in feats], t(inv_k), tt)
    assert set(ours) == set(ref) and len(ours) == 10
    for key, val in ref.items():
        assert_close(ours[key], np.asarray(val), TOL, key)
    assert float(ours["loss_box2d_reg"].detach()) > 0 and float(ours["loss_box3d_depth"].detach()) > 0


def test_dd3d_assign_targets_matches_jax():
    _, _, _, feats, _, targets, tt = _dd3d_pair(seed=3)
    shapes = [x.shape[1:3] for x in feats]
    jlocs = jnp.concatenate(jax_dd3d.compute_locations(shapes), 0)
    sizes = [s[0] * s[1] for s in shapes]
    level = jnp.concatenate([jnp.full((m,), i, jnp.int32) for i, m in enumerate(sizes)])
    rng_ = jnp.array(jax_dd3d.SIZES_OF_INTEREST, jnp.float32)[level]
    ref = jax_dd3d._assign_targets(jlocs, level, rng_, targets, 10, 1.5)
    locs = torch.cat(dd3d.compute_locations(shapes, "cpu"), 0)
    np.testing.assert_array_equal(locs.numpy(), np.asarray(jlocs))
    ours = dd3d.assign_targets(locs, t(np.asarray(level)).long(), t(np.asarray(rng_)), tt, 10)
    assert set(ours) == set(ref)
    assert int(ours["pos"].sum()) > 20
    for key, val in ref.items():
        if ours[key].is_floating_point():
            np.testing.assert_allclose(ours[key].numpy(), np.asarray(val), rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(val), err_msg=key)


def test_quaternion_and_corner_helpers_match_jax():
    rng = np.random.RandomState(4)
    q = rng.randn(50, 4).astype(np.float32)
    m = rng.randn(50, 3, 3).astype(np.float32)
    m[:10] = np.asarray(jax_dd3d.quat_to_matrix(jnp.asarray(q[:10])))  # rotations too
    ctr = rng.uniform(0, 64, (50, 2)).astype(np.float32)
    inv_k = np.tile(np.linalg.inv([[40.0, 0, 32], [0, 40, 16], [0, 0, 1]])[None], (50, 1, 1))
    inv_k = inv_k.astype(np.float32)
    depth = rng.uniform(2, 50, 50).astype(np.float32)
    size = (np.abs(rng.randn(50, 3)) + 0.5).astype(np.float32)
    for name, ours, ref in (
        ("quat_to_matrix", dd3d.quat_to_matrix(t(q)), jax_dd3d.quat_to_matrix(jnp.asarray(q))),
        ("matrix_to_quat", dd3d.matrix_to_quat(t(m)), jax_dd3d.matrix_to_quat(jnp.asarray(m))),
        ("allocentric_to_egocentric", dd3d.allocentric_to_egocentric(t(q), t(ctr), t(inv_k)),
         jax_dd3d.allocentric_to_egocentric(jnp.asarray(q), jnp.asarray(ctr), jnp.asarray(inv_k))),
        ("boxes3d_corners", dd3d.boxes3d_corners(t(q), t(ctr), t(depth), t(size), t(inv_k)),
         jax_dd3d.boxes3d_corners(jnp.asarray(q), jnp.asarray(ctr), jnp.asarray(depth),
                                  jnp.asarray(size), jnp.asarray(inv_k))),
    ):
        assert_close(ours, np.asarray(ref), EXACT_TOL, name)


# ---------------------------------------------------------------- GroupDETR

def test_folded_group_attention_is_the_block_masked_attention():
    """Groups folded into the batch give the [G*Q, G*Q] block-diagonal
    masked attention (the JAX decoder's) of the same weights."""
    torch.manual_seed(0)
    mha = MultiheadAttention(16, 4).eval()
    q, g = 5, 3
    x, pos = torch.randn(2, g * q, 16), torch.randn(2, g * q, 16)
    folded = mha(x.reshape(2 * g, q, 16), pos.reshape(2 * g, q, 16)).reshape(2, g * q, 16)
    w, b = mha.attn.in_proj_weight, mha.attn.in_proj_bias
    qk = x + pos
    qq, kk = (torch.nn.functional.linear(qk, w[i * 16:(i + 1) * 16], b[i * 16:(i + 1) * 16])
              .view(2, g * q, 4, 4).transpose(1, 2) for i in range(2))
    vv = torch.nn.functional.linear(x, w[32:], b[32:]).view(2, g * q, 4, 4).transpose(1, 2)
    gid = torch.arange(g * q) // q
    logits = (qq @ kk.transpose(-1, -2)) / 2.0
    logits = logits.masked_fill(gid[:, None] != gid[None, :], float("-inf"))
    masked = x + mha.attn.out_proj((logits.softmax(-1) @ vv).transpose(1, 2).reshape(2, g * q, 16))
    assert_close(folded, masked, 1e-6, "folded vs masked")


@pytest.mark.parametrize("bbox_loss", ["smooth_l1", "l1"])
def test_group_detr_loss_matches_jax(bbox_loss):
    rng = np.random.RandomState(5)
    layers, q, g = 2, 12, 3
    preds = dict(all_cls_scores=rng.randn(layers, 1, g * q, 10).astype(np.float32),
                 all_bbox_preds=rng.randn(layers, 1, g * q, 10).astype(np.float32))
    gt = rng.randn(1, 8, 9).astype(np.float32) * 10
    gt[..., 3:6] = np.abs(gt[..., 3:6]) / 10 + 1
    labels = rng.randint(0, 10, (1, 8)).astype(np.int32)
    ngt = np.array([5], np.int32)
    kw = dict(group_detr=g, bbox_loss=bbox_loss, bbox_loss_weight=0.75)
    cw = (1.0,) * 8 + (0.2, 0.2)
    # one jitted call, blocked on (see the `runs` fixture)
    ref = jax.block_until_ready(jax.jit(lambda p, g, lab, n: jax_losses.bevformer_loss(
        p, g, lab, n, cw, num_query=q, **kw))(
        {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(gt), jnp.asarray(labels),
        jnp.asarray(ngt)))
    from bevformer_torch.core.assigner import assign_costs

    moved = assign_costs.transfers
    ours = losses.bevformer_loss({k: t(v) for k, v in preds.items()}, t(gt), t(labels).long(),
                                 t(ngt).long(), cw, **kw)
    assert assign_costs.transfers == moved + 1  # the 6 matches' costs in one copy
    assert set(ours) == set(ref)
    for key, val in ref.items():
        assert_close(ours[key], np.asarray(val), EXACT_TOL, key)


# ---------------------------------------------------------------- optimizer and weights

def test_optimizer_labels_match_jax(runs):
    """JAX's `label_params(bn_trainable=True)` with `frozen_stages=-1`: the
    backbone's convs and BN affines `backbone`, the DD3D head and the rest
    `main`, nothing frozen."""
    r = runs["t1"]
    codes = {"frozen": 0, "backbone": 1, "main": 2}
    jlabels = jax_optim.label_params(r["variables"]["params"], r["cfg"].optim.frozen_stages,
                                     bn_trainable=True)
    coded = jax.tree.map(lambda lbl, p: np.full(np.shape(p), codes[lbl], np.float32),
                         jlabels, r["variables"]["params"])
    ref = state_dict_from_jax_v2({"params": coded, "batch_stats": r["variables"]["batch_stats"]},
                                 r["jcfg"])
    ours = label_params(r["model"], r["cfg"].optim.frozen_stages)
    assert r["cfg"].optim.frozen_stages == -1
    for name, label in ours.items():
        assert np.all(ref[name] == codes[label]), (name, label)
    assert "frozen" not in ours.values()
    assert ours["fcos3d_bbox_head.fcos2d_head.cls_tower.0.norm.0.weight"] == "main"
    assert ours["img_backbone.bn1.weight"] == "backbone"


def test_reference_pth_with_the_dd3d_head_gives_the_mono_losses(runs, tmp_path):
    """JAX's `export_reference_state_dict_v2` of the t1 variables (the DD3D
    head's `fcos3d_bbox_head.*` keys, each BN's num_batches_tracked) loads
    whole through `load_reference_pth` and gives JAX's mono losses."""
    r = runs["t1"]
    sd = {k: torch.from_numpy(np.array(x)) for k, x in
          export_reference_state_dict_v2(r["variables"], r["jcfg"]).items()}
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    assert sum(k.startswith("fcos3d_bbox_head.") for k in sd) > 100
    path = tmp_path / "v2.pth"
    torch.save({"meta": {}, "state_dict": sd}, path)
    model = _deterministic(build_model(r["cfg"], load_reference_pth(str(path)), "cpu"))
    with torch.no_grad():
        _, terms = loss_fn_v2(model, r["batch"])
    mono = [k for k in r["jlosses"] if k.endswith("_mono")]
    assert len(mono) == 10
    for key in mono:
        assert_close(terms[key], r["jlosses"][key], TOL, key)


@pytest.mark.parametrize("name", ["bevformerv2-r50-t1", "bevformerv2-r50-t1-base",
                                  "bevformerv2-r50-t2", "bevformerv2-r50-t8"])
def test_trainer_takes_each_v2_preset(name):
    """Each V2 preset (cut to the mini size) trains: `Trainer` steps on a
    `BatchV2` with the V2 loss, the whole backbone and the DD3D head
    trainable."""
    from bevformer_torch.data.synth import train_batch_v2
    from bevformer_torch.runtime import init_state_dict

    base = get_config(name)
    cfg = base.replace(backbone_depth=10, bev_h=8, bev_w=8, encoder_layers=1, decoder_layers=1,
                       num_query=6, num_fusion=1, inter_channels=32,
                       data=dataclasses.replace(base.data, raw_size=(64, 128)))
    model = build_model(cfg, init_state_dict(cfg, seed=1), "cpu")
    trainer = Trainer(model, total_steps=10)
    assert trainer.loss is loss_fn_v2 and model.training
    assert all(p.requires_grad for p in model.parameters())
    out = trainer.step(train_batch_v2(cfg, seed=0, device="cpu", rung=cfg.data.raw_size[0]))
    assert all(np.isfinite(v) for v in out.values()), out
    assert sum(k.endswith("_mono") for k in out) == 10
    n_groups = cfg.group_detr
    assert model.pts_bbox_head.query_embedding.weight.shape[0] == cfg.num_query * n_groups


def test_training_call_sites_meet_the_kernel_contract(runs, monkeypatch):
    """Every msda call of a t2 training step (the history frame's encoder,
    the current frame's, the decoder over every group) hands K1 what its
    CUDA wrapper accepts; those of the current frame take a gradient (K3/K4
    in the step's backward)."""
    from bevformer_torch.kernels import msda
    from bevformer_torch.models import attention

    calls = []

    def checked(value, shapes, loc, attw):
        msda._check(value, tuple(shapes), loc, attw)
        calls.append((loc.shape[1], torch.is_grad_enabled()))
        return msda.ms_deform_attn_plain(value, shapes, loc, attw)

    monkeypatch.setattr(attention, "ms_deform_attn", checked)
    r = runs["t2"]
    loss_fn_v2(copy.deepcopy(r["model"]), r["batch"])[0].backward()
    c = r["cfg"]
    assert len(calls) == len(c.frames) * 2 * c.encoder_layers + c.decoder_layers
    assert sum(grad for _, grad in calls) == 2 * c.encoder_layers + c.decoder_layers
    assert calls[-1][0] == c.num_query * c.group_detr  # the decoder reads every group
