"""bfloat16 in the port (`device.precision("bfloat16")`, the config's
`dtype`, bevformer_tiny_fp16) against the JAX package's bf16 model, on the
CPU.

The port runs its model under bf16 autocast with fp32 parameters; the JAX
package runs `dtype=bfloat16` modules. The two round in different places
(autocast keeps some operations in fp32 that Flax runs in bf16), so they
are not held to each other at a fixed tolerance but to JAX's own bf16
rounding: on tiny_fp16's mini detector (pytorch-style R10, one level, dense
SCA, 16 x 16 BEV, 2 + 2 layers, 100 queries) with the same weights, for
each of bev_embed, cls and bbox of a 3-frame video (max abs error over
max |ref|, over the frames) and for the loss terms and each gradient group
of an eval-mode training step (||a - b|| / ||b||),

    rel_err(port bf16, JAX bf16) <= 2 x rel_err(JAX bf16, JAX fp32).

Each fp32 island the JAX package pins has a test that fails if it runs in
bf16: the sampling-offset and attention-weight projections, the reference
points, the head's last layers, `point_sampling`, the prev-BEV rotation and
the losses. `tools.fp16.train` and its `force_bf16_argv` (equal to the JAX
shim's on the same argvs) run the same training in bf16.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax

from bevformer_tpu.models import BEVFormer as JaxBEVFormer
from bevformer_torch.core import geometry
from bevformer_torch.data import SyntheticVideo, train_batch
from bevformer_torch.device import precision
from bevformer_torch.kernels import dcn, msda
from bevformer_torch.models import attention
from bevformer_torch.runtime import (
    VideoEvaluator,
    build_model,
    init_state_dict,
    label_params,
    loss_fn,
    state_dict_from_jax,
)
from bevformer_torch.runtime import train as train_mod
from bevformer_torch.tools import create_data
from bevformer_torch.tools.fp16 import train as fp16_train
from tests.test_torch_presets import mini
from tests.test_torch_slice import _NumpyFrames, _TracedJaxEvaluator
from tests.test_torch_train_step import jax_batch, jax_deterministic_loss, jax_params
from tests.torch_port_helpers import port_config, to_numpy_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTOR = 2.0
OUTPUTS = ("bev_embed", "all_cls_scores", "all_bbox_preds")
GROUPS = (("backbone", "img_backbone."), ("neck", "img_neck."),
          ("encoder", "pts_bbox_head.transformer.encoder."),
          ("decoder", "pts_bbox_head.transformer.decoder."), ("head", ""))


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _l2_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _grouped(grads: dict) -> dict:
    """Gradients (name -> array) concatenated per group of GROUPS."""
    out = {g: [] for g, _ in GROUPS}
    for name in sorted(grads):
        out[next(g for g, prefix in GROUPS if name.startswith(prefix))].append(
            np.asarray(grads[name], np.float64).reshape(-1))
    return {g: np.concatenate(v) for g, v in out.items()}


def _port_frames(model, video):
    preds = []
    hook = model.register_forward_hook(lambda m, i, out: preds.append(out))
    VideoEvaluator(model).run(video, progress_every=0)
    hook.remove()
    return [{k: p[k].float().numpy() for k in OUTPUTS} for p in preds]


def _port_step(model, batch, labels):
    """Loss terms and trainable gradients of an eval-mode step in the
    config's dtype (as `Trainer.step` computes them)."""
    model.zero_grad(set_to_none=True)
    with precision(model.cfg.dtype, "cpu"):
        total, losses = loss_fn(model.eval(), batch)
    total.backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
             if labels[n] != "frozen"}
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def bf16_runs(jcfg32, jcfg16) -> dict:
    """The JAX package's fp32 and bf16 models (`jcfg32`, `jcfg16`) and the
    port's bf16 one on the same weights: the frames of a 3-frame video with
    a scene reset, the loss terms and the trainable gradients of an
    eval-mode training step."""
    cfg = port_config(jcfg16)
    assert (jcfg16.dtype, cfg.dtype) == ("bfloat16", "bfloat16")
    video = SyntheticVideo(cfg, scene_lengths=(2, 1), seed=5, device="cpu")
    batch = train_batch(cfg, seed=6, device="cpu", scene_break_at=1)
    jb = jax_batch(batch)
    _, params = jax_params(jcfg32, jb, seed=3)

    out = {}
    for tag, jcfg in (("jax32", jcfg32), ("jax16", jcfg16)):
        jmodel = JaxBEVFormer(cfg=jcfg)
        jev = _TracedJaxEvaluator(jmodel, params)
        jev.run(_NumpyFrames(video), progress_every=0)
        # blocked on at once: JAX's matcher calls back into JAX from a host
        # callback, which can deadlock with JAX work dispatched meanwhile
        (_, (losses, _)), grads = jax.block_until_ready(jax.jit(jax.value_and_grad(
            lambda p: jax_deterministic_loss(jmodel, p, jb), has_aux=True))(params))
        out[tag] = dict(
            frames=[{k: np.asarray(t[k], np.float32) for k in OUTPUTS} for t in jev.trace],
            losses={k: float(v) for k, v in losses.items()},
            grads=state_dict_from_jax(to_numpy_tree(grads), jcfg))

    model = build_model(cfg, state_dict_from_jax(params, jcfg16), "cpu")
    labels = label_params(model, cfg.optim.frozen_stages)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    losses, grads = _port_step(model, batch, labels)
    out["port16"] = dict(frames=_port_frames(model, video), losses=losses, grads=grads)
    out["jax32"]["grads"] = {k: out["jax32"]["grads"][k] for k in grads}
    out["jax16"]["grads"] = {k: out["jax16"]["grads"][k] for k in grads}
    return out


@pytest.fixture(scope="module")
def runs():
    return bf16_runs(mini("bevformer_tiny"), mini("bevformer_tiny_fp16"))


def _within_jax_gap(name, ours, gap):
    print(f"{name}: rel_err(port bf16, JAX bf16) {ours:.3e}, "
          f"rel_err(JAX bf16, JAX fp32) {gap:.3e}, ratio {ours / max(gap, 1e-30):.2f}")
    assert ours <= FACTOR * gap, f"{name}: {ours:.3e} > {FACTOR:g} x {gap:.3e}"


def check_frames(runs, key):
    ours = max(_max_rel(p[key], j[key])
               for p, j in zip(runs["port16"]["frames"], runs["jax16"]["frames"]))
    gap = max(_max_rel(a[key], b[key])
              for a, b in zip(runs["jax16"]["frames"], runs["jax32"]["frames"]))
    _within_jax_gap(key, ours, gap)


def check_loss_terms(runs):
    ours, j16, j32 = (runs[k]["losses"] for k in ("port16", "jax16", "jax32"))
    assert set(ours) == set(j16)
    keys = sorted(j16)
    _within_jax_gap("loss terms", _l2_rel([ours[k] for k in keys], [j16[k] for k in keys]),
                    _l2_rel([j16[k] for k in keys], [j32[k] for k in keys]))


def check_gradients(runs, group):
    ours, j16, j32 = (_grouped(runs[k]["grads"])[group] for k in ("port16", "jax16", "jax32"))
    _within_jax_gap(f"{group} gradient", _l2_rel(ours, j16), _l2_rel(j16, j32))


@pytest.mark.parametrize("key", OUTPUTS)
def test_bf16_frames_within_jaxs_own_bf16_gap(runs, key):
    check_frames(runs, key)


def test_bf16_loss_terms_within_jaxs_own_bf16_gap(runs):
    check_loss_terms(runs)


@pytest.mark.parametrize("group", [g for g, _ in GROUPS])
def test_bf16_gradients_within_jaxs_own_bf16_gap(runs, group):
    check_gradients(runs, group)


# ---------------------------------------------------------------- fp32 islands

def _tiny_model(dtype="bfloat16"):
    cfg = port_config(mini("bevformer_tiny_fp16")).replace(dtype=dtype)
    return cfg, build_model(cfg, init_state_dict(cfg, seed=0), "cpu")


ISLANDS = {
    # island: (module name suffix, modules per model of the mini config)
    "sampling_offsets": (".sampling_offsets", 2 * 2 + 2),
    "attention_weights": (".attention_weights", 2 * 2 + 2),
    "reference_points": ("transformer.reference_points", 1),
    "cls_out": (".6", 2),  # cls_branches.{i}.6
    "reg_out": (".4", 2),  # reg_branches.{i}.4
}


@pytest.mark.parametrize("island", sorted(ISLANDS))
def test_projection_island_runs_fp32_under_bf16(island):
    """In a bf16 frame every module of the island gives an fp32 output
    equal, bitwise, to the fp32 product of its input (an nn.Linear there
    would give bf16). The head's last layers take a bf16 input, as JAX's
    fp32 Dense layers after bf16 ones do."""
    suffix, count = ISLANDS[island]
    cfg, model = _tiny_model()
    head = ("pts_bbox_head.cls_branches." if island == "cls_out" else
            "pts_bbox_head.reg_branches." if island == "reg_out" else "")
    seen = {}

    def check(name, mod, inputs, out):
        with torch.autocast("cpu", enabled=False):
            want = torch.nn.functional.linear(inputs[0].float(), mod.weight, mod.bias)
        seen.setdefault(name, []).append(out.dtype == torch.float32 and torch.equal(out, want))

    for name, mod in model.named_modules():
        if name.endswith(suffix) and name.startswith(head):
            mod.register_forward_hook(lambda m, i, o, name=name: check(name, m, i, o))
    VideoEvaluator(model).infer_frame(SyntheticVideo(cfg, (1,), seed=0, device="cpu")
                                      .get_test_sample(0))
    assert len(seen) == count, sorted(seen)
    for name, ok in seen.items():
        assert all(ok), (name, ok)


def test_point_sampling_island_is_fp32_under_bf16():
    """The same projections, bitwise, inside and outside bf16 autocast."""
    from bevformer_torch.data.synth import rig_lidar2img

    ref = geometry.reference_points_3d(16, 16, 8.0, 4)
    l2i = torch.from_numpy(rig_lidar2img(160, 96).astype(np.float32))[None]
    plain = geometry.point_sampling(ref, (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), l2i, (96, 160))
    with precision("bfloat16", "cpu"):
        ours = geometry.point_sampling(ref, (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), l2i,
                                       (96, 160))
    assert ours[0].dtype == torch.float32
    assert torch.equal(ours[0], plain[0]) and torch.equal(ours[1], plain[1])
    assert plain[1].any()


def test_prev_bev_rotation_island_is_fp32_under_bf16(monkeypatch):
    """In a bf16 training step the history's BEV (bf16 out of the encoder
    on the CPU) is rotated as fp32, with autocast off."""
    seen = []
    rotate = geometry.rotate_prev_bev

    def recording(prev_bev, *args):
        seen.append((prev_bev.dtype, torch.is_autocast_enabled("cpu")))
        return rotate(prev_bev, *args)

    monkeypatch.setattr(geometry, "rotate_prev_bev", recording)
    cfg, model = _tiny_model()
    with precision("bfloat16", "cpu"):
        loss_fn(model.eval(), train_batch(cfg, seed=0, device="cpu"))
    assert len(seen) == cfg.data.queue_length  # each history frame and the trained one
    assert all(s == (torch.float32, False) for s in seen), seen


def test_loss_island_is_fp32_under_bf16(monkeypatch):
    """The losses run with autocast off, on fp32 scores and boxes."""
    seen = []
    loss = train_mod.bevformer_loss

    def recording(preds, *args, **kw):
        seen.append((torch.is_autocast_enabled("cpu"), preds["all_cls_scores"].dtype,
                     preds["all_bbox_preds"].dtype))
        return loss(preds, *args, **kw)

    monkeypatch.setattr(train_mod, "bevformer_loss", recording)
    cfg, model = _tiny_model()
    with precision("bfloat16", "cpu"):
        total, _ = loss_fn(model.eval(), train_batch(cfg, seed=0, device="cpu"))
    assert seen == [(False, torch.float32, torch.float32)] and total.dtype == torch.float32


def test_bf16_call_sites_meet_the_kernel_contract(monkeypatch):
    """Every msda call of a bf16 frame and of a bf16 training step hands
    the kernels what their CUDA wrappers accept: a bf16 value, fp32
    locations and weights, all contiguous, and a bf16 grad_out (checked
    with the wrappers' own checks in front of the plain versions, through
    the kernels' autograd Function)."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd_checked(value, shapes, loc, attw):
        msda._check(value, tuple(shapes), loc, attw, (torch.bfloat16,))
        calls["fwd"] += 1
        return msda.ms_deform_attn_plain(value, shapes, loc, attw)

    def bwd_checked(value, shapes, loc, attw, grad_out):
        msda._check(value, tuple(shapes), loc, attw, (torch.bfloat16,))
        msda._check_grad(value, loc, grad_out)
        calls["bwd"] += 1
        return msda.ms_deform_attn_backward_plain(value, shapes, loc, attw, grad_out)

    monkeypatch.setattr(msda, "_launch_fwd", fwd_checked)
    monkeypatch.setattr(msda, "ms_deform_attn_backward", bwd_checked)
    monkeypatch.setattr(attention, "ms_deform_attn", lambda v, s, loc, w: msda._MSDeformAttn.apply(
        v, loc, w, tuple((int(h), int(ww)) for h, ww in s)))
    cfg, model = _tiny_model()
    VideoEvaluator(model).infer_frame(SyntheticVideo(cfg, (1,), seed=1, device="cpu")
                                      .get_test_sample(0))
    per_frame = 2 * cfg.encoder_layers + cfg.decoder_layers
    assert calls == dict(fwd=per_frame, bwd=0)
    calls.update(fwd=0, bwd=0)
    from bevformer_torch.runtime import Trainer

    out = Trainer(model, total_steps=10).step(train_batch(cfg, seed=2, device="cpu"))
    assert all(np.isfinite(v) for v in out.values()), out
    history = (cfg.data.queue_length - 1) * 2 * cfg.encoder_layers
    assert calls == dict(fwd=history + per_frame, bwd=per_frame)


def test_dcn_refuses_bf16():
    """bf16 with DCN stages runs the bf16 DCN (a bf16 x; the bf16 K2, K5
    and K6 on the card), and a bf16 DCN frame gives finite outputs; the
    wrappers refuse bf16 wherever their kernels take fp32: the offsets,
    the mask, the weight and the column gradient."""
    cfg = port_config(mini("bevformer_small")).replace(dtype="bfloat16")
    model = build_model(cfg, init_state_dict(cfg, seed=0), "cpu")
    sample = SyntheticVideo(cfg, (1,), seed=0, device="cpu").get_test_sample(0)
    out = VideoEvaluator(model).infer_frame(sample)
    assert np.isfinite(np.asarray(out["scores_3d"])).all()

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 4, 5, 32).astype(np.float32)).bfloat16()
    off_y, off_x = (torch.from_numpy(rng.randn(1, 4, 5, 9).astype(np.float32)) for _ in "yx")
    mask = torch.rand(1, 4, 5, 9)
    weight = torch.randn(9 * 32, 16)
    dcn._check(x, off_y, off_x, mask, weight, 1)
    for bad in range(4):
        args = [x, off_y, off_x, mask, weight]
        args[1 + bad] = args[1 + bad].bfloat16()
        with pytest.raises(TypeError, match="must be torch.float32"):
            dcn._check(*args, 1)
    with pytest.raises(TypeError, match="dcols must be torch.float32"):
        dcn._check_tensor("dcols", torch.zeros(20, 9 * 32, dtype=torch.bfloat16), x.device)


# ---------------------------------------------------------------- tools.fp16.train

def _jax_shim():
    spec = importlib.util.spec_from_file_location(
        "jax_fp16_train_shim", os.path.join(ROOT, "tools", "fp16", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    [],
    ["bevformer_tiny", "--data-root", "d"],
    ["bevformer_tiny", "--cfg-options", "bev_h=16", "bev_w=16", "--max-iters", "2"],
    ["bevformer_tiny", "--max-iters", "2", "--cfg-options"],
    ["bevformer_tiny", "--cfg-options", "dtype=float32"],
])
def test_force_bf16_argv_equals_the_jax_shims(argv):
    assert fp16_train.force_bf16_argv(argv) == _jax_shim().force_bf16_argv(argv)
    assert fp16_train.force_bf16_argv(argv) != argv


def test_fp16_train_runs_tiny_in_bf16(tmp_path, monkeypatch):
    """`tools.fp16.train` at tiny's mini size on a synthetic root: one step
    inside bf16 autocast, finite, its config's overrides led by
    dtype=bfloat16, the checkpoint's parameters fp32."""
    data, work = str(tmp_path / "data"), str(tmp_path / "work")
    create_data.main(["synth", "--out-dir", data, "--scenes", "2", "--frames", "2",
                      "--img-w", "320", "--img-h", "192"])
    autocast = []
    step = train_mod.train_step

    def recording(*args):
        autocast.append(torch.is_autocast_enabled("cpu"))
        return step(*args)

    monkeypatch.setattr(train_mod, "train_step", recording)
    opts = ["backbone_depth=10", "bev_h=16", "bev_w=16", "encoder_layers=2",
            "decoder_layers=2", "num_query=100", "data.raw_size=(192,320)"]
    done = fp16_train.main(["bevformer_tiny", "--data-root", data, "--work-dir", work,
                            "--max-iters", "1", "--device", "cpu", "--cfg-options", *opts])
    assert done["steps"] == 1 and np.isfinite(done["last"]["total"]) and autocast == [True]
    with open(os.path.join(work, "config.json")) as f:
        assert json.load(f)["overrides"][0] == "dtype=bfloat16"
    ckpt = torch.load(os.path.join(work, "ckpts", "iter_1.pth"), weights_only=True)
    assert all(v.dtype == torch.float32 for v in ckpt["state_dict"].values()
               if v.is_floating_point())
