"""Data-parallel training and evaluation of the port over ranks, on the CPU:
`torchrun` launches of gloo processes that import no JAX, held against the
JAX package, which computes the same step over the global batch.

* v1 (a bevformer_base-shaped mini detector: R10 with DCN, 8 x 8 BEV,
  1 + 2 layers, 30 queries) and V2 t1 (the mini V2 of
  `tests/test_torch_v2_train.py`: R10 with BatchNorm, the DD3D head,
  GroupDETR's 3 groups): two ranks step one sample each
  (`bevformer_torch.tools.dp_step`: `Trainer.step` under DDP) and JAX steps
  both samples as one batch (its loss, `value_and_grad` and optax's AdamW,
  jitted and blocked on: the matcher calls back into JAX). The samples
  hold unequal ground-truth counts (3 and 9; V2 3 and 5), so a per-rank
  normaliser would move every loss term and gradient. Dropout and GridMask
  are off on both sides (the port: every dropout at p = 0; JAX:
  `training=False` for v1, `flax.linen.Dropout` the identity for V2).
  Compared: the loss terms, the grad norm, each gradient, the parameters
  after AdamW where the gradient's sign is resolved, and V2's BatchNorm
  running statistics (torch's unbiased variance over the global count).
* `SyncBatchNorm2d` on two ranks equals `nn.BatchNorm2d` on the
  concatenated batch; alone it is `nn.BatchNorm2d`, bitwise.
* `allgather_results` on three ranks (ragged counts, chunk boundaries)
  gives every rank the rank-order concatenation.
* `tools.train --device cpu` on two ranks through `tools/dist_train.sh`:
  two steps, a checkpoint with both ranks' generators, a resume; a `--dp`
  and `--sp` whose product is not the world size raise.
* `tools.test` on two ranks through `tools/dist_test.sh` equals one
  process where the split falls on a scene start.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import flax.linen.normalization as flax_normalization
import jax
import jax.numpy as jnp
import optax

from bevformer_tpu.configs import DataConfig as JaxData
from bevformer_tpu.models.detector_v2 import BEVFormerV2 as JaxBEVFormerV2
from bevformer_tpu.runtime import optim as jax_optim
from bevformer_tpu.runtime import train_v2 as jax_train_v2
from bevformer_torch.configs import apply_overrides, get_config
from bevformer_torch.data import train_batch
from bevformer_torch.models.layers import SyncBatchNorm2d
from bevformer_torch.runtime import (
    Batch,
    distributed,
    label_params,
    parallel,
    init_state_dict,
    state_dict_from_jax,
    state_dict_from_jax_v2,
)
from bevformer_torch.tools import create_data, test as test_cli, train as train_cli
from tests import torch_dist_worker
from tests.test_torch_train_step import JCFG as TRAIN_STEP_CFG
from tests.test_torch_train_step import jax_batch, jax_deterministic_loss, jax_params
from tests.test_torch_v2 import seed_batch_stats
from tests.test_torch_v2_train import (
    JCFGS,
    _jax_batch,
    _merge_forward_and_mono_stats,
    _NoTx,
    _numpy_batch,
    _port_batch,
    _two_pass_stats,
)
from tests.torch_port_helpers import assert_close, perturb, port_config, to_numpy_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-3  # v1: `tests/test_torch_train_step.py`'s
V2_TOL = 1e-4  # V2: `tests/test_torch_v2_train.py`'s loss terms
V2_GRAD_CAP = 0.1  # ... and its cap on a gradient behind a train-mode BatchNorm
EXACT_TOL = 1e-5  # running statistics
ZERO_TOL = 1e-10  # a gradient zero in exact arithmetic: norm within this of the global norm
SIGN_RESOLVED = 1e-5  # a clipped gradient element at 1e3 x Adam's epsilon
LAUNCH_TIMEOUT = 300
TOTAL_STEPS = 100
JCFG = TRAIN_STEP_CFG.replace(name="mini_dp", bev_h=8, bev_w=8, encoder_layers=1, num_query=30,
                              data=JaxData(raw_size=(96, 160), queue_length=2))
GT_COUNTS = (3, 9)
V2_GT_COUNTS = (3, 5)
MINI_CLI = ["backbone_depth=10", "bev_h=8", "bev_w=8", "encoder_layers=1", "decoder_layers=2",
            "num_query=20", "data.raw_size=(96,160)"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)


class Launch:
    """A launch running in the background, its output in a file."""

    def __init__(self, cmd, log, env=None):
        self.log = str(log)
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env or _env(), stdout=f,
                                         stderr=subprocess.STDOUT)

    def finish(self) -> str:
        """Its output, once it has exited 0."""
        self.proc.wait(timeout=LAUNCH_TIMEOUT)
        with open(self.log) as f:
            out = f.read()
        assert self.proc.returncode == 0, out[-6000:]
        return out


def torchrun(log, nproc: int, *args) -> Launch:
    """`torchrun --nproc-per-node nproc args` from the repo's root, its
    workers on one thread each."""
    return Launch([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                   str(nproc), "--master-addr", "localhost", "--master-port", str(free_port()),
                   *args], log)


def launcher(log, script: str, nproc: int, *args) -> Launch:
    """`bevformer_torch/tools/<script>` with NPROC ranks."""
    env = dict(_env(), NPROC=str(nproc), PORT=str(free_port()), PYTHON=sys.executable)
    return Launch(["bash", os.path.join(ROOT, "bevformer_torch", "tools", script), *args],
                  log, env)


def with_gt_count(batch, n: int):
    """`batch` (one sample) with only its first n ground-truth boxes."""
    boxes, labels = batch.gt_boxes.clone(), batch.gt_labels.clone()
    boxes[:, n:] = 0
    labels[:, n:] = 0
    return batch._replace(gt_boxes=boxes, gt_labels=labels,
                          num_gt=torch.full_like(batch.num_gt, n))


def concat(samples):
    return Batch(*[torch.cat(ts) for ts in zip(*samples)])


def write_spec(path, cfg, state_dict, batch):
    torch.save(dict(cfg=cfg, state_dict=state_dict, batch=batch, steps=1,
                    total_steps=TOTAL_STEPS), path)


def unclipped(grads, grad_norm, max_norm):
    """The gradients before `clip_grad_norm_` scaled them."""
    coef = min(1.0, max_norm / (grad_norm + 1e-6))
    return {k: v / coef for k, v in grads.items()}


def adamw_close(name, ours, ref, before, grad, jgrad, clip, lr):
    """The parameters after one AdamW step. Adam's first step moves an
    element by lr g / (|g| + 1e-8), g the clipped gradient: where the two
    gradients agree in sign and exceed SIGN_RESOLVED once clipped (`clip`,
    the smaller clip factor), the two steps agree to SIGN_RESOLVED's 1e-3 of
    lr and float32 rounding; everywhere within the step's bound (2 lr, and
    the decay)."""
    ours, ref, before, g, jg = (np.asarray(a, np.float64)
                                for a in (ours, ref, before, grad, jgrad))
    resolved = (np.sign(g) == np.sign(jg)) & (np.minimum(np.abs(g), np.abs(jg)) * clip
                                              >= SIGN_RESOLVED)
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    err = np.abs(ours - ref)
    assert np.all(err[resolved] <= 4 * ulp[resolved] + 2e-3 * lr), (name, err[resolved].max())
    assert np.all(err <= 4 * ulp + 2.1 * lr * (1 + np.abs(before))), (name, err.max())
    return resolved.mean()


@pytest.fixture(scope="module")
def v1_runs(tmp_path_factory, jobs):
    tmp = tmp_path_factory.mktemp("dp_v1")
    cfg = port_config(JCFG)
    samples = [with_gt_count(train_batch(cfg, seed=s, device="cpu"), n)
               for s, n in zip((6, 7), GT_COUNTS)]
    batch = concat(samples)
    jb = jax_batch(batch)
    jmodel, params = jax_params(JCFG, jax_batch(samples[0]), seed=3)
    write_spec(tmp / "spec.pt", cfg, state_dict_from_jax(params, JCFG), batch)
    job = torchrun(tmp / "log", 2, "-m", "bevformer_torch.tools.dp_step", str(tmp / "spec.pt"),
                   str(tmp / "out.pt"), "--device", "cpu")
    tx, sched = jax_optim.make_optimizer(JCFG.optim, params, TOTAL_STEPS)

    def step(p):
        (_, (losses, _)), grads = jax.value_and_grad(
            lambda q: jax_deterministic_loss(jmodel, q, jb), has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return losses, grads, optax.apply_updates(p, updates)

    # blocked on at once: JAX's matcher calls back into JAX from a host
    # callback, which can deadlock with JAX work dispatched meanwhile
    jlosses, jgrads, stepped = jax.block_until_ready(jax.jit(step)(params))
    job.finish()
    out = torch.load(tmp / "out.pt", weights_only=False)
    return dict(cfg=cfg, out=out, before=state_dict_from_jax(params, JCFG),
                jnorm_all=float(optax.global_norm(jgrads)),
                jlosses=jax.tree.map(np.asarray, jlosses),
                jgrads=state_dict_from_jax(to_numpy_tree(jgrads), JCFG),
                jstepped=state_dict_from_jax(to_numpy_tree(stepped), JCFG),
                lr=float(sched(0)))


@contextlib.contextmanager
def _jax_v2_patches():
    """Dropout off, JAX's statistics merge repaired, Flax's two-pass
    variance (`tests/test_torch_v2_train.py`'s patches)."""
    patch = pytest.MonkeyPatch()
    patch.setattr(flax_nn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    patch.setattr(jax_train_v2, "_merge_stats", _merge_forward_and_mono_stats)
    patch.setattr(flax_normalization, "_compute_stats", _two_pass_stats)
    try:
        yield
    finally:
        patch.undo()


def _v2_sample(jcfg, seed, n):
    b = _numpy_batch(jcfg, seed=seed)
    b["num_gt"] = np.array([n], np.int32)
    b["gt_boxes"][:, n:] = 0
    b["gt_labels"][:, n:] = 0
    return b


@pytest.fixture(scope="module")
def v2_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_v2")
    jcfg = JCFGS["t1"]
    cfg = port_config(jcfg)
    parts = [_v2_sample(jcfg, s, n) for s, n in zip((2, 3), V2_GT_COUNTS)]
    b = {k: (np.concatenate([p[k] for p in parts]) if k != "mono_targets" else
             {t: np.concatenate([p[k][t] for p in parts]) for t in parts[0][k]})
         for k in parts[0]}
    rng = np.random.RandomState(1)
    with _jax_v2_patches():
        jmodel = JaxBEVFormerV2(cfg=jcfg)
        state = jax_train_v2.init_state_v2(jmodel, _NoTx(), jax.random.PRNGKey(0),
                                           _jax_batch(parts[0]))
        params = perturb(to_numpy_tree(state.params), rng,
                         names=("sampling_offsets", "attention_weights"), std=0.02)
        stats = to_numpy_tree(state.batch_stats)
        seed_batch_stats(stats, rng)
        variables = {"params": params, "batch_stats": stats}
        batch = _port_batch(b)
        write_spec(tmp / "spec.pt", cfg, state_dict_from_jax_v2(variables, jcfg), batch)
        job = torchrun(tmp / "log", 2, "-m", "bevformer_torch.tools.dp_step",
                       str(tmp / "spec.pt"), str(tmp / "out.pt"), "--device", "cpu")
        p0 = jax.tree.map(jnp.asarray, params)
        tx, sched = jax_optim.make_optimizer(jcfg.optim, p0, TOTAL_STEPS, bn_trainable=True)
        jb = _jax_batch(b)

        def step(p):
            (_, (losses, new_stats)), grads = jax.value_and_grad(
                lambda q: jax_train_v2.loss_fn(jmodel, q, stats, jb, jax.random.PRNGKey(5)),
                has_aux=True)(p)
            updates, _ = tx.update(grads, tx.init(p), p)
            return losses, new_stats, grads, optax.apply_updates(p, updates)

        jlosses, new_stats, jgrads, stepped = jax.block_until_ready(jax.jit(step)(p0))
    job.finish()
    out = torch.load(tmp / "out.pt", weights_only=False)

    def bridged(tree, stats_tree=stats):
        return state_dict_from_jax_v2({"params": to_numpy_tree(tree),
                                       "batch_stats": to_numpy_tree(stats_tree)}, jcfg)

    return dict(cfg=cfg, out=out, before=bridged(params), jnorm_all=float(optax.global_norm(jgrads)),
                jlosses=jax.tree.map(np.asarray, jlosses), jgrads=bridged(jgrads),
                jstepped=bridged(stepped), jstats=bridged(params, new_stats),
                lr=float(sched(0)), batch=batch)


def _trained(cfg, state_dict):
    """Names of the parameters the optimizer trains."""
    from bevformer_torch.runtime import build_model

    model = build_model(cfg, state_dict, "cpu")
    labels = label_params(model, cfg.optim.frozen_stages)
    return [n for n, _ in model.named_parameters() if labels[n] != "frozen"]


def _check_step(r, loss_tol, grad_check, world=2):
    out, cfg = r["out"], r["cfg"]
    assert out["world"] == world
    losses = out["outs"][0]
    assert set(r["jlosses"]) <= set(losses)
    for key, ref in r["jlosses"].items():
        assert_close(torch.tensor(losses[key]), ref, loss_tol, key)
    names = _trained(cfg, r["before"])
    assert set(out["grads"]) == set(names)
    want = float(np.sqrt(sum(float((r["jgrads"][n].astype(np.float64) ** 2).sum())
                             for n in names)))
    assert losses["grad_norm"] == pytest.approx(want, rel=1e-3)
    grads = unclipped(out["grads"], losses["grad_norm"], cfg.optim.grad_clip_norm)
    for n in names:
        grad_check(n, grads[n], r["jgrads"][n])
    clip = min(1.0, cfg.optim.grad_clip_norm / max(losses["grad_norm"], r["jnorm_all"]))
    resolved = []
    for n in names:
        lr = r["lr"] * (cfg.optim.backbone_lr_mult if n.startswith("img_backbone.") else 1.0)
        resolved.append(adamw_close(n, out["states"][-1][n].numpy(), r["jstepped"][n],
                                    r["before"][n], grads[n], r["jgrads"][n], clip, lr))
    assert np.mean(resolved) > 0.5, np.mean(resolved)


def test_v1_step_over_two_ranks_equals_jax_global_batch(v1_runs):
    def grad_check(name, ours, ref):
        assert_close(ours, ref, TOL, name)

    _check_step(v1_runs, TOL, grad_check)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_v2_step_over_two_ranks_equals_jax_global_batch(v2_runs):
    """As the v1 test, at `tests/test_torch_v2_train.py`'s tolerances: its
    loss terms, and each gradient within its cap in relative L2 norm (a
    ReLU input behind a train-mode BatchNorm can sit within rounding of 0;
    that file holds each to a noisy witness). The norm of all gradients
    to 1e-3."""
    r = v2_runs
    norm = r["out"]["outs"][0]["grad_norm"]

    def grad_check(name, ours, ref):
        # the last FPN level's conv bias is zero in exact arithmetic (DD3D's
        # tower BatchNorm removes its shift whole): rounding on both sides
        if max(float(ours.norm()), float(np.linalg.norm(ref))) <= ZERO_TOL * norm:
            return
        assert _rel_l2(ours, ref) <= V2_GRAD_CAP, (name, _rel_l2(ours, ref))

    _check_step(r, V2_TOL, grad_check)
    assert any(k.endswith("_mono") for k in r["out"]["outs"][0])


def test_v2_running_statistics_over_two_ranks(v2_runs):
    """Each BatchNorm's running statistics after the step equal JAX's over
    the global batch, with torch's unbiased variance over the global
    count n (Flax's is biased: see `tests/test_torch_v2_train.py`)."""
    _check_running_statistics(v2_runs)


def _check_running_statistics(r):
    from bevformer_torch.runtime import build_model

    model = build_model(r["cfg"], r["before"], "cpu")
    counts = {}

    def count(name, x):
        counts[name] = x.numel() // x.shape[1]

    hooks = [m.register_forward_hook(lambda m, i, o, name=name: count(name, i[0]))
             for name, m in model.named_modules() if isinstance(m, SyncBatchNorm2d)]
    with torch.no_grad():
        from bevformer_torch.runtime import loss_fn_v2
        loss_fn_v2(model.train(), r["batch"])
    for h in hooks:
        h.remove()
    ours, old = r["out"]["states"][-1], r["before"]
    assert len(counts) == sum(isinstance(m, SyncBatchNorm2d) for m in model.modules())
    for name, n in counts.items():
        assert_close(ours[f"{name}.running_mean"], r["jstats"][f"{name}.running_mean"],
                     EXACT_TOL, name)
        prev = np.asarray(old[f"{name}.running_var"], np.float64)
        batch_var = (r["jstats"][f"{name}.running_var"].astype(np.float64) - 0.9 * prev) / 0.1
        assert_close(ours[f"{name}.running_var"], 0.9 * prev + 0.1 * batch_var * n / (n - 1),
                     EXACT_TOL, name)
        assert int(ours[f"{name}.num_batches_tracked"]) == 1


def test_sync_batch_norm_over_two_ranks_equals_batch_norm(jobs):
    jobs["sync_bn"].finish()
    ranks = torch.load(jobs["dir"] / "sync_bn.pt", weights_only=False)
    x, g, weight, bias, mean, var = torch_dist_worker.bn_inputs(2)
    bn = torch.nn.BatchNorm2d(torch_dist_worker.CHANNELS)
    with torch.no_grad():
        for p, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var),
                        (weight, bias, mean, var)):
            p.copy_(v)
    xg = x.clone().requires_grad_(True)
    y = bn.train()(xg)
    (y * g).sum().backward()
    assert_close(torch.cat([r["y"] for r in ranks]), y, 1e-5, "y")
    assert_close(torch.cat([r["dx"] for r in ranks]), xg.grad, 1e-5, "dx")
    # each rank's affine gradient is its own samples' (DDP sums them)
    assert_close(sum(r["dweight"] for r in ranks), bn.weight.grad, 1e-5, "dweight")
    assert_close(sum(r["dbias"] for r in ranks), bn.bias.grad, 1e-5, "dbias")
    for r in ranks:
        assert set(r) - {"y", "dx", "dweight", "dbias"} == set(bn.state_dict())
        for k in ("running_mean", "running_var"):
            assert_close(r[k], bn.state_dict()[k], 1e-6, k)
        assert int(r["num_batches_tracked"]) == 1


def test_sync_batch_norm_alone_is_batch_norm():
    """Without a process group: nn.BatchNorm2d's outputs, gradients and
    statistics bitwise, and its state-dict keys."""
    x, g, weight, bias, mean, var = torch_dist_worker.bn_inputs(2)
    runs = []
    for cls in (torch.nn.BatchNorm2d, SyncBatchNorm2d):
        bn = cls(torch_dist_worker.CHANNELS)
        with torch.no_grad():
            for p, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var),
                            (weight, bias, mean, var)):
                p.copy_(v)
        xg = x.clone().requires_grad_(True)
        y = bn.train()(xg)
        (y * g).sum().backward()
        runs.append(dict(y=y, dx=xg.grad, dw=bn.weight.grad, db=bn.bias.grad,
                         eval=bn.eval()(x), **bn.state_dict()))
    assert not distributed.initialized()
    assert list(runs[0]) == list(runs[1])
    for k, v in runs[0].items():
        assert torch.equal(v, runs[1][k]), k


def test_allgather_results_over_three_ranks(jobs):
    jobs["allgather"].finish()
    by_rank = torch.load(jobs["dir"] / "allgather.pt", weights_only=False)
    want = [a for r in range(3) for a in torch_dist_worker.ragged_results(r)]
    assert len(want) == 1 + 3 + 5 and any(a.shape[0] == 0 for a in want)
    for got in by_rank:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_mesh_sizes_are_checked():
    assert parallel.check_mesh(None, 1) == 1 and parallel.check_mesh(1, 1) == 1
    with pytest.raises(ValueError, match="--dp 2 with 1 rank"):
        parallel.check_mesh(2, 1)
    with pytest.raises(ValueError, match="--sp 2 does not divide the 1 rank"):
        parallel.check_mesh(None, 2)
    with pytest.raises(ValueError, match="--dp 2 with 1 rank"):
        train_cli.main(["bevformer_base", "--data-root", "unused", "--dp", "2", "--device", "cpu"])


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The launches that need no JAX result, started together before the
    JAX computations: the synced BatchNorm (2 ranks), the gather (3),
    `tools.test` (2) and `tools.train` (2) on a root of 4 scenes x 2 frames
    at 160 x 96 (2 train scenes, 2 val scenes: a two-rank split of the val
    frames falls on a scene start)."""
    tmp = tmp_path_factory.mktemp("dp_jobs")
    root = str(tmp / "root")
    create_data.main(["synth", "--out-dir", root, "--scenes", "4", "--frames", "2",
                      "--img-w", "160", "--img-h", "96"])
    out = dict(dir=tmp, root=root, work=str(tmp / "work"), ckpt=str(tmp / "w.pth"),
               two=str(tmp / "two" / "r.json"), one=str(tmp / "one" / "r.json"))
    for case, n in (("sync_bn", 2), ("allgather", 3)):
        out[case] = torchrun(tmp / f"{case}.log", n, os.path.join("tests", "torch_dist_worker.py"),
                             case, str(tmp / f"{case}.pt"))
    cfg = apply_overrides(get_config("bevformer_base"), dict(kv.split("=", 1) for kv in MINI_CLI))
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               init_state_dict(cfg, seed=4).items()}}, out["ckpt"])
    for path in (out["two"], out["one"]):
        os.makedirs(os.path.dirname(path))
    out["test_args"] = ["bevformer_base", "--data-root", root, "--checkpoint", out["ckpt"],
                        "--device", "cpu", "--cfg-options", *MINI_CLI]
    out["test"] = launcher(tmp / "test.log", "dist_test.sh", 2, *out["test_args"],
                           "--out", out["two"])
    out["train_args"] = ["bevformer_base", "--data-root", root, "--work-dir", out["work"],
                         "--log-interval", "1", "--device", "cpu", "--cfg-options", *MINI_CLI]
    out["train"] = launcher(tmp / "train.log", "dist_train.sh", 2, *out["train_args"],
                            "--max-iters", "2")
    return out


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_tools_train_over_two_ranks_saves_and_resumes(jobs):
    work, common = jobs["work"], jobs["train_args"]
    first = _json_lines(jobs["train"].finish())
    steps = [r for r in first if "step_ms" in r and "done" not in r]
    done = [r for r in first if "done" in r]
    # rank 0 alone prints: 4 train samples, 2 a step, 2 steps an epoch
    assert [r["step"] for r in steps] == [0, 1] and len(done) == 1 and done[0]["dp"] == 2
    assert all(np.isfinite(r["total"]) and np.isfinite(r["grad_norm"]) for r in steps)
    ckpt_path = os.path.join(work, "ckpts", "iter_2.pth")
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    assert ckpt["step"] == 2 and len(ckpt["rng_by_rank"]) == 2
    assert torch.equal(ckpt["rng_by_rank"][0]["torch_cpu"], ckpt["rng"]["torch_cpu"])
    assert not torch.equal(ckpt["rng_by_rank"][0]["grid_mask"], ckpt["rng_by_rank"][1]["grid_mask"])
    with open(os.path.join(work, "train_log.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1]

    second = _json_lines(launcher(jobs["dir"] / "resume.log", "dist_train.sh", 2, *common,
                                  "--max-iters", "3", "--resume-from", ckpt_path).finish())
    resumed = [r for r in second if "resumed_from" in r]
    assert len(resumed) == 1 and resumed[0]["step"] == 2
    assert resumed[0]["rng"] == train_cli.rng_digests(ckpt["rng"])
    assert [r["step"] for r in second if "step_ms" in r and "done" not in r] == [2]


def test_a_checkpoint_of_two_ranks_does_not_resume_on_one(jobs):
    from bevformer_torch.runtime import Trainer, build_model

    jobs["train"].finish()
    ckpt = torch.load(os.path.join(jobs["work"], "ckpts", "iter_2.pth"), map_location="cpu",
                      weights_only=True)
    cfg = apply_overrides(get_config("bevformer_base"), dict(kv.split("=", 1) for kv in MINI_CLI))
    trainer = Trainer(build_model(cfg, ckpt["state_dict"], "cpu"), total_steps=10)
    with pytest.raises(ValueError, match="saved by 2 rank"):
        trainer.load_state_dict(ckpt)


def test_tools_test_over_two_ranks_equals_one(jobs):
    lines = _json_lines(jobs["test"].finish())
    timing = [r for r in lines if "frame_ms" in r]
    assert len(timing) == 1 and timing[0]["ranks"] == 2 and timing[0]["frames"] == 2
    summary = test_cli.main([*jobs["test_args"], "--out", jobs["one"]])
    with open(jobs["two"]) as f:
        ours = json.load(f)
    with open(jobs["one"]) as f:
        ref = json.load(f)
    assert [r["token"] for r in ours] == [r["token"] for r in ref] and len(ref) == 4
    for a, b in zip(ours, ref):
        assert len(b["boxes_3d"]) > 0
        for k in ("boxes_3d", "scores_3d", "labels_3d"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    with open(os.path.join(os.path.dirname(jobs["two"]), "metrics_summary.json")) as f:
        metrics = json.load(f)
    assert metrics["nd_score"] == summary["NDS"]


def test_dp_step_splits_a_v2_batch_by_sample(v2_runs):
    """`dp_step.rank_share`: each rank's samples and their DD3D targets
    (one row per camera image)."""
    from bevformer_torch.tools.dp_step import rank_share

    batch = v2_runs["batch"]
    cams = batch.images.shape[2]
    parts = [rank_share(batch, r, 2) for r in range(2)]
    for r, part in enumerate(parts):
        assert torch.equal(part.images, batch.images[r:r + 1])
        for k, v in part.mono_targets.items():
            assert torch.equal(v, batch.mono_targets[k][r * cams:(r + 1) * cams]), k
    with pytest.raises(ValueError, match="does not split"):
        rank_share(batch, 0, 3)
