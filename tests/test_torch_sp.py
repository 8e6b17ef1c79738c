"""The `sp` axis of the port on the CPU: the encoder's BEV queries split over
gloo ranks launched by `torchrun`, held against one process and against
the JAX package's step on the same `(dp, sp)` mesh of virtual devices.

* The encoder alone (`tests/torch_dist_worker.py`'s `sp_encoder`: 2 layers,
  31 x 33 BEV queries, an odd count) on two ranks against one process:
  the BEV, and the gradients averaged over the ranks (DDP's mean), to 1e-5
  of their scale; with SCA's capacity routing dropping visible queries and
  routing fillers, with `use_remat`, and dense. Each rank's msda calls
  cover its range only: TSA its queries, SCA its packed routed rows.
* One training step through `tools.dp_step` at `--dp 1 --sp 2` and `--dp 2
  --sp 2` (v1, a bevformer_base-shaped mini detector at 7 x 9 BEV queries
  and 2 encoder layers, two samples of 3 and 9 GT boxes), and V2 t1 at
  `--dp 2 --sp 2` (the running statistics too), against JAX's
  `make_train_step` / `make_train_step_v2` jitted on `make_mesh(dp, sp)`,
  at `tests/test_torch_distributed.py`'s tolerances, GridMask and dropout
  off. JAX's gradients are its optimizer's first moment after the step
  (Adam's first step keeps (1 - b1) x the clipped gradient). The v1
  weights' seed is one where no ReLU input or bilinear sample lies within
  fp32 rounding of its switch (`tests/test_torch_train_step.py`): at seeds
  3, 6 and 7 one does, and the port's one-process step differs from JAX's
  by 0.5-1% in a backbone stage as its split steps do (the split steps
  and the one-process step agree to 2e-6 there).
* `tools.dp_step`'s frame encoded on those ranks first equals one
  process's BEV.
* With dropout and GridMask on, the port's step at `--sp 2` equals its
  one-process step at the same seed: the losses, gradients and updates.
* `tools.train --dp 1 --sp 2` on two ranks saves, with both ranks'
  generators equal, and resumes.

The launches start before any JAX computation, and every JAX step is
jitted and blocked on (JAX's matcher calls back into JAX from a host
callback, which can deadlock with JAX work dispatched meanwhile).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bevformer_tpu.models.detector_v2 import BEVFormerV2 as JaxBEVFormerV2
from bevformer_tpu.runtime import mesh as mesh_lib
from bevformer_tpu.runtime import optim as jax_optim
from bevformer_tpu.runtime import train as jax_train
from bevformer_tpu.runtime import train_v2 as jax_train_v2
from bevformer_torch.core import geometry
from bevformer_torch.data import train_batch
from bevformer_torch.models.attention import sca_capacity_routing, split_routing
from bevformer_torch.models.layers import QueryDropout
from bevformer_torch.runtime import (
    Trainer,
    build_model,
    init_state_dict,
    parallel,
    state_dict_from_jax,
    state_dict_from_jax_v2,
)
from bevformer_torch.tools import create_data
from bevformer_torch.tools.dp_step import encode
from tests import torch_dist_worker
from tests.test_torch_distributed import (
    JCFG as DP_JCFG,
    MINI_CLI,
    TOL,
    TOTAL_STEPS,
    V2_GRAD_CAP,
    V2_GT_COUNTS,
    V2_TOL,
    ZERO_TOL,
    _check_running_statistics,
    _check_step,
    _jax_v2_patches,
    _json_lines,
    _rel_l2,
    _v2_sample,
    concat,
    launcher,
    torchrun,
    unclipped,
    with_gt_count,
    write_spec,
)
from tests.test_torch_train_step import jax_batch, jax_params
from tests.test_torch_v2 import seed_batch_stats
from tests.test_torch_v2_train import JCFGS, _jax_batch, _NoTx, _port_batch
from tests.torch_port_helpers import assert_close, perturb, port_config, to_numpy_tree

ENCODER_TOL = 1e-5
GT_COUNTS = (3, 9)
V1_WEIGHT_SEED = 5
JCFG = DP_JCFG.replace(name="mini_sp", bev_h=7, bev_w=9, encoder_layers=2)
V2_JCFG = JCFGS["t1"].replace(name="mini_sp_v2", bev_h=7, bev_w=9, encoder_layers=2)
V1_MESHES = ((1, 2), (2, 2))


def dp_step(tmp, name, spec, dp, sp, *extra):
    """`tools.dp_step` on dp x sp ranks."""
    return torchrun(tmp / f"{name}.log", dp * sp, "-m", "bevformer_torch.tools.dp_step",
                    str(spec), str(tmp / f"{name}.pt"), "--dp", str(dp), "--sp", str(sp),
                    "--device", "cpu", *extra)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The launches that need no JAX result, started together before the
    JAX computations: the split encoder (2 ranks), a v1 step with dropout
    and GridMask on at (1, 2), and `tools.train --dp 1 --sp 2` on a root of
    4 scenes x 2 frames."""
    tmp = tmp_path_factory.mktemp("sp_jobs")
    out = dict(dir=tmp)
    out["encoder"] = torchrun(tmp / "encoder.log", 2, os.path.join("tests", "torch_dist_worker.py"),
                              "sp_encoder", str(tmp / "encoder.pt"))
    cfg = port_config(JCFG).replace(use_grid_mask=True)
    sd = {k: torch.from_numpy(v) for k, v in init_state_dict(cfg, seed=4).items()}
    batch = with_gt_count(train_batch(cfg, seed=6, device="cpu"), GT_COUNTS[1])
    write_spec(tmp / "dropout_spec.pt", cfg, sd, batch)
    out["dropout"] = dp_step(tmp, "dropout", tmp / "dropout_spec.pt", 1, 2, "--dropout")
    out.update(dropout_cfg=cfg, dropout_sd=sd, dropout_batch=batch)
    root = str(tmp / "root")
    create_data.main(["synth", "--out-dir", root, "--scenes", "4", "--frames", "2",
                      "--img-w", "160", "--img-h", "96"])
    out["work"] = str(tmp / "work")
    out["train_args"] = ["bevformer_base", "--data-root", root, "--work-dir", out["work"],
                         "--log-interval", "1", "--device", "cpu", "--dp", "1", "--sp", "2",
                         "--cfg-options", *MINI_CLI]
    out["train"] = launcher(tmp / "train.log", "dist_train.sh", 2, *out["train_args"],
                            "--max-iters", "2")
    return out


# ---------------------------------------------------------------- in-process

@pytest.mark.parametrize("q", [1, 2, 7, 63, 1023, 40000])
def test_query_bounds_are_tensor_splits(q):
    for sp in (1, 2, 3, 4):
        chunks = torch.tensor_split(torch.arange(q), sp)
        want = tuple((int(c[0]), int(c[-1]) + 1) if len(c) else None for c in chunks)
        got = parallel.query_bounds(q, sp)
        assert all(w is None and lo == hi or w == (lo, hi) for w, (lo, hi) in zip(want, got))
        assert got[0][0] == 0 and got[-1][1] == q


def test_query_split_without_a_mesh_is_none():
    with parallel.split_queries():
        assert parallel.query_split(63) is None
    assert parallel.query_split(63) is None


def _routing(ratio=0.1):
    """The SCA routing of the split encoder's cases at `ratio`."""
    enc, inputs, _ = torch_dist_worker.encoder_case(ratio, False)
    ref3 = geometry.reference_points_3d(*torch_dist_worker.BEV_HW,
                                        enc.pc_range[5] - enc.pc_range[2],
                                        enc.num_points_in_pillar, bs=2)
    _, mask = geometry.point_sampling(ref3, enc.pc_range, inputs["lidar2img"],
                                      torch_dist_worker.ENCODER_IMG)
    return sca_capacity_routing(mask, ratio)


@pytest.mark.parametrize("lo,hi", [(0, 512), (512, 1023), (100, 101), (300, 700)])
def test_split_routing_keeps_the_rows_of_the_range(lo, hi):
    """Per sample and camera: the routed rows of queries in [lo, hi), in
    order, then padding that is not visible; every query of the range finds
    its own row, or none where the whole routing drops it."""
    full = _routing()
    part = split_routing(full, lo, hi)
    bs, cams, cap = full["top_idx"].shape
    rows = part["top_idx"].shape[-1]
    counts = []
    for b in range(bs):
        for c in range(cams):
            top = full["top_idx"][b, c]
            mine = (top >= lo) & (top < hi)
            n = int(mine.sum())
            counts.append(n)
            assert torch.equal(part["top_idx"][b, c, :n], top[mine] - lo)
            assert torch.equal(part["vis_sel"][b, c, :n], full["vis_sel"][b, c][mine])
            assert not part["vis_sel"][b, c, n:].any()
            found = part["found"][b, c]
            assert torch.equal(found, full["found"][b, c, lo:hi])
            i = torch.nonzero(found)[:, 0]
            assert torch.equal(part["top_idx"][b, c][part["inv"][b, c][i]], i)
    assert rows == max(max(counts), 1)
    assert torch.equal(part["anyz"], full["anyz"][..., lo:hi])


def test_query_dropout_keeps_the_rows_of_the_whole_mask():
    """Drawn from the same generator state, a split's rows of the dropout
    equal those rows of the whole tensor's."""
    drop = QueryDropout(0.3).train()
    x = torch.randn(2, 63, 5)
    torch.manual_seed(1)
    whole = drop(x)
    assert 0.2 < float((whole == 0).float().mean()) < 0.4
    for lo, hi in parallel.query_bounds(63, 3):
        torch.manual_seed(1)
        split = parallel.QuerySplit(63, lo, hi, parallel.query_bounds(63, 3), None)
        assert torch.equal(drop(x[:, lo:hi], split), whole[:, lo:hi])
    assert drop.eval()(x) is x


# ------------------------------------------------------------- the encoder

@pytest.fixture(scope="module")
def encoder_ranks(jobs):
    jobs["encoder"].finish()
    return torch.load(jobs["dir"] / "encoder.pt", weights_only=False)


@pytest.mark.parametrize("case", torch_dist_worker.ENCODER_CASES, ids=lambda c: c[0])
def test_encoder_over_two_ranks_equals_one_process(encoder_ranks, case):
    name, ratio, remat = case
    enc, inputs, cotangent = torch_dist_worker.encoder_case(ratio, remat)
    bev, grads = torch_dist_worker.run_encoder(enc, inputs, cotangent)
    q = bev.shape[1]
    assert q % 2 == 1
    bounds = parallel.query_bounds(q, 2)
    for r, rank in enumerate(encoder_ranks):
        got = rank[name]
        assert got["split"] == (q, *bounds[r])
        assert_close(got["bev"], bev, ENCODER_TOL, f"{name} rank {r} bev")
    for k, v in grads.items():
        mean = sum(rank[name]["grads"][k] for rank in encoder_ranks) / len(encoder_ranks)
        assert_close(mean, v, ENCODER_TOL, f"{name} {k}")

    # each layer's msda calls (and again in a recomputation): TSA over the
    # queue of 2 of each sample at the rank's queries, SCA over the cameras
    # at its packed routed rows
    routing = _routing(ratio) if ratio else None
    if ratio == 0.1:
        visible, cap = routing["anyz"].sum(-1), routing["top_idx"].shape[-1]
        assert (visible > cap).any() and (visible < cap).any()  # dropped; fillers
    calls = len(enc.layers) * (2 if remat else 1)
    for r, rank in enumerate(encoder_ranks):
        lo, hi = bounds[r]
        rows = hi - lo if routing is None else split_routing(routing, lo, hi)["top_idx"].shape[-1]
        assert rank[name]["calls"] == [(4, hi - lo), (12, rows)] * calls


# ------------------------------------------------- training steps against JAX

def first_step_grads(opt_state, params, b1=0.9):
    """The clipped gradient of an AdamW step from a fresh state: every
    Adam state's first moment (1 - b1) g, over its parameters, / (1 - b1)."""
    mus = {}
    for s in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            for path, leaf in jax.tree_util.tree_flatten_with_path(s.mu)[0]:
                mus[jax.tree_util.keystr(path)] = np.asarray(leaf, np.float32)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: mus.get(jax.tree_util.keystr(p), np.zeros(np.shape(x), np.float32))
        / np.float32(1 - b1), params)


def jax_mesh_step(step_fn, state, batch, dp, sp):
    """`step_fn` (a JAX `make_train_step*`) on `state` replicated and
    `batch` sharded over dp, within `make_mesh(dp, sp)`, blocked on."""
    mesh = mesh_lib.make_mesh(dp, sp)
    with mesh_lib.activate(mesh):
        return jax.block_until_ready(step_fn(mesh_lib.replicate(mesh, state),
                                             mesh_lib.shard_batch(mesh, batch),
                                             jax.random.PRNGKey(0)))


def jax_results(metrics, grads, max_norm):
    """Loss terms, the unclipped gradients and the global norm."""
    norm = float(metrics["grad_norm"])
    coef = min(1.0, max_norm / norm)
    return dict(jlosses={k: np.asarray(v) for k, v in metrics.items() if k != "grad_norm"},
                jnorm_all=norm, jgrads={k: v / coef for k, v in grads.items()})


@pytest.fixture(scope="module")
def v1_runs(tmp_path_factory, jobs):
    tmp = tmp_path_factory.mktemp("sp_v1")
    cfg = port_config(JCFG)
    samples = [with_gt_count(train_batch(cfg, seed=s, device="cpu"), n)
               for s, n in zip((6, 7), GT_COUNTS)]
    batch = concat(samples)
    jmodel, params = jax_params(JCFG, jax_batch(samples[0]), seed=V1_WEIGHT_SEED)
    before = state_dict_from_jax(params, JCFG)
    q = cfg.bev_h * cfg.bev_w
    frame = (batch.images[:1, -1], batch.can_bus[:1, -1], batch.lidar2img[:1, -1],
             torch.zeros((1, q, cfg.embed_dims)), torch.zeros((1,), dtype=torch.bool))
    torch.save(dict(cfg=cfg, state_dict=before, batch=batch, steps=1, total_steps=TOTAL_STEPS,
                    frame=frame), tmp / "spec.pt")
    # the (1, 2) launch runs the spec a second time as a further job (`--then`)
    then = ("--then", str(tmp / "spec.pt"), str(tmp / "then.pt"), "1", "2")
    launches = {mesh: dp_step(tmp, f"dp{mesh[0]}_sp{mesh[1]}", tmp / "spec.pt", *mesh,
                              *(then if mesh == (1, 2) else ()))
                for mesh in V1_MESHES}
    tx, sched = jax_optim.make_optimizer(JCFG.optim, params, TOTAL_STEPS)
    state = jax_train.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    step_fn = jax_train.make_train_step(jmodel, tx)
    runs = {}
    with _jax_dropout_off():
        for mesh in V1_MESHES:
            new, metrics = jax_mesh_step(step_fn, state, jax_batch(batch), *mesh)
            grads = state_dict_from_jax(to_numpy_tree(first_step_grads(new.opt_state, params)),
                                        JCFG)
            runs[mesh] = dict(cfg=cfg, before=before, lr=float(sched(0)), frame=frame,
                              jstepped=state_dict_from_jax(to_numpy_tree(new.params), JCFG),
                              **jax_results(metrics, grads, cfg.optim.grad_clip_norm))
    for mesh, job in launches.items():
        job.finish()
        runs[mesh]["out"] = torch.load(tmp / f"dp{mesh[0]}_sp{mesh[1]}.pt", weights_only=False)
    runs["then"] = torch.load(tmp / "then.pt", weights_only=False)
    return runs


@contextlib.contextmanager
def _jax_dropout_off():
    """Flax's Dropout the identity (the port's dp_step runs every dropout
    at p = 0)."""
    import flax.linen as flax_nn

    patch = pytest.MonkeyPatch()
    patch.setattr(flax_nn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    try:
        yield
    finally:
        patch.undo()


@pytest.mark.parametrize("mesh", V1_MESHES, ids=lambda m: f"dp{m[0]}-sp{m[1]}")
def test_v1_step_equals_jax_on_the_mesh(v1_runs, mesh):
    r = v1_runs[mesh]
    assert r["out"]["mesh"] == mesh

    def grad_check(name, ours, ref):
        assert_close(ours, ref, TOL, name)

    _check_step(r, TOL, grad_check, world=mesh[0] * mesh[1])
    # a record of each rank (on the CPU no kernel launches)
    assert len(r["out"]["ranks"]) == mesh[0] * mesh[1]
    for rank in r["out"]["ranks"]:
        assert set(rank["launches"].values()) == {0} and len(rank["step_ms"]) == 1


@pytest.mark.parametrize("mesh", V1_MESHES, ids=lambda m: f"dp{m[0]}-sp{m[1]}")
def test_dp_step_encodes_the_frame_as_one_process(v1_runs, mesh):
    """The frame's BEV encoded within the split (eval mode, each rank's
    queries) equals one process's."""
    r = v1_runs[mesh]
    one = encode(build_model(r["cfg"], r["before"], "cpu"), r["frame"], torch.device("cpu"))
    assert_close(r["out"]["bev"], one["bev"], ENCODER_TOL, "bev")
    assert all("encode" in rank for rank in r["out"]["ranks"])


def test_dp_step_then_runs_a_further_job_as_a_launch_of_its_own(v1_runs):
    """`tools.dp_step --then`: the same spec run again as a second job of
    one launch gives the first job's record bitwise (the mesh's groups made
    anew, the counters and peaks reset, the model and trainer built anew)."""
    first, again = v1_runs[(1, 2)]["out"], v1_runs["then"]
    assert again["mesh"] == (1, 2) and len(again["ranks"]) == 2
    assert again["outs"] == first["outs"]
    assert torch.equal(again["bev"], first["bev"])
    for key in ("states", "grads"):
        a, b = again[key], first[key]
        for x, y in ((a, b),) if key == "grads" else zip(a, b):
            assert sorted(x) == sorted(y) and all(torch.equal(x[k], y[k]) for k in x), key
    for a, b in zip(again["ranks"], first["ranks"]):
        assert a["launches"] == b["launches"] and a["queries"] == b["queries"]


@pytest.fixture(scope="module")
def v2_runs(tmp_path_factory, jobs):
    tmp = tmp_path_factory.mktemp("sp_v2")
    jcfg = V2_JCFG
    cfg = port_config(jcfg)
    parts = [_v2_sample(jcfg, s, n) for s, n in zip((2, 3), V2_GT_COUNTS)]
    b = {k: (np.concatenate([p[k] for p in parts]) if k != "mono_targets" else
             {t: np.concatenate([p[k][t] for p in parts]) for t in parts[0][k]})
         for k in parts[0]}
    rng = np.random.RandomState(1)
    with _jax_v2_patches():
        jmodel = JaxBEVFormerV2(cfg=jcfg)
        init = jax_train_v2.init_state_v2(jmodel, _NoTx(), jax.random.PRNGKey(0),
                                          _jax_batch(parts[0]))
        params = perturb(to_numpy_tree(init.params), rng,
                         names=("sampling_offsets", "attention_weights"), std=0.02)
        stats = to_numpy_tree(init.batch_stats)
        seed_batch_stats(stats, rng)
        batch = _port_batch(b)

        def bridged(tree, stats_tree=stats):
            return state_dict_from_jax_v2({"params": to_numpy_tree(tree),
                                           "batch_stats": to_numpy_tree(stats_tree)}, jcfg)

        before = bridged(params)
        write_spec(tmp / "spec.pt", cfg, before, batch)
        job = dp_step(tmp, "out", tmp / "spec.pt", 2, 2)
        p0 = jax.tree.map(jnp.asarray, params)
        tx, sched = jax_optim.make_optimizer(jcfg.optim, p0, TOTAL_STEPS, bn_trainable=True)
        state = jax_train_v2.TrainStateV2(jnp.zeros((), jnp.int32), p0,
                                          jax.tree.map(jnp.asarray, stats), tx.init(p0))
        new, metrics = jax_mesh_step(jax_train_v2.make_train_step_v2(jmodel, tx), state,
                                     _jax_batch(b), 2, 2)
        grads = bridged(first_step_grads(new.opt_state, params))
    job.finish()
    out = torch.load(tmp / "out.pt", weights_only=False)
    return dict(cfg=cfg, out=out, before=before, lr=float(sched(0)), batch=batch,
                jstepped=bridged(new.params), jstats=bridged(params, new.batch_stats),
                **jax_results(metrics, grads, cfg.optim.grad_clip_norm))


def test_v2_step_equals_jax_on_the_mesh(v2_runs):
    """As `test_torch_distributed`'s V2 test, on a (2, 2) mesh."""
    r = v2_runs
    norm = r["out"]["outs"][0]["grad_norm"]
    assert r["out"]["mesh"] == (2, 2)

    def grad_check(name, ours, ref):
        if max(float(ours.norm()), float(np.linalg.norm(ref))) <= ZERO_TOL * norm:
            return
        assert _rel_l2(ours, ref) <= V2_GRAD_CAP, (name, _rel_l2(ours, ref))

    _check_step(r, V2_TOL, grad_check, world=4)
    assert any(k.endswith("_mono") for k in r["out"]["outs"][0])


def test_v2_running_statistics_on_the_mesh(v2_runs):
    """The BatchNorms reduce over the `dp` group: the running statistics
    of the two samples, each counted once, as JAX's on the mesh."""
    _check_running_statistics(v2_runs)


# ------------------------------------------------------------- dropout on

def test_split_step_with_dropout_equals_one_process(jobs):
    """`--dp 1 --sp 2` with dropout and GridMask on against this process's
    step at the same seed: the ranks of one sample draw one mask."""
    cfg, sd, batch = jobs["dropout_cfg"], jobs["dropout_sd"], jobs["dropout_batch"]
    model = build_model(cfg, sd, "cpu")
    trainer = Trainer(model, TOTAL_STEPS, seed=0)
    drops = [m for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    assert drops and all(m.p > 0 for m in drops) and cfg.use_grid_mask
    losses = trainer.step(batch)
    jobs["dropout"].finish()
    out = torch.load(jobs["dir"] / "dropout.pt", weights_only=False)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    r = dict(cfg=cfg, out=out, before={k: v.numpy() for k, v in sd.items()},
             jnorm_all=losses["grad_norm"],
             jlosses={k: v for k, v in losses.items() if k not in ("grad_norm", "lr")},
             jgrads=unclipped(grads, losses["grad_norm"], cfg.optim.grad_clip_norm),
             jstepped={k: v.numpy() for k, v in model.state_dict().items()},
             lr=losses["lr"])

    def grad_check(name, ours, ref):
        assert_close(ours, ref, TOL, name)

    _check_step(r, TOL, grad_check)
    # the masks moved the step: at p = 0 the same weights take another loss
    quiet = Trainer(build_model(cfg, sd, "cpu"), TOTAL_STEPS, seed=0)
    for m in quiet.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    assert abs(quiet.step(batch)["total"] - losses["total"]) > 1e-4 * abs(losses["total"])


# ------------------------------------------------------------- tools.train

def test_tools_train_over_an_sp_group_saves_and_resumes(jobs):
    first_out = jobs["train"].finish()
    assert "mesh dp=1 sp=2" in first_out
    first = _json_lines(first_out)
    steps = [r for r in first if "step_ms" in r and "done" not in r]
    done = [r for r in first if "done" in r]
    # one dp index: 4 train samples, 1 a step, 4 steps an epoch
    assert [r["step"] for r in steps] == [0, 1] and done[0]["dp"] == 1 and done[0]["sp"] == 2
    assert all(np.isfinite(r["total"]) and np.isfinite(r["grad_norm"]) for r in steps)
    ckpt_path = os.path.join(jobs["work"], "ckpts", "iter_2.pth")
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    assert ckpt["step"] == 2 and len(ckpt["rng_by_rank"]) == 2
    # the two ranks hold one sample: they drew the same masks
    for k in ("torch_cpu", "grid_mask"):
        assert torch.equal(ckpt["rng_by_rank"][0][k], ckpt["rng_by_rank"][1][k])
    second = _json_lines(launcher(jobs["dir"] / "resume.log", "dist_train.sh", 2,
                                  *jobs["train_args"], "--max-iters", "3", "--resume-from",
                                  ckpt_path).finish())
    resumed = [r for r in second if "resumed_from" in r]
    assert len(resumed) == 1 and resumed[0]["step"] == 2
    assert [r["step"] for r in second if "step_ms" in r and "done" not in r] == [2]
