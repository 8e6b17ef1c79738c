"""The port's nuScenes detection metrics against the JAX package's, and the
whole evaluation path of both packages on one synthetic root, on the CPU.

`evaluate_detections`, `format_submission`, `apply_overlap_filter` and
`predict_attribute` must equal JAX's to 1e-9 (the same float64 numpy
arithmetic), on the cases of `tests/test_evaluation.py` and on random
predictions around the ground truth.

End to end: a root written by the port's `generate` (160 x 96 images, one
train and one val scene of 3 frames), both packages' datasets and
`VideoEvaluator`s over its val split, with the mini detector of
`tests/test_torch_slice.py` (JAX init, seeded noise on the layers JAX
zero-initialises). The port loads its weights from a model-zoo-layout file
written with `torch.save({"state_dict": export_reference_state_dict(...)})`
through `load_reference_pth`: every frame's bev_embed agrees to 1e-3 of its
scale, and NDS and mAP to 1e-3.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.configs import BEVFormerConfig as JaxConfig
from bevformer_tpu.configs import DataConfig as JaxData
from bevformer_tpu.core import evaluation as jax_eval
from bevformer_tpu.data.dataset import NuScenesTemporalDataset as JaxDataset
from bevformer_tpu.models import BEVFormer as JaxBEVFormer
from bevformer_tpu.runtime.checkpoint import export_reference_state_dict
from bevformer_tpu.runtime.eval import VideoEvaluator as JaxVideoEvaluator
from bevformer_torch.core import evaluation
from bevformer_torch.data import NuScenesTemporalDataset, generate
from bevformer_torch.data.synth import rig_lidar2img
from bevformer_torch.runtime import VideoEvaluator, build_model, load_reference_pth
from tests.torch_port_helpers import assert_close, perturb, port_config, to_numpy_tree

EXACT = 1e-9  # the same float64 numpy arithmetic on both sides
TOL = 1e-3  # the model outputs, and NDS / mAP of the end-to-end run


def _close(ours, ref, where=""):
    if isinstance(ref, dict):
        assert sorted(ours, key=str) == sorted(ref, key=str), where
        for k in ref:
            _close(ours[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            _close(a, b, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray) and ref.dtype.kind in "OUS":
        assert np.array_equal(ours, ref), where
    elif isinstance(ref, (float, np.floating, np.ndarray)):
        a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
        assert a.shape == b.shape, where
        assert np.allclose(a, b, rtol=0, atol=EXACT, equal_nan=True), (where, ours, ref)
    else:
        assert ours == ref, (where, ours, ref)


def _gt(rng, tokens, per_sample=5, classes=3, attrs=False):
    """`tests/test_evaluation.py::_mk_gt`, optionally with attributes."""
    gt = {}
    for t in tokens:
        boxes = rng.randn(per_sample, 9).astype(np.float64)
        boxes[:, :2] *= 20
        boxes[:, 2] = rng.uniform(-2, 0, per_sample)
        boxes[:, 3:6] = np.abs(boxes[:, 3:6]) + 1.0
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, per_sample)
        labels = rng.randint(0, classes, per_sample)
        gt[t] = dict(boxes=boxes, labels=labels)
        if attrs:
            names = [evaluation.CLASS_NAMES[i] for i in labels]
            gt[t]["attrs"] = np.array([evaluation.predict_attribute(n, b[7:9])
                                       for n, b in zip(names, boxes)], dtype=object)
    return gt


def _cases():
    tokens = [f"t{i}" for i in range(4)]
    rng = np.random.RandomState(0)
    gt = _gt(rng, tokens)
    perfect = [dict(token=t, boxes_3d=gt[t]["boxes"].copy(),
                    scores_3d=np.linspace(0.9, 0.5, len(gt[t]["boxes"])),
                    labels_3d=gt[t]["labels"].copy()) for t in tokens]
    yield "perfect", perfect, gt
    rng = np.random.RandomState(1)
    gt = _gt(rng, tokens)
    garbage = [dict(token=t, boxes_3d=rng.randn(10, 9) * 100, scores_3d=rng.rand(10),
                    labels_3d=rng.randint(0, 10, 10)) for t in tokens]
    yield "garbage", garbage, gt
    for seed in (2, 3, 4):
        rng = np.random.RandomState(seed)
        tokens = [f"s{seed}_{i}" for i in range(6)]
        gt = _gt(rng, tokens, per_sample=12, classes=10, attrs=seed != 3)
        results = []
        for t in tokens:
            g = gt[t]
            near = g["boxes"] + rng.randn(*g["boxes"].shape) * [1.5, 1.5, 0.3, 0.3, 0.3, 0.3, 0.4,
                                                                 0.5, 0.5]
            far = rng.randn(8, 9) * 30
            r = dict(token=t, boxes_3d=np.concatenate([near, far]),
                     scores_3d=rng.rand(len(near) + 8),
                     labels_3d=np.concatenate([np.where(rng.rand(len(near)) < 0.8, g["labels"],
                                                        rng.randint(0, 10, len(near))),
                                               rng.randint(0, 10, 8)]))
            if seed == 4:
                r["attrs"] = np.array(["vehicle.moving", ""] * (len(r["scores_3d"]) // 2),
                                      dtype=object)
            results.append(r)
        yield f"random{seed}", results, gt
    yield "empty", [dict(token="s4_0", boxes_3d=np.zeros((0, 9)), scores_3d=np.zeros(0),
                         labels_3d=np.zeros(0, int))], gt


CASES = list(_cases())


@pytest.mark.parametrize("name,results,gt", CASES, ids=[c[0] for c in CASES])
def test_evaluate_detections_equals_jax(name, results, gt):
    ours = evaluation.evaluate_detections(results, gt)
    ref = jax_eval.evaluate_detections(results, gt)
    _close(ours, ref)
    if name == "perfect":
        assert ours["mean_ap"] > 0.98


def test_predict_attribute_equals_jax():
    for name in evaluation.CLASS_NAMES:
        for v in ((0.0, 0.0), (0.1, 0.15), (0.2, 0.0), (0.3, -0.4), (-5.0, 2.0)):
            assert evaluation.predict_attribute(name, v) == jax_eval.predict_attribute(name, v)


def _infos(tokens, seed):
    rng = np.random.RandomState(seed)

    def quat():
        q = rng.randn(4)
        return (q / np.linalg.norm(q)).tolist()

    return {t: dict(lidar2ego_rotation=quat(), lidar2ego_translation=rng.randn(3).tolist(),
                    ego2global_rotation=quat(), ego2global_translation=(rng.randn(3) * 100).tolist())
            for t in tokens}


@pytest.mark.parametrize("case", [2, 3])
def test_format_submission_equals_jax(case):
    _, results, gt = CASES[case]
    infos = _infos(gt, case)
    _close(evaluation.format_submission(results, infos),
           jax_eval.format_submission(results, infos))


def test_overlap_filter_equals_jax():
    """As JAX's, but the GT attributes are filtered with their boxes (JAX
    leaves them whole, and evaluating its output raises IndexError)."""
    _, results, gt = CASES[2]
    l2i = {t: rig_lidar2img(1600, 900) for t in gt}
    ours = evaluation.apply_overlap_filter(results, gt, l2i, (900, 1600))
    ref = jax_eval.apply_overlap_filter(results, gt, l2i, (900, 1600))
    for token, g in ref[1].items():
        keep = jax_eval.filter_boxes_by_overlap(gt[token]["boxes"] + [0, 0, 0.5, 0, 0, 0, 0, 0, 0]
                                                * gt[token]["boxes"][:, 5:6], l2i[token],
                                                (900, 1600))
        g["attrs"] = g["attrs"][keep]
    _close(ours, ref)
    # the filter keeps some boxes and drops others
    kept = sum(len(r["boxes_3d"]) for r in ours[0])
    assert 0 < kept < sum(len(r["boxes_3d"]) for r in results)
    _close(evaluation.evaluate_detections(*ours), jax_eval.evaluate_detections(*ref))


# ---------------------------------------------------------------- end to end

JCFG = JaxConfig(
    name="mini_base", backbone_depth=10, bev_h=16, bev_w=16,
    encoder_layers=2, decoder_layers=2, sca_capacity_ratio=0.25,
    fused_msda="off", fused_dcn="off", use_grid_mask=False,
    data=JaxData(raw_size=(96, 160)),
)


class _TracedJaxEvaluator(JaxVideoEvaluator):
    """The JAX evaluator with every frame's head outputs kept (as in
    `tests/test_torch_slice.py`)."""

    def _build(self):
        super()._build()
        self.trace = []
        step = self._step

        def traced(*args):
            bev, dec = step(*args)
            self.trace.append(np.asarray(bev))
            return bev, dec

        self._step = traced


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_root"))
    generate(root, num_scenes=2, frames_per_scene=3, num_objects=24, img_w=160, img_h=96, seed=1)
    ann = f"{root}/nuscenes_infos_temporal_val.pkl"
    jds = JaxDataset(ann, JCFG, test_mode=True, data_root=root)
    s0 = jds.get_test_sample(0)

    jmodel = JaxBEVFormer(cfg=JCFG)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(s0["images"])[None], jnp.zeros((1, 18)),
        jnp.asarray(s0["lidar2img"])[None],
        jnp.zeros((1, JCFG.bev_h * JCFG.bev_w, JCFG.embed_dims)), jnp.zeros((1,), bool),
    )
    params = to_numpy_tree(params)
    rng = np.random.RandomState(0)
    perturb(params, rng, names=("sampling_offsets", "attention_weights"), std=0.02)
    perturb(params, rng, names=("conv_offset",), std=1e-3)
    jev = _TracedJaxEvaluator(jmodel, params)
    jres = jev.run(jds, progress_every=0)

    # a model-zoo-layout file, with the BatchNorm counters a reference
    # checkpoint carries
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_reference_state_dict(params, JCFG).items()}
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(0)
               for k in list(sd) if k.endswith(".running_mean")})
    pth = f"{root}/reference.pth"
    torch.save({"meta": {}, "state_dict": sd}, pth)
    cfg = port_config(JCFG)
    model = build_model(cfg, load_reference_pth(pth), "cpu")
    bevs = []
    model.register_forward_hook(lambda m, i, out: bevs.append(out["bev_embed"]))
    ds = NuScenesTemporalDataset(ann, cfg, data_root=root, device="cpu")
    res = VideoEvaluator(model).run(ds, progress_every=0)
    return jev.trace, bevs, jres, res, ds.gt_by_token(range(len(ds)))


def test_reference_pth_gives_the_jax_frames(runs):
    jbevs, bevs = runs[:2]
    assert len(bevs) == len(jbevs) == 3
    for i, (ours, ref) in enumerate(zip(bevs, jbevs)):
        assert_close(ours, ref, TOL, f"bev_embed[{i}]")


def test_video_metrics_equal_jax(runs):
    _, _, jres, res, gt = runs
    assert [r["token"] for r in res] == [r["token"] for r in jres]
    ours = evaluation.evaluate_detections(res, gt)
    ref = jax_eval.evaluate_detections(jres, gt)
    assert sum(len(g["boxes"]) for g in gt.values()) > 0
    for key in ("nd_score", "mean_ap"):
        assert math.isfinite(ours[key]) and abs(ours[key] - ref[key]) <= TOL, (key, ours, ref)
    assert ours["nd_score"] > 0  # some predictions land within 2 m of the ground truth
