"""The port's whole inference slice against the JAX package, on the CPU: a
bevformer_base-shaped mini detector (caffe R10 with DCN in stages 3-4, 4
FPN levels, SCA capacity 0.25, 2 encoder and 2 decoder layers, base widths)
over a 3-frame video with a scene reset, through both `VideoEvaluator`s.

Frame 1 carries `prev_bev` (shift, rotate, the TSA history queue); frame 2
starts a new scene. Both sides load the same weights: the JAX init, with
seeded noise on the layers it zero-initialises, bridged by
`state_dict_from_jax`. bev_embed, cls and bbox (every decoder layer) must
agree to 1e-3 of their scale, and the decoded boxes to the same tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.configs import BEVFormerConfig as JaxConfig
from bevformer_tpu.configs import DataConfig as JaxData
from bevformer_tpu.core import coder as jax_coder
from bevformer_tpu.models import BEVFormer as JaxBEVFormer
from bevformer_tpu.runtime.eval import VideoEvaluator as JaxVideoEvaluator
from bevformer_torch.data import SyntheticVideo
from bevformer_torch.runtime import VideoEvaluator, build_model, state_dict_from_jax
from tests.torch_port_helpers import assert_close, perturb, port_config, to_numpy_tree

TOL = 1e-3

JCFG = JaxConfig(
    name="mini_base", backbone_depth=10, bev_h=16, bev_w=16,
    encoder_layers=2, decoder_layers=2, sca_capacity_ratio=0.25,
    fused_msda="off", fused_dcn="off", use_grid_mask=False,
    data=JaxData(raw_size=(96, 160)),
)


class _TracedJaxEvaluator(JaxVideoEvaluator):
    """The JAX evaluator with every frame's head outputs kept."""

    def _build(self):
        model, params, c = self.model, self.params, self.cfg
        self.trace = []

        def step(images, can_bus, lidar2img, prev_bev, has_prev):
            preds = model.apply(params, images, can_bus, lidar2img, prev_bev, has_prev)
            dec = jax_coder.decode_batch(
                preds, max_num=self.max_num, num_classes=c.num_classes,
                post_center_range=c.post_center_range,
            )
            return preds, dec

        jitted = jax.jit(step)

        def traced(*args):
            preds, dec = jitted(*args)
            self.trace.append(jax.tree.map(np.asarray, preds))
            return preds["bev_embed"], dec

        self._step = traced
        self._audit_step = None


class _NumpyFrames:
    def __init__(self, video):
        self.video = video

    def __len__(self):
        return len(self.video)

    def get_test_sample(self, i):
        s = self.video.get_test_sample(i)
        s["images"] = s["images"].numpy()
        return s


def _match_boxes(ours, ref, name):
    """Decoded boxes agree as sets: top-k may order near-ties differently."""
    assert len(ours["scores_3d"]) == len(ref["scores_3d"]), name
    o = np.argsort(-ours["scores_3d"], kind="stable")
    r = np.argsort(-ref["scores_3d"], kind="stable")
    np.testing.assert_allclose(ours["scores_3d"][o], ref["scores_3d"][r], atol=1e-4)
    scale = max(np.abs(ref["boxes_3d"]).max(), 1e-6)
    used = np.zeros(len(o), bool)
    for i in r:
        cand = np.flatnonzero(
            ~used
            & (ours["labels_3d"] == ref["labels_3d"][i])
            & (np.abs(ours["scores_3d"] - ref["scores_3d"][i]) <= 1e-4)
        )
        err = np.abs(ours["boxes_3d"][cand] - ref["boxes_3d"][i]).max(-1) if len(cand) else []
        assert len(cand) and err.min() <= TOL * scale, f"{name}: box {i} has no match"
        used[cand[np.argmin(err)]] = True


@pytest.fixture(scope="module")
def runs():
    cfg = port_config(JCFG)
    video = SyntheticVideo(cfg, scene_lengths=(2, 1), seed=5)
    frames = _NumpyFrames(video)
    s0 = frames.get_test_sample(0)

    jmodel = JaxBEVFormer(cfg=JCFG)
    prev = jnp.zeros((1, JCFG.bev_h * JCFG.bev_w, JCFG.embed_dims))
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(s0["images"])[None],
        jnp.zeros((1, 18)), jnp.asarray(s0["lidar2img"], jnp.float32)[None],
        prev, jnp.zeros((1,), bool),
    )
    params = to_numpy_tree(params)
    rng = np.random.RandomState(0)
    perturb(params, rng, names=("sampling_offsets", "attention_weights"), std=0.02)
    perturb(params, rng, names=("conv_offset",), std=1e-3)

    jev = _TracedJaxEvaluator(jmodel, params)
    jres = jev.run(frames, progress_every=0)

    model = build_model(cfg, state_dict_from_jax(params, JCFG))
    preds = []
    model.register_forward_hook(lambda m, i, out: preds.append(out))
    ev = VideoEvaluator(model)
    res = ev.run(video, progress_every=0)
    return jev.trace, jres, preds, res


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_video_frame_matches_jax(runs, frame):
    jtrace, jres, preds, res = runs
    ref, ours = jtrace[frame], preds[frame]
    assert_close(ours["bev_embed"], ref["bev_embed"], TOL, f"bev_embed[{frame}]")
    assert_close(ours["all_cls_scores"], ref["all_cls_scores"], TOL, f"cls[{frame}]")
    assert_close(ours["all_bbox_preds"], ref["all_bbox_preds"], TOL, f"bbox[{frame}]")
    assert res[frame]["token"] == jres[frame]["token"]
    _match_boxes(res[frame], jres[frame], f"frame {frame}")


def test_scene_reset_and_history(runs):
    """The frames come back in order, two scenes, every output finite."""
    _, _, preds, res = runs
    assert [r["token"] for r in res] == ["scene_0000_f000", "scene_0000_f001", "scene_0001_f000"]
    for p in preds:
        for v in p.values():
            assert torch.isfinite(v).all()


def test_call_sites_meet_the_kernel_contract(monkeypatch):
    """Every msda and DCN call of the inference path, and of a training
    step's forward and backward, hands its kernel what the CUDA wrapper
    accepts (shapes, fp32, contiguity), checked here with the wrappers' own
    checks in front of the plain versions. The training step runs through
    the kernels' autograd Functions, so the gradients that autograd hands
    their backward (often strided views) meet the backward kernels'
    checks too."""
    import dataclasses

    from bevformer_torch.data import train_batch
    from bevformer_torch.kernels import dcn, msda
    from bevformer_torch.models import attention, resnet
    from bevformer_torch.runtime import Trainer, init_state_dict

    calls = dict.fromkeys(("msda", "msda_bwd", "dcn", "im2col", "col2im"), 0)

    def msda_fwd_checked(value, shapes, loc, attw):
        msda._check(value, tuple(shapes), loc, attw)
        calls["msda"] += 1
        return msda.ms_deform_attn_plain(value, shapes, loc, attw)

    def msda_bwd_checked(value, shapes, loc, attw, grad_out):
        msda._check(value, tuple(shapes), loc, attw)
        msda._check_grad(value, loc, grad_out)
        calls["msda_bwd"] += 1
        return msda.ms_deform_attn_backward_plain(value, shapes, loc, attw, grad_out)

    def dcn_fwd_checked(x, off_y, off_x, mask, weight, stride):
        dcn._check(x, off_y, off_x, mask, weight, stride)
        calls["dcn"] += 1
        return dcn.dcn_conv_plain(x, off_y, off_x, mask, weight, stride)

    def im2col_checked(x, off_y, off_x, mask, stride):
        dcn._check_sampling(x, off_y, off_x, mask, stride)
        calls["im2col"] += 1
        return dcn.dcn_im2col_plain(x, off_y, off_x, mask, stride)

    def col2im_checked(x, off_y, off_x, mask, dcols, stride):
        dcn._check_sampling(x, off_y, off_x, mask, stride)
        dcn._check_tensor("dcols", dcols, x.device)
        calls["col2im"] += 1
        return dcn.dcn_col2im_plain(x, off_y, off_x, mask, dcols, stride)

    # the call sites run the kernels' autograd Functions, with each launch
    # replaced by its checked plain version
    monkeypatch.setattr(msda, "_launch_fwd", msda_fwd_checked)
    monkeypatch.setattr(msda, "ms_deform_attn_backward", msda_bwd_checked)
    monkeypatch.setattr(dcn, "_launch_fwd", dcn_fwd_checked)
    monkeypatch.setattr(dcn, "dcn_im2col", im2col_checked)
    monkeypatch.setattr(dcn, "dcn_col2im", col2im_checked)
    monkeypatch.setattr(attention, "ms_deform_attn", lambda v, s, loc, w: msda._MSDeformAttn.apply(
        v, loc, w, tuple((int(h), int(ww)) for h, ww in s)))
    monkeypatch.setattr(resnet, "dcn_conv", lambda *a: dcn._DCNConv.apply(*a))
    cfg = port_config(JCFG)
    model = build_model(cfg, init_state_dict(cfg, seed=0))
    VideoEvaluator(model).run(SyntheticVideo(cfg, (2,), seed=1), progress_every=0)
    # per frame: (TSA + SCA) per encoder layer + one per decoder layer; one
    # DCN in each of the 2 blocks of stages 3-4 at depth 10
    per_frame = 2 * cfg.encoder_layers + cfg.decoder_layers
    assert calls == dict(msda=2 * per_frame, msda_bwd=0, dcn=2 * 2, im2col=0, col2im=0)

    # one train-mode step on a queue of 2: the history frame runs the
    # encoder only, the trained frame runs everything and its backward
    calls.update(dict.fromkeys(calls, 0))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, queue_length=2))
    out = Trainer(model, total_steps=10).step(train_batch(cfg, seed=2))
    assert all(np.isfinite(v) for v in out.values()), out
    assert calls == dict(msda=2 * cfg.encoder_layers + per_frame, msda_bwd=per_frame,
                         dcn=2 * 2, im2col=2, col2im=2)
