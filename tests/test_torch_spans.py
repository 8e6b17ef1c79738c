"""The port's profiler spans (`utils/profiler.py::span`) on the CPU, on mini
detectors cut from bevformer_tiny (R10, 16 x 16 BEV, 2 + 2 layers, 100
queries, queue 3) and bevformerv2-r50-t2 (the same cut, frames (-1, 0)).

* With no profiler recording, every span is the one shared no-op context:
  a v1 frame and a training step run with `torch.profiler.record_function`
  made to raise.
* Under a CPU profiler, a v1 frame, a V2 sample and a training step show
  their spans `bevformer::<name>`, nested as the program calls them, each
  the expected number of times: on the CPU every dense backbone and neck
  conv is a `conv_fallback` (`models.conv_sites` counts them a
  backbone pass).
* The outputs, and a training step's parameters after it, are bitwise the
  same with the profiler on and off.
"""

import collections
import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bevformer_torch.configs import get_config
from bevformer_torch.data import SyntheticVideo, train_batch
from bevformer_torch.data.synth import rig_lidar2img
from bevformer_torch.runtime import (
    Trainer,
    VideoEvaluator,
    VideoEvaluatorV2,
    build_model,
    init_state_dict,
)
from bevformer_torch.models.conv_sites import conv_sites
from bevformer_torch.utils import profiler

PHASES = ("history", "forward", "loss", "backward", "clip", "optimizer", "readback")


def mini(name: str):
    cfg = get_config(name)
    scale = cfg.data.scale
    return cfg.replace(
        backbone_depth=10, bev_h=16, bev_w=16, encoder_layers=2, decoder_layers=2,
        num_query=100, max_gt=16,
        data=dataclasses.replace(cfg.data, raw_size=(round(96 / scale), round(160 / scale))),
    )


@pytest.fixture(scope="module")
def v1():
    cfg = mini("bevformer_tiny")
    return cfg, build_model(cfg, init_state_dict(cfg, seed=1), "cpu")


def frame_inputs(cfg):
    video = SyntheticVideo(cfg, scene_lengths=(1,), seed=2, device="cpu")
    s = video.get_test_sample(0)
    return (s["images"][None], torch.zeros(1, 18),
            torch.as_tensor(s["lidar2img"], dtype=torch.float32)[None],
            torch.zeros(1, cfg.bev_h * cfg.bev_w, cfg.embed_dims), torch.tensor([False]))


def sample_inputs(cfg):
    t, (h, w) = len(cfg.frames), cfg.data.img_size
    gen = torch.Generator().manual_seed(3)
    l2i = torch.as_tensor(rig_lidar2img(w, h)[: cfg.data.num_cams], dtype=torch.float32)
    return (torch.randn(1, t, cfg.data.num_cams, h, w, 3, generator=gen),
            l2i.expand(1, t, *l2i.shape).contiguous(), torch.tensor([False]), torch.eye(2)[None])


def trained(cfg, model):
    """A `Trainer` on a copy of `model` and one step's results and
    parameters after it."""
    trainer = Trainer(copy.deepcopy(model), total_steps=10, seed=4)
    out = trainer.step(train_batch(cfg, seed=5, device="cpu", scene_break_at=1))
    return out, [p.detach().clone() for p in trainer.model.parameters()]


def traced(fn):
    """`fn()` under a CPU profiler: its result and the program's spans as
    (name, start, end), in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    n = len(profiler.SPAN_PREFIX)
    spans = sorted(((e.name[n:], e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith(profiler.SPAN_PREFIX)), key=lambda s: s[1])
    return out, spans


def called(spans) -> collections.Counter:
    return collections.Counter(n for n, _, _ in spans)


def within(spans, inner: str, outer: str) -> int:
    """How many `inner` spans lie inside an `outer` span."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    return sum(any(s0 <= s and e <= e0 for s0, e0 in outs) for n, s, e in spans if n == inner)


def test_no_profiler_no_record_function(v1, monkeypatch):
    cfg, model = v1

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    assert profiler.span("frame") is profiler.span("step") is profiler._NO_SPAN
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    VideoEvaluator(model).step(*frame_inputs(cfg))
    out, _ = trained(cfg, model)
    assert np.isfinite(out["total"])


def test_frame_spans(v1):
    cfg, model = v1
    ev = VideoEvaluator(model)
    args = frame_inputs(cfg)
    (bev, dec), spans = traced(lambda: ev.step(*args))
    convs = len(conv_sites(cfg))
    assert called(spans) == {"frame": 1, "encoder": 1, "decoder": 1, "conv_fallback": convs}
    assert within(spans, "encoder", "frame") == within(spans, "decoder", "frame") == 1
    assert within(spans, "conv_fallback", "frame") == convs
    bev_off, dec_off = ev.step(*args)
    assert torch.equal(bev, bev_off)
    assert all(torch.equal(dec[k], dec_off[k]) for k in dec)


def test_sample_spans():
    cfg = mini("bevformerv2-r50-t2")
    model = build_model(cfg, init_state_dict(cfg, seed=1), "cpu")
    ev = VideoEvaluatorV2(model)
    args = sample_inputs(cfg)
    (preds, dec), spans = traced(lambda: ev.step(*args))
    convs = 2 * len(conv_sites(cfg))  # a backbone pass a frame
    assert called(spans) == {"sample": 1, "encoder": 2, "decoder": 1, "conv_fallback": convs}
    assert within(spans, "conv_fallback", "sample") == convs
    assert within(spans, "encoder", "sample") == 2 and within(spans, "decoder", "sample") == 1
    preds_off, dec_off = ev.step(*args)
    for k in ("bev_embed", "all_cls_scores", "all_bbox_preds"):
        assert torch.equal(preds[k], preds_off[k]), k
    assert all(torch.equal(dec[k], dec_off[k]) for k in dec)


def test_step_spans(v1):
    cfg, model = v1
    assert cfg.data.queue_length == 3
    (out, params), spans = traced(lambda: trained(cfg, model))
    # backbone passes: the history frame after the scene break, the trained frame
    convs = len(conv_sites(cfg))
    assert called(spans) == dict({"step": 1, "encoder": 3, "decoder": 1, "match": 1,
                                  "conv_fallback": 2 * convs}, **{p: 1 for p in PHASES})
    assert within(spans, "conv_fallback", "history") == within(spans, "conv_fallback",
                                                               "forward") == convs
    for p in PHASES:
        assert within(spans, p, "step") == 1, p
    assert within(spans, "encoder", "history") == 2 and within(spans, "encoder", "forward") == 1
    assert within(spans, "decoder", "forward") == 1 and within(spans, "match", "loss") == 1
    # the phases follow one another
    phases = [s for s in spans if s[0] in PHASES]
    assert [n for n, _, _ in phases] == list(PHASES)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    out_off, params_off = trained(cfg, model)
    assert out == out_off
    assert all(torch.equal(a, b) for a, b in zip(params, params_off))
