#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printed as it runs:
  1. device: the card's name and power limit (nvidia-smi); TF32 off for
     fp32 matmuls and convolutions;
  2. build: nvcc compiles bevformer_torch/csrc/*.cu for sm_90a;
  3. K1 (msda_fwd) against its plain PyTorch version at the three shapes of
     the inference path (TSA, SCA, decoder), with times;
  4. K2 (dcn_conv_fwd) against its plain version at the stage-3 and stage-4
     shapes, with offsets past +-2 px and off the image, with times;
  5. K3/K4 (msda_bwd) against autograd through the plain msda at K1's three
     shapes, with times;
  6. K5/K6 (dcn_im2col, dcn_col2im) and the DCN backward they make with two
     matrix products, against autograd through the plain DCN at K2's shapes,
     with times of each kernel alone;
  7. training: bevformer_base at full size with seeded weights takes 4
     AdamW steps (`Trainer.step`, train mode: dropout and GridMask on) on a
     seeded synthetic batch of queue 4 (3 history frames without gradient,
     then the trained frame). It prints each step's loss, grad norm, lr and
     seconds, the median of steps 1-3 and the peak memory, checks finite
     losses, launches of all five kernels in every step, frozen parameters
     bitwise unchanged and trainable ones moved, and profiles one more step;
  8. training witness, in eval mode at full size (the plain path's msda and
     DCN calls recompute their gathers in backward under
     torch.utils.checkpoint, so that its autograd fits the card): loss and
     per-group gradients (backbone, neck, encoder, decoder, head) of the
     kernel path against the plain path, within 10x of the plain path with
     fp32-sized noise on every msda and DCN output and input gradient, and,
     with the reg branches' outputs x0.1, loss and transformer-side groups
     to 1e-3 (the backbone again within 10x of the noisy path: ReLU inputs
     within rounding of 0 flip between paths, which the damping does not
     reach);
  9. the inference slice: bevformer_base (R101-DCN, 6 x 928 x 1600, fp32)
     with seeded weights runs a 4-frame synthetic video through
     `VideoEvaluator.run` (frames 0-2 one scene, frame 3 a new one). It
     checks 18 K1 and 26 K2 launches per frame and finite outputs. The
     same video through the plain versions: at these weights the kernel
     path stays as close to the plain path as the plain path with fp32-sized
     noise on its msda and DCN outputs does (a witness of how far rounding
     alone moves the outputs); with the reg branches' output layers scaled
     by 0.1, bev_embed, cls and bbox agree to 1e-3;
  10. profile: one frame that carries prev_bev under torch.profiler, its
     device busy share and the ops that take the device time.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Any failure raises and exits nonzero;
without a CUDA device the script exits nonzero at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))

# per-frame launches on bevformer_base: 6 TSA + 6 SCA + 6 decoder msda, and
# the DCN conv2 of the 23 + 3 blocks of stages 3-4
K1_PER_FRAME = 18
K2_PER_FRAME = 26
FRAMES = (3, 1)  # scene lengths
# per training step (queue 4): K1 in 3 history frames (encoder only, 12
# each) and the trained frame (18); K2 in one backbone pass over the 18
# history images and one over the trained frame's 6; the backward kernels
# once per K1 / K2 call of the trained frame
TRAIN_PER_STEP = dict(msda_fwd=3 * 12 + 18, dcn_conv_fwd=2 * 26, msda_bwd=18,
                      dcn_im2col=26, dcn_col2im=26)
TRAIN_STEPS = 4
TRAIN_TOTAL_STEPS = 1000  # length of the lr schedule the steps run on

K1_TOL = 1e-5  # max abs error on N(0, 1) values and softmaxed weights
K2_TOL = 1e-4  # max abs error over max |plain|: fp32 sums of 9*C terms
K34_TOL = 1e-4  # max abs err over max |plain| of dValue, dLoc, dAttw
K56_TOL = 1e-4  # max abs err over max |plain| of dx, d off_y, d off_x, dmask, dW
SLICE_TOL = 1e-3  # max abs error over max |plain| of bev_embed, cls, bbox
TRAIN_TOL = 1e-3  # loss, and ||kernel - plain|| / ||plain|| of each gradient group
WITNESS_NOISE = 1e-6  # relative noise on the plain msda and DCN outputs
WITNESS_FACTOR = 10.0  # kernel vs plain within this multiple of noisy vs plain
PROFILE_ROWS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


class Failure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise Failure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, b) -> float:
    scale = max(float(b.abs().max()), 1e-6)
    return float((a - b).abs().max()) / scale


# ---------------------------------------------------------------- kernels

def msda_inputs(b, q, h, d, shapes, p, gen, device):
    import torch

    k = sum(hh * ww for hh, ww in shapes)
    value = torch.randn((b, k, h, d), generator=gen, device=device)
    # locations spill out of [0, 1] on every side
    loc = torch.rand((b, q, h, len(shapes), p, 2), generator=gen, device=device) * 1.2 - 0.1
    logits = torch.randn((b, q, h, len(shapes) * p), generator=gen, device=device)
    attw = logits.softmax(-1).view(b, q, h, len(shapes), p).contiguous()
    return value, loc, attw


def check_k1(device, gen):
    import torch
    from bevformer_torch.kernels import msda

    levels = ((116, 200), (58, 100), (29, 50), (15, 25))
    # (name, B, Q, H, D, shapes, P, launches per frame)
    cases = [
        ("tsa", 2, 40000, 8, 32, ((200, 200),), 4, 6),
        ("sca", 6, 10112, 8, 32, levels, 8, 6),
        ("decoder", 1, 900, 8, 32, ((200, 200),), 4, 6),
    ]
    rows = []
    for name, b, q, h, d, shapes, p, per_frame in cases:
        args = msda_inputs(b, q, h, d, shapes, p, gen, device)
        out = msda.ms_deform_attn(args[0], shapes, args[1], args[2])
        ref = msda.ms_deform_attn_plain(args[0], shapes, args[1], args[2])
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        outside = float(((args[1] < 0) | (args[1] > 1)).float().mean())
        ms = time_ms(lambda: msda.ms_deform_attn(args[0], shapes, args[1], args[2]), 20)
        plain_ms = time_ms(lambda: msda.ms_deform_attn_plain(args[0], shapes, args[1], args[2]), 3)
        log(f"[k1] {name}: value {list(args[0].shape)} loc {list(args[1].shape)} "
            f"({outside:.1%} of coords outside [0,1]) max_abs_err {err:.3e} "
            f"(tol {K1_TOL:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        check(err <= K1_TOL, f"K1 {name}: max abs error {err} > {K1_TOL}")
        rows.append(dict(shape=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         per_frame=per_frame))
        del args, out, ref
    return rows


def check_k2(device, gen):
    import torch
    from bevformer_torch.kernels import dcn

    # (name, B, H, W, C, Cout, launches per frame); stride 1 (caffe style)
    cases = [("layer3", 6, 58, 100, 256, 256, 23), ("layer4", 6, 29, 50, 512, 512, 3)]
    rows = []
    for name, b, h, w, c, cout, per_frame in cases:
        x = torch.randn((b, h, w, c), generator=gen, device=device)
        off_y = torch.randn((b, h, w, 9), generator=gen, device=device) * 3
        off_x = torch.randn((b, h, w, 9), generator=gen, device=device) * 3
        mask = torch.rand((b, h, w, 9), generator=gen, device=device)
        weight = torch.randn((9 * c, cout), generator=gen, device=device) / (9 * c) ** 0.5
        args = (x, off_y, off_x, mask, weight, 1)
        out = dcn.dcn_conv(*args)
        ref = dcn.dcn_conv_plain(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        big_dy = float((off_y.abs() > 2).float().mean())
        ky = torch.arange(3, device=device).repeat_interleave(3)  # tap row
        py = torch.arange(h, device=device)[None, :, None, None] - 1 + ky + off_y
        off_img = float(((py <= -1) | (py >= h)).float().mean())
        ms = time_ms(lambda: dcn.dcn_conv(*args), 10)
        plain_ms = time_ms(lambda: dcn.dcn_conv_plain(*args), 3)
        gflop = 2.0 * b * h * w * 9 * c * cout / 1e9
        log(f"[k2] {name}: x {list(x.shape)} weight {list(weight.shape)} "
            f"(|dy|>2: {big_dy:.1%}, rows off the image: {off_img:.1%}) "
            f"max_abs_err {err:.3e} = {err / scale:.2e} of max|plain| "
            f"(tol {K2_TOL:.0e}) kernel {ms:.4f} ms ({gflop / ms:.2f} TFLOP/s) "
            f"plain {plain_ms:.4f} ms")
        check(err <= K2_TOL * scale, f"K2 {name}: error {err} > {K2_TOL} x {scale}")
        rows.append(dict(shape=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         per_frame=per_frame))
        del x, off_y, off_x, mask, weight, args, out, ref
    return rows


def check_k34(device, gen):
    import torch
    from bevformer_torch.kernels import msda

    levels = ((116, 200), (58, 100), (29, 50), (15, 25))
    # (name, B, Q, H, D, shapes, P, launches per training step)
    cases = [
        ("tsa", 2, 40000, 8, 32, ((200, 200),), 4, 6),
        ("sca", 6, 10112, 8, 32, levels, 8, 6),
        ("decoder", 1, 900, 8, 32, ((200, 200),), 4, 6),
    ]
    rows = []
    for name, b, q, h, d, shapes, p, per_step in cases:
        value, loc, attw = msda_inputs(b, q, h, d, shapes, p, gen, device)
        g = torch.randn((b, q, h * d), generator=gen, device=device)
        ours = msda.ms_deform_attn_backward(value, shapes, loc, attw, g)
        ref = msda.ms_deform_attn_backward_plain(value, shapes, loc, attw, g)
        torch.cuda.synchronize()
        errs = {k: rel_err(a, r) for k, a, r in zip(("dvalue", "dloc", "dattw"), ours, ref)}
        del ours, ref
        ms = time_ms(lambda: msda.ms_deform_attn_backward(value, shapes, loc, attw, g), 10)
        plain_ms = time_ms(
            lambda: msda.ms_deform_attn_backward_plain(value, shapes, loc, attw, g), 2)
        log(f"[k3k4] {name}: value {list(value.shape)} loc {list(loc.shape)} "
            f"max abs err / max |plain|: {fmt_errors(errs)} (tol {K34_TOL:.0e}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        for k, e in errs.items():
            check(e <= K34_TOL, f"msda_bwd {name} {k}: {e:.2e} > {K34_TOL}")
        rows.append(dict(shape=name, max_abs_err=max(errs.values()), ms=ms,
                         plain_ms=plain_ms, per_step=per_step))
        del value, loc, attw, g
    return rows


def check_k56(device, gen):
    import torch
    from bevformer_torch.kernels import dcn

    cases = [("layer3", 6, 58, 100, 256, 256, 23), ("layer4", 6, 29, 50, 512, 512, 3)]
    im2col_rows, col2im_rows = [], []
    for name, b, h, w, c, cout, per_step in cases:
        x = torch.randn((b, h, w, c), generator=gen, device=device)
        off_y = torch.randn((b, h, w, 9), generator=gen, device=device) * 3
        off_x = torch.randn((b, h, w, 9), generator=gen, device=device) * 3
        mask = torch.rand((b, h, w, 9), generator=gen, device=device)
        weight = torch.randn((9 * c, cout), generator=gen, device=device) / (9 * c) ** 0.5
        g = torch.randn((b, h, w, cout), generator=gen, device=device)
        gm = g.view(-1, cout)

        def kernel_bwd():
            cols = dcn.dcn_im2col(x, off_y, off_x, mask)
            dweight = cols.t() @ gm
            del cols
            return (*dcn.dcn_col2im(x, off_y, off_x, mask, gm @ weight.t()), dweight)

        ours = kernel_bwd()
        ref = dcn.dcn_conv_backward_plain(x, off_y, off_x, mask, weight, g)
        cols_err = rel_err(dcn.dcn_im2col(x, off_y, off_x, mask),
                           dcn.dcn_im2col_plain(x, off_y, off_x, mask))
        torch.cuda.synchronize()
        names = ("dx", "doff_y", "doff_x", "dmask", "dweight")
        errs = {k: rel_err(a, r) for k, a, r in zip(names, ours, ref)}
        del ours, ref
        dcols = torch.randn((b * h * w, 9 * c), generator=gen, device=device)
        im2col_ms = time_ms(lambda: dcn.dcn_im2col(x, off_y, off_x, mask), 10)
        im2col_plain_ms = time_ms(lambda: dcn.dcn_im2col_plain(x, off_y, off_x, mask), 3)
        col2im_ms = time_ms(lambda: dcn.dcn_col2im(x, off_y, off_x, mask, dcols), 10)
        col2im_plain_ms = time_ms(
            lambda: dcn.dcn_col2im_plain(x, off_y, off_x, mask, dcols), 3)
        bwd_ms = time_ms(kernel_bwd, 5)
        bwd_plain_ms = time_ms(
            lambda: dcn.dcn_conv_backward_plain(x, off_y, off_x, mask, weight, g), 2)
        log(f"[k5k6] {name}: x {list(x.shape)} weight {list(weight.shape)} "
            f"im2col max abs err / max |plain| {cols_err:.2e}; backward: {fmt_errors(errs)} "
            f"(tol {K56_TOL:.0e}); dcn_im2col {im2col_ms:.4f} ms (plain {im2col_plain_ms:.4f}), "
            f"dcn_col2im {col2im_ms:.4f} ms (plain {col2im_plain_ms:.4f}), whole backward "
            f"(im2col + 2 matmuls + col2im) {bwd_ms:.4f} ms (plain autograd {bwd_plain_ms:.4f})")
        check(cols_err <= K56_TOL, f"dcn_im2col {name}: {cols_err:.2e} > {K56_TOL}")
        for k, e in errs.items():
            check(e <= K56_TOL, f"DCN backward {name} {k}: {e:.2e} > {K56_TOL}")
        im2col_rows.append(dict(shape=name, max_abs_err=cols_err, ms=im2col_ms,
                                plain_ms=im2col_plain_ms, per_step=per_step))
        col2im_rows.append(dict(shape=name, max_abs_err=max(errs.values()), ms=col2im_ms,
                                plain_ms=col2im_plain_ms, per_step=per_step,
                                backward_ms=bwd_ms, backward_plain_ms=bwd_plain_ms))
        del x, off_y, off_x, mask, weight, g, gm, dcols
    return im2col_rows, col2im_rows


# ---------------------------------------------------------------- slice

class TimedFrames:
    """The video, stamping the host clock (after a device sync) when each
    frame is requested: frame i took stamps[i + 1] - stamps[i]."""

    def __init__(self, video):
        self.video = video
        self.stamps = []

    def __len__(self):
        return len(self.video)

    def get_test_sample(self, i):
        import torch

        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        return self.video.get_test_sample(i)

    def frame_seconds(self):
        import torch

        torch.cuda.synchronize()
        stamps = self.stamps + [time.perf_counter()]
        return [b - a for a, b in zip(stamps, stamps[1:])]


@contextmanager
def plain_kernels(noise: float = 0.0, seed: int = 0, recompute: bool = False):
    """Route the model's two kernel call sites to the plain versions (their
    gradients then come from autograd). With `noise`, each output is
    multiplied by (1 + noise * N(0, 1)), and so is each gradient that flows
    back into their inputs: a perturbation of the size of a few fp32
    roundings. With `recompute`, each plain call runs under
    `torch.utils.checkpoint`: autograd recomputes its gathers in backward
    instead of keeping them (the SCA's alone are ~8 GB per encoder layer),
    with the same arithmetic."""
    import torch
    import torch.utils.checkpoint
    from bevformer_torch.kernels import dcn, msda
    from bevformer_torch.models import attention, resnet

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def jitter(t):
        return t * torch.randn(t.shape, generator=gen, device=t.device) * noise

    class GradNoise(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, grad):
            return grad + jitter(grad)

    def perturbed(fn):
        def call(*args):
            if noise:
                args = [GradNoise.apply(a) if torch.is_tensor(a) and a.requires_grad else a
                        for a in args]
            if recompute and torch.is_grad_enabled():
                out = torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
            else:
                out = fn(*args)
            return out + jitter(out) if noise else out
        return call

    saved = attention.ms_deform_attn, resnet.dcn_conv
    attention.ms_deform_attn = perturbed(msda.ms_deform_attn_plain)
    resnet.dcn_conv = perturbed(dcn.dcn_conv_plain)
    try:
        yield
    finally:
        attention.ms_deform_attn, resnet.dcn_conv = saved


def damp_box_refinement(model) -> None:
    """Scale the output layer of every reg branch by 0.1, for the kernel-vs-plain
    comparison only. Each decoder layer samples the BEV map at the
    reference points that the layer before refined, and random BEV features
    have no spatial smoothness: at full-size random refinements two fp32
    computations of the same frame drift apart (the witness in
    `check_slice` measures by how much)."""
    import torch

    with torch.no_grad():
        for branch in model.pts_bbox_head.reg_branches:
            branch[-1].weight.mul_(0.1)


def output_errors(preds, ref_preds):
    """Per key, max over frames of max abs err / max |ref|."""
    return {
        key: max(rel_err(a[key], b[key]) for a, b in zip(preds, ref_preds))
        for key in ("bev_embed", "all_cls_scores", "all_bbox_preds")
    }


def fmt_errors(errs) -> str:
    return ", ".join(f"{k} {e:.2e}" for k, e in errs.items())


def run_video(model, video):
    from bevformer_torch.runtime import VideoEvaluator

    preds = []
    hook = model.register_forward_hook(lambda m, i, out: preds.append(out))
    frames = TimedFrames(video)
    try:
        results = VideoEvaluator(model).run(frames, progress_every=0)
    finally:
        hook.remove()
    return results, preds, frames.frame_seconds()


def check_slice(device, smi):
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.data import SyntheticVideo
    from bevformer_torch.kernels import dcn, msda
    from bevformer_torch.runtime import build_model, init_state_dict

    cfg = get_config("bevformer_base")
    t0 = time.perf_counter()
    model = build_model(cfg, init_state_dict(cfg, seed=0), device)
    video = SyntheticVideo(cfg, scene_lengths=FRAMES, seed=0, device=device)
    n = len(video)
    log(f"[slice] {cfg.name}: {cfg.data.num_cams} x {cfg.data.img_size} images, "
        f"R{cfg.backbone_depth} DCN stages {cfg.backbone_dcn_stages}, "
        f"{cfg.encoder_layers}+{cfg.decoder_layers} layers, BEV {cfg.bev_h}x{cfg.bev_w}, "
        f"{n} frames (scenes {FRAMES}); weights ready in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    results, preds, secs = run_video(model, video)
    counts = read_counts()
    k1, k2 = counts["msda_fwd"], counts["dcn_conv_fwd"]
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[slice] launches: K1 {k1} ({k1 / n:g}/frame), K2 {k2} ({k2 / n:g}/frame)")
    check(counts["msda_bwd"] == counts["dcn_im2col"] == counts["dcn_col2im"] == 0,
          f"inference launched a backward kernel: {counts}")
    check(k1 == K1_PER_FRAME * n, f"K1 launched {k1} times, expected {K1_PER_FRAME * n}")
    check(k2 == K2_PER_FRAME * n, f"K2 launched {k2} times, expected {K2_PER_FRAME * n}")
    for i, p in enumerate(preds):
        for key, v in p.items():
            check(bool(torch.isfinite(v).all()), f"frame {i}: {key} not finite")
    cls_shape = (cfg.decoder_layers, 1, cfg.num_query, cfg.num_classes)
    check(tuple(preds[0]["all_cls_scores"].shape) == cls_shape,
          f"cls shape {tuple(preds[0]['all_cls_scores'].shape)}")
    check(tuple(preds[0]["bev_embed"].shape) == (1, cfg.bev_h * cfg.bev_w, cfg.embed_dims),
          f"bev shape {tuple(preds[0]['bev_embed'].shape)}")
    check([r["token"] for r in results] == [video.frames[i]["token"] for i in range(n)],
          "frame tokens out of order")
    steady = sorted(secs[1:])
    median = steady[len(steady) // 2]
    log(f"[slice] frame seconds: {', '.join(f'{s:.4f}' for s in secs)}; "
        f"median of frames 1-{n - 1}: {median * 1e3:.1f} ms; "
        f"peak memory {peak / 2**30:.2f} GiB; card: {smi}")

    # witness, at these weights: the kernel path against the plain path, and
    # the plain path against itself with fp32-sized noise on every msda and
    # DCN output. Two computations that differ only in rounding drift apart
    # as far as the noisy one does; a kernel that sampled wrong would not
    # stay within WITNESS_FACTOR of it.
    with plain_kernels():
        _, plain_preds, plain_secs = run_video(model, video)
    with plain_kernels(noise=WITNESS_NOISE):
        _, noisy_preds, _ = run_video(model, video)
    check(msda.ms_deform_attn.launches == k1 and dcn.dcn_conv.launches == k2,
          "the plain run launched a kernel")
    kernel_errs = output_errors(preds, plain_preds)
    noise_errs = output_errors(noisy_preds, plain_preds)
    log(f"[slice] witness at these weights, max abs err / max |plain| over the frames: "
        f"kernel vs plain: {fmt_errors(kernel_errs)}; plain x (1 + {WITNESS_NOISE:.0e} "
        f"N(0,1)) at every msda and DCN output vs plain: {fmt_errors(noise_errs)} "
        f"(kernel must stay within {WITNESS_FACTOR:g}x); plain frame seconds: "
        + ", ".join(f"{s:.4f}" for s in plain_secs))
    for key, e in kernel_errs.items():
        check(e <= WITNESS_FACTOR * max(noise_errs[key], 1e-7),
              f"{key}: kernel vs plain {e:.2e} > {WITNESS_FACTOR:g} x {noise_errs[key]:.2e}")

    # the stated tolerance, on weights whose box refinements are damped so
    # that rounding does not grow through the decoder
    damp_box_refinement(model)
    results, preds, _ = run_video(model, video)
    with plain_kernels():
        plain_results, plain_preds, _ = run_video(model, video)
    errs = output_errors(preds, plain_preds)
    log(f"[slice] reg branch outputs x0.1: kernel vs plain, max abs err / max |plain| "
        f"over the frames: {fmt_errors(errs)} (tol {SLICE_TOL:.0e})")
    for key, e in errs.items():
        check(e <= SLICE_TOL, f"{key}: kernel vs plain {e:.2e} > {SLICE_TOL}")
    for i in range(n):
        sa = torch.as_tensor(results[i]["scores_3d"]).sort().values
        sb = torch.as_tensor(plain_results[i]["scores_3d"]).sort().values
        check(sa.shape == sb.shape and bool(torch.allclose(sa, sb, atol=1e-4)),
              f"frame {i}: decoded scores differ")
    return dict(k1=k1, k2=k2, median_ms=median * 1e3, peak_gib=peak / 2**30,
                model=model, video=video)


KERNEL_NAMES = ("msda_fwd_kernel", "dcn_conv_fwd_kernel", "msda_bwd_kernel",
                "dcn_im2col_kernel", "dcn_col2im_kernel")


def profile_run(fn, tag, what, smi):
    """Run `fn` once under torch.profiler: wall time, device kernel time,
    busy share, and the ops that take the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, f"the profiled {what} ran nothing on the device")
    # device time by the aten op that launched it; the port's kernels are
    # launched through ctypes, under no aten op
    rows = [
        (a.key, a.self_device_time_total / 1e3, a.count)
        for a in prof.key_averages()
        if a.self_device_time_total > 0
        and (a.key.startswith("aten::") or any(k in a.key for k in KERNEL_NAMES))
    ]
    rows.sort(key=lambda r: -r[1])
    log(f"[{tag}] {what}: wall {wall_ms:.2f} ms (profiler on), device kernel time "
        f"{busy_ms:.2f} ms in {len(kernels)} kernels, busy {busy_ms / wall_ms:.1%}, "
        f"idle {1 - busy_ms / wall_ms:.1%}; card: {smi}")
    for name, ms, count in rows[:PROFILE_ROWS]:
        log(f"[{tag}]   {ms:9.3f} ms {ms / busy_ms:6.1%} {count:5d} calls  {name[:70]}")


def profile_frame(model, video, smi):
    """One frame that carries prev_bev (frame 2 of the first scene) under
    torch.profiler."""
    from bevformer_torch.runtime import VideoEvaluator

    ev = VideoEvaluator(model)
    ev.infer_frame(video.get_test_sample(0))
    ev.infer_frame(video.get_test_sample(1))
    sample = video.get_test_sample(2)
    profile_run(lambda: ev.infer_frame(sample), "profile", "frame 2", smi)


# ---------------------------------------------------------------- training

def kernel_counters():
    from bevformer_torch.kernels import dcn, msda

    return dict(msda_fwd=msda.ms_deform_attn, dcn_conv_fwd=dcn.dcn_conv,
                msda_bwd=msda.ms_deform_attn_backward, dcn_im2col=dcn.dcn_im2col,
                dcn_col2im=dcn.dcn_col2im)


def read_counts():
    return {k: fn.launches for k, fn in kernel_counters().items()}


def zero_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def check_training(device, smi):
    """bevformer_base at full size: TRAIN_STEPS train-mode steps."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.data import train_batch
    from bevformer_torch.runtime import Trainer, build_model, init_state_dict

    cfg = get_config("bevformer_base")
    t0 = time.perf_counter()
    model = build_model(cfg, init_state_dict(cfg, seed=0), device)
    trainer = Trainer(model, total_steps=TRAIN_TOTAL_STEPS, seed=0)
    batch = train_batch(cfg, seed=0, device=device)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    log(f"[train] {cfg.name}: batch 1, queue {cfg.data.queue_length} "
        f"({cfg.data.queue_length - 1} history frames without gradient), "
        f"{cfg.data.num_cams} x {cfg.data.img_size} images, {int(batch.num_gt[0])} GT boxes, "
        f"{sum(p.numel() for p in trainer.params)} trainable parameters "
        f"({len(frozen)} frozen tensors); ready in {time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    secs, per_step = [], []
    for step in range(TRAIN_STEPS):
        start = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = trainer.step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        per_step.append({k: v - start[k] for k, v in read_counts().items()})
        log(f"[train] step {step}: loss {out['total']:.4f} (cls {out['loss_cls']:.4f}, "
            f"bbox {out['loss_bbox']:.4f}), grad_norm {out['grad_norm']:.3f}, "
            f"lr {out['lr']:.4e}, {secs[-1]:.4f} s, launches {per_step[-1]}")
        check(all(math.isfinite(v) for v in out.values()), f"step {step}: not finite: {out}")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    for step, c in enumerate(per_step):
        check(c == TRAIN_PER_STEP, f"step {step} launched {c}, expected {TRAIN_PER_STEP}")
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        check(same == (name in frozen), f"{name}: {'moved' if not same else 'did not move'}")
    for name, buf in model.named_buffers():
        check(torch.equal(buf, before[name]), f"buffer {name} moved")
    steady = sorted(secs[1:])
    median = steady[len(steady) // 2]
    log(f"[train] step seconds: {', '.join(f'{x:.4f}' for x in secs)}; median of steps "
        f"1-{TRAIN_STEPS - 1}: {median * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} GiB; "
        f"frozen parameters unchanged, trainable ones moved; card: {smi}")
    profile_run(lambda: trainer.step(batch), "train-profile", f"step {TRAIN_STEPS}", smi)
    del trainer, model, batch, before
    return dict(counts=counts, median_ms=median * 1e3, peak_gib=peak / 2**30)


GROUPS = (("backbone", "img_backbone."), ("neck", "img_neck."),
          ("encoder", "pts_bbox_head.transformer.encoder."),
          ("decoder", "pts_bbox_head.transformer.decoder."), ("head", ""))


def group_of(name: str) -> str:
    return next(g for g, prefix in GROUPS if name.startswith(prefix))


def train_grads(model, batch):
    """Eval-mode loss and its gradients, concatenated per group."""
    import torch
    from bevformer_torch.runtime import loss_fn

    model.zero_grad(set_to_none=True)
    total, _ = loss_fn(model.eval(), batch)
    total.backward()
    grads = {}
    for g, _ in GROUPS:
        parts = [p.grad.reshape(-1) for n, p in model.named_parameters()
                 if p.requires_grad and group_of(n) == g]
        grads[g] = torch.cat(parts)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return float(total.detach()), grads


def grad_errors(run, ref):
    """Loss relative error and ||a - b|| / ||b|| per gradient group."""
    errs = {"loss": abs(run[0] - ref[0]) / max(abs(ref[0]), 1e-12)}
    for g, b in ref[1].items():
        errs[g] = float((run[1][g] - b).norm() / b.norm().clamp(min=1e-12))
    return errs


def check_training_witness(device, smi):
    """Kernel path against plain path, eval mode, at full size (the plain
    calls recompute their gathers in backward, so that they fit the card)."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.data import train_batch
    from bevformer_torch.runtime import build_model, init_state_dict, label_params

    cfg = get_config("bevformer_base")
    model = build_model(cfg, init_state_dict(cfg, seed=0), device)
    labels = label_params(model, cfg.optim.frozen_stages)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    batch = train_batch(cfg, seed=1, device=device)
    log(f"[witness] {cfg.name} at {cfg.data.num_cams} x {cfg.data.img_size} images, "
        f"queue {cfg.data.queue_length}, eval mode; errors are |loss| relative and "
        f"||kernel - plain|| / ||plain|| of each gradient group")

    def runs():
        kernel = train_grads(model, batch)
        counts = read_counts()
        torch.cuda.reset_peak_memory_stats(device)
        with plain_kernels(recompute=True):
            plain = train_grads(model, batch)
        peak = torch.cuda.max_memory_allocated(device)
        check(read_counts() == counts, "the plain run launched a kernel")
        return kernel, plain, peak

    kernel, plain, peak = runs()
    with plain_kernels(noise=WITNESS_NOISE, recompute=True):
        noisy = train_grads(model, batch)
    kernel_errs, noise_errs = grad_errors(kernel, plain), grad_errors(noisy, plain)
    log(f"[witness] undamped: kernel vs plain: {fmt_errors(kernel_errs)}; plain x (1 + "
        f"{WITNESS_NOISE:.0e} N(0,1)) at every msda and DCN output and input gradient vs "
        f"plain: {fmt_errors(noise_errs)} (kernel must stay within {WITNESS_FACTOR:g}x); "
        f"plain path peak memory {peak / 2**30:.2f} GiB; card: {smi}")
    for key, e in kernel_errs.items():
        check(e <= WITNESS_FACTOR * max(noise_errs[key], 1e-7),
              f"{key}: kernel vs plain {e:.2e} > {WITNESS_FACTOR:g} x {noise_errs[key]:.2e}")

    # damped, the decoder no longer amplifies rounding: the loss and the
    # transformer-side groups are held to TRAIN_TOL. The backbone's gradient
    # still moves where one of its ~1e8 ReLU inputs sits within fp32
    # rounding of 0 and flips between the two paths, which the damping does
    # not reach: it is held to the noisy witness, as undamped
    damp_box_refinement(model)
    kernel, plain, _ = runs()
    with plain_kernels(noise=WITNESS_NOISE, recompute=True):
        noisy = train_grads(model, batch)
    errs, noise_errs = grad_errors(kernel, plain), grad_errors(noisy, plain)
    log(f"[witness] reg branch outputs x0.1: kernel vs plain: {fmt_errors(errs)} "
        f"(tol {TRAIN_TOL:.0e}; backbone within {WITNESS_FACTOR:g}x of noisy); noisy plain vs "
        f"plain: {fmt_errors(noise_errs)}")
    for key, e in errs.items():
        limit = WITNESS_FACTOR * max(noise_errs[key], 1e-7) if key == "backbone" else TRAIN_TOL
        check(e <= limit, f"{key}: kernel vs plain {e:.2e} > {limit:.2e}")
    del model, batch, kernel, plain, noisy
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is required ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bevformer_torch.kernels import build

    device = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for fp32 matmuls and cuDNN convolutions")

    res = build.build()
    log(f"[build] {'built' if res.built else 'found'} {os.path.relpath(str(res.path), ROOT)} "
        f"from {[os.path.relpath(str(s), ROOT) for s in build.sources()]} "
        f"({' '.join(build.NVCC_FLAGS)}) in {res.seconds:.1f} s")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    build.library()

    gen = torch.Generator(device=device).manual_seed(0)
    k1_rows = check_k1(device, gen)
    k2_rows = check_k2(device, gen)
    k34_rows = check_k34(device, gen)
    im2col_rows, col2im_rows = check_k56(device, gen)
    torch.cuda.empty_cache()
    tr = check_training(device, smi)
    torch.cuda.empty_cache()
    check_training_witness(device, smi)
    torch.cuda.empty_cache()
    sl = check_slice(device, smi)
    profile_frame(sl["model"], sl["video"], smi)

    def record(name, src, replaces, rows, per):
        return dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=tr["counts"][name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            # one frame's (forward kernels) or one training step's (backward
            # kernels) worth of launches at the path's shapes
            ms=sum(r["ms"] * r[per] for r in rows),
            plain_ms=sum(r["plain_ms"] * r[per] for r in rows),
            shapes=rows,
        )

    kernels = [
        record("msda_fwd", "bevformer_torch/csrc/msda_fwd.cu",
               "bevformer_tpu/kernels/msda_hi.py:243", k1_rows, "per_frame"),
        record("dcn_conv_fwd", "bevformer_torch/csrc/dcn_conv_fwd.cu",
               "bevformer_tpu/kernels/dcn_pallas.py:329", k2_rows, "per_frame"),
        record("msda_bwd", "bevformer_torch/csrc/msda_bwd.cu",
               "bevformer_tpu/kernels/msda_hi.py:744", k34_rows, "per_step"),
        record("dcn_im2col", "bevformer_torch/csrc/dcn_im2col.cu",
               "bevformer_tpu/kernels/dcn_pallas.py:112", im2col_rows, "per_step"),
        record("dcn_col2im", "bevformer_torch/csrc/dcn_col2im.cu",
               "bevformer_tpu/kernels/msda_pallas.py:318", col2im_rows, "per_step"),
    ]
    # launches: the training run's (all five kernels); the inference run's too
    kernels[0]["inference_launches"] = sl["k1"]
    kernels[1]["inference_launches"] = sl["k2"]
    log(f"[summary] training step median {tr['median_ms']:.1f} ms, peak {tr['peak_gib']:.2f} GiB; "
        f"inference frame median {sl['median_ms']:.1f} ms, peak {sl['peak_gib']:.2f} GiB; "
        f"on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
