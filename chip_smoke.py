#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printed as it runs:
  1. device: the card's name and power limit (nvidia-smi); TF32 off for
     fp32 matmuls and convolutions (the entry points turn it off around the
     model themselves: phase 10 checks it);
  2. build: nvcc compiles bevformer_torch/csrc/*.cu for sm_90a;
  3. K1 (msda_fwd) against its plain PyTorch version at the three shapes of
     the inference path (TSA, SCA, decoder), with times, the share of
     outputs bitwise equal to the plain version's, its corner-request rate
     (corner rows x 128 B over the time) and, as a yardstick, K7
     (msda_fwd_ho) at the same shapes; then the same at a BEVFormerV2
     sample's shapes (SCA over the 4 levels of a 640 x 1600 input), with
     each shape's bound and share of it; then at V2 training's new shapes
     (`[k1-v2-train]`: the decoder over 900 x 11 GroupDETR queries, SCA
     over the 768 rung's levels);
  4. K2 (dcn_conv_fwd) against its plain version at the stage-3 and stage-4
     shapes, with offsets past +-2 px and off the image, with times, its
     TFLOP/s, the error of both against a float64 product and, as a
     yardstick, the two-call composition dcn_im2col + torch.matmul (fp32,
     TF32 off) of the same function; then the dense conv kernel
     (conv_fwd, `kernels.conv.conv2d_nhwc`) against its plain version
     (cuDNN fp32, TF32 off, then the affine, the residual and the ReLU) on
     the same inputs at each distinct shape and epilogue a frame of
     bevformer_base and of bevformerv2-r50-t8 gives it (`models.conv_sites`),
     both against F.conv2d in fp64 (the kernel within 2x the plain
     version's error), with times, TFLOP/s and the bound;
  5. K3/K4 (msda_bwd) against autograd through the plain msda at K1's three
     shapes, and at SCA's also on y-coherent locations as the kernel tools
     build them (their corners collide in the atomics), with times, the
     corner rows read and the 16-byte atomic adds made per call and their
     rates; then bf16 K1 and K3/K4 (msda_fwd_bf16,
     msda_bwd_bf16: a bf16 value and grad_out, fp32 sums, a bf16 output and
     dValue) against their plain versions at bevformer_tiny_fp16's three
     shapes and at bevformer_base's three (output and dValue within one
     bf16 ulp at their scale, dLoc and dAttw 1e-3), with times, bounds at
     bf16's 2-byte value rows, launches a frame and a step, and at base's
     shapes the fp32 entries' times on the same value in fp32; and K3/K4 at
     V2 training's two new shapes;
  6. K5/K6 (dcn_im2col, dcn_col2im) and the DCN backward they make with two
     matrix products, against autograd through the plain DCN at K2's shapes,
     with times of each kernel alone, K5's share of its bound and the share
     of its column bitwise equal to the plain version's; K6's share of its
     bound, the bytes it adds into dx through global atomics and their rate,
     and, as a yardstick, ATen's grid_sampler_2d_backward on the same
     sampling (dx and the position gradient; with grid_sampler_2d and a
     channel dot for dmask, the two-call composition of K6's function);
     then bf16 K2, K5 and K6 (dcn_conv_fwd_bf16, dcn_im2col_bf16: a bf16
     x, fp32 sums, a bf16 output and column; dcn_col2im_gw: the bf16
     backward's sampling half from the bf16 output gradient and the
     weight, its column gradient made on the tensor cores inside the
     kernel, a bf16 dx) against their plain versions at bevformer_base's
     and bevformer_small's DCN stages (output, column and dx within one
     bf16 ulp at their scale, d offsets, dmask and dWeight 1e-3, bf16 K6's
     d offsets and dmask bitwise the same in a second launch; the whole
     bf16 DCN gradient against autograd through the plain conv), with
     times, bounds at bf16's 2-byte tensors, bf16 K6's dx adds, and the
     yardsticks (K5 bf16 + a bf16 cuBLAS product; for bf16 K6 ATen's
     grid_sampler_2d_backward on bf16, and the fp32 product g W^T alone
     that the earlier route ran before K6); bf16 K2's column (its output for
     the identity weight) bitwise the plain one, its persistent grid as
     the launch records it (blocks, tiles per SM), and bf16 K2 at ragged shapes (M no multiple
     of 64, Cout 40 and 320, C 32 and 96, stride 2, x on an 8-byte
     boundary) within one bf16 ulp; then the build's SASS (read on the
     host since the build) must hold K3/K4's dValue adds (the bf16
     entry's too) and bf16 K6's dx adds as 16-byte vector reductions;
  7. probes: the kernel benchmark and probe tools (bevformer_torch/tools),
     each through its `main` at bevformer_base's full SCA width (and TSA's
     for K1's cost split): K7 (msda_fwd_ho) against K1, bf16 K1 and K3/K4
     and the plain msda on y-coherent (K7 and K1 also y-incoherent)
     inputs, K7's tile and accumulator sweep,
     the cost split (gather, weights, noop) of K7 and of K1, both kernels at
     SCA's level 0 alone, and the row gather against take_along_dim; every
     case held against its plain version (msda 1e-5 max abs, bf16 msda one
     bf16 ulp at max |plain|, modes 1e-5 of scale, the gather bitwise),
     every new kernel launched;
  8. training: bevformer_base at full size with seeded weights takes 4
     AdamW steps (`Trainer.step`, train mode: dropout and GridMask on) on a
     seeded synthetic batch of queue 4 (3 history frames without gradient,
     then the trained frame). It prints each step's loss, grad norm, lr and
     seconds, the median of steps 1-3 and the peak memory, checks finite
     losses, launches of all five kernels in every step, frozen parameters
     bitwise unchanged and trainable ones moved, and profiles one more step.
     One more step records what its backward hands K6 (the offsets and
     masks of the model's offset convs, the column gradients): K6 on each
     recorded call alone, timed, its dx adds counted, held against the
     plain version;
  9. training witness, in eval mode at full size (the plain path's msda and
     DCN calls recompute their gathers in backward under
     torch.utils.checkpoint, so that its autograd fits the card): loss and
     per-group gradients (backbone, neck, encoder, decoder, head) of the
     kernel path against the plain path, within 10x of the plain path with
     fp32-sized noise on every msda and DCN output and input gradient, and,
     with the reg branches' outputs x0.1, loss and transformer-side groups
     to 1e-3 (the backbone again within 10x of the noisy path: ReLU inputs
     within rounding of 0 flip between paths, which the damping does not
     reach), on a batch at which the noisy path itself stays within 1e-3
     damped (checked);
  10. the inference slice: bevformer_base (R101-DCN, 6 x 928 x 1600, fp32)
     with seeded weights runs a 4-frame synthetic video through
     `VideoEvaluator.run` (frames 0-2 one scene, frame 3 a new one). It
     checks 18 K1 and 26 K2 launches per frame and finite outputs. The
     same video through the plain versions: at these weights the kernel
     path stays as close to the plain path as the plain path with fp32-sized
     noise on its msda and DCN outputs does (a witness of how far rounding
     alone moves the outputs); with the reg branches' output layers scaled
     by 0.1, bev_embed, cls and bbox agree to 1e-3. Then one frame with the
     caller's TF32 flags on: its outputs equal the flags-off frame's to 1e-6
     of scale, and the flags read on again after it;
  11. profile: one frame that carries prev_bev under torch.profiler, its
     device busy share and the ops that take the device time;
  12. the CLIs, each as its own process at bevformer_base full size on one
     synthetic nuScenes-format root in a temporary directory:
     `bevformer_torch.tools.create_data synth` of 4 scenes x 4 frames x 6
     cameras at 1600 x 900 (JPEG through cv2; two train scenes, two val
     scenes), `tools.train` for 4 steps with a checkpoint, `tools.train
     --resume-from` it to 6 (mid-way through the epoch of the 8 train
     frames: the restored step, lr and generators the saved ones, steps
     0-5 each logged once), `tools.test` on the last checkpoint over the 8
     val frames. Each must exit 0 with finite losses and metrics,
     launch each kernel of its path as often as the path does (K1-K6 per
     training step, K1 and K2 per frame), and leave every key of
     `evaluate_detections` in `metrics_summary.json`. The val split's own
     ground truth scored as predictions gives mAP 1 and every TP error 0.
     It prints the step, host and data-wait medians of `train_log.jsonl`,
     the frame and load medians of `tools.test`, the NDS/mAP of the seeded
     weights and the phase's wall time; one frame's six camera decodes on
     the host, cv2 JPEG against cv2 PNG of the same pixels. The CLIs run
     through their `main(argv)`, a few a process (`run_mains`: create,
     train, resume and test; fp16 train and the tiny tests; ...). Then
     `tools.fp16.train bevformer_tiny` for 2 steps (bf16: the bf16 K1 and
     K3/K4 launches per step), and `tools.test bevformer_tiny` on its
     checkpoint with and without `--fuse-conv-bn`:
     tiny's K1 launches per frame, the same decoded boxes (scores to 1e-4,
     matched boxes to 1e-3 of scale). Then `tools.test
     bevformerv2-r50-t1-base` (a `.pth` of seeded weights, the reg
     branches' outputs x0.1; the V2 crop of the 900-row cameras) over the
     val frames with and without `--fuse-conv-bn`: 18 K1
     launches per sample, NDS/mAP (0 at seeded weights: a plumbing check),
     the same decoded boxes. Then `tools.train bevformerv2-r50-t1` (the V2
     crop, a rung of the resize ladder, the flip and GlobalRotScaleTrans
     per sample, GroupDETR, DD3D) for 4 steps with a checkpoint, resumed to
     8 (the train split's epoch) with the in-training eval at its end: 18
     K1 and 18 K3/K4 launches per step, the restored step, lr and
     generators the saved ones, its step, host and data-wait medians and
     peak. Then `tools.train bevformerv2-r50-t8` for 3 steps (8 frames of
     6 images a sample in the data thread; 102 K1 and 18 K3/K4 launches
     per step): its step, host and data-wait medians; and one frame's
     photometric distortion timed on the host and on the card. Then
     `tools.train bevformer_base --cfg-options dtype=bfloat16` for 2 steps
     and `tools.test bevformer_base --cfg-options dtype=bfloat16` on its
     checkpoint over 4 val frames: the bf16 K1-K6 launches per step and per
     frame. The root is removed;
  13. the other v1 presets, bevformer_tiny, bevformer_small and
     bevformer_tiny_fp16 (bf16), each at full size with seeded weights: the
     4-frame video on the kernel path (launches per frame, frame median,
     peak memory), held to phase 10's witness against the plain and noisy
     plain paths (noise of bf16 rounding's size, 2^-8, for tiny_fp16), 4
     training steps (launches per step, step median, peak memory), and the
     damped witness on the trained weights (fp32 to 1e-3; bf16 within 10x
     of its noisy path);
  14. BEVFormerV2: bevformerv2-r50-t1 and bevformerv2-r50-t8 at full size
     (6 x 640 x 1600, 200 x 200 BEV, 6 + 6 layers, R50 with BatchNorm, a
     5-level FPN) with seeded weights, 4 samples each through
     `VideoEvaluatorV2` (t8: 7 history frames encoded per sample, then
     ResNetFusion): K1 launches per sample (18 and 102), every BatchNorm
     in eval mode, the sample median, the ResNetFusion time from CUDA
     events around it, peak memory, and phase 10's witness against the
     plain and noisy plain paths (undamped within 10x; reg outputs x0.1 to
     1e-3, the same decoded scores);
  15. BEVFormerV2 training at full size with seeded weights
     (`Trainer.step` on `train_batch_v2`: GridMask, dropout, BatchNorm on
     batch statistics, GroupDETR's 11 groups, DD3D over 5 levels):
     bevformerv2-r50-t1 4 steps at the 640 rung (6 x 640 x 1600), then one
     at the 768 rung (6 x 768 x 1920) with its peak memory; t8 4 steps
     (7 history frames without gradient, ResNetFusion's forward and
     backward from CUDA events). Each step's losses, K1 and K3/K4
     launches (18 / 18; t8 102 / 18) and cost transfers to the host (1),
     every parameter and running statistic moved, the step median and the
     peak; then t1's training witness, as phase 9's, with dropout and
     GridMask off and BatchNorm in train mode;
  16. bevformer_base and bevformer_small at dtype=bfloat16 (bf16 K1, K2,
     K3/K4, K5 and K6), each as phase 13 runs a preset: the 4-frame video
     (bf16 launches per frame: base 18 K1, 26 K2), 4 training steps (base
     54 K1, 52 K2, 18 K3/K4, 26 K5, 26 K6), frame and step medians, peaks,
     the witness against the plain and noisy plain paths under phase 13's
     bf16 rule; bevformer_base then takes one more step with every bf16 K6
     call recorded (its offsets, masks, output gradients and weights), and
     K6 runs each call alone, timed, held against its plain version, with
     the offsets' rms and the dx adds (`[train-k6-bf16]` lines);
  17. data parallel and remat. On phase 12's root (before it is removed):
     `torchrun --nproc-per-node 1 -m bevformer_torch.tools.train
     bevformer_base` over NCCL (the process group, DDP, the rank-mean loss
     normalisers) for 4 steps against phase 12's one-process run of the
     same steps: the first step's loss terms and grad norm within 1e-3, the
     later ones reported (atomic sums and Adam's sign steps move the weights
     apart after the first step), its launches those of the path; then
     `tools.test bevformer_base` on two gloo ranks of the one card against
     one process over the root's 8 val frames (the split falls on a scene
     start): the same boxes within 1e-5. At
     the end: `bevformer_torch.tools.dp_step` over two gloo ranks of the
     card, bevformer_base for 2 steps (a further job of phase 18's base
     launch, `--then`: one torchrun start-up) and bevformerv2-r50-t1 for 1 (the
     synced BatchNorm), two samples with unequal ground-truth counts,
     GridMask and dropout off, held against one process stepping both as
     one batch (and in the other order, the witness): the first step's losses
     and grad norm within 1e-3 or 10x the witness's error, each group's
     parameter update within 10% in relative L2 or 10x the witness's, V2's
     running statistics within 1e-3 (base's second step reported: the
     ranks' reduction order moves its weights apart);
     each rank's and the process's peak and step times (gloo goes through
     the host: a plumbing check, not a speed). Then bevformer_base and
     bevformerv2-r50-t8 for 2 train-mode steps with `use_remat` off and on:
     the first step's losses and grad norm within 1e-3, K1 and K2 launches a step (the
     recomputed encoder layers and DCN blocks on top), step times and peak
     memory;
  18. the `sp` axis, the BEV queries split over gloo ranks of the one card:
     `tools.dp_step` for bevformer_base at --dp 1 --sp 2 (one sample) and
     bevformerv2-r50-t1 at --dp 2 --sp 2 (4 ranks, two samples, with
     `use_remat`), one step against one process stepping the same samples
     by phase 17's rules; per rank the launches a step, the K1 and K3/K4
     launches by call site and queries (TSA at the rank's range, SCA at
     most the capacity's rows), the peak against the one process's and the
     step time (gloo through the host: no speed); base's launch first
     encodes a frame on its 2 ranks, against this process (the BEV within
     1e-3; per rank the K1 launches, the peak and the frame's time); then
     K1 and K3/K4 at a rank's split shapes against their plain versions
     (TSA at 20000 of the 40000 queries, SCA at rank 0's packed routed
     rows);
  19. the modules no registered config builds, at full width: (a) VoVNet
     V2-99 (FrozenBN, seeded statistics, eval mode) on a 6 x 3 x 640 x 1600
     batch: its stride 8/16/32 outputs (512/768/1024 channels), the
     forward's time and peak, and the folded model (`fuse_conv_bn`) within
     1e-4 of the unfolded one; (b) MMBEVFormerLayer at its defaults (base's
     widths, SCA routing every query) on 40,000 queries, base's 6-camera
     value over 4 levels, a 200 x 200 lidar BEV and base's `point_sampling`
     of the synthetic rigs: kernel path against plain path, forward (1e-4)
     and one backward (each gradient 1e-3 in relative L2), times, peak, its
     launches counted from 0 (K1 3, K3/K4 3); then K1 and K3/K4 at the
     layer's new shapes (the lidar branch, dense SCA) against their plain
     versions with bounds; (c) BEVHead (FreeAnchor) on a 200 x 200 x 256
     BEV (800,000 anchors): forward, the loss on 12 GT boxes, backward,
     `get_bboxes(300)`, times and peak, and the same predictions on the
     CPU: the losses within 1e-5, every bag's anchors and the decoded picks
     equal in order (ties: a box outside the BEV, saturated scores); (d)
     is in phase 12: the JPEG `load_ms` and the decode times;
  20. the measuring tools (`bevformer_torch/tools`), each through its
     `main(argv)` in this process at full width with seeded weights:
     `benchmark bevformer_base --samples 4` in fp32 and in bf16 (frames/s,
     CUDA events around each frame), `bench_train_step bevformer_base
     --steps 2` (use_remat on), `bench_components bevformer_base`,
     `bench_enc_only --layers 1 6` and `--glue`, `bench_dcn` (dcn and
     plain), `bench_v2` (t1), `bench_train_v2 --iters 1` (t1),
     `bench_train2` and `bench_train_bisect` (bevformer_tiny) and
     `audit_sca_capacity`. Each must print one JSON line carrying the
     card's line; the fp32 frame median must lie within 15% of phase 10's,
     each path's launches per frame or step be the path's (K1 18 and K2 26
     a base frame), backbone + neck < BEV only < full, the encoder at 1
     layer faster than at 6, and no visible SCA query dropped on the
     synthetic rig or the example frame. Then one base frame of the
     benchmark's chain in each dtype under torch.profiler: its device
     kernel time against the tool's frame median, the device's idle share
     of a frame. Each phase's seconds are printed at the end.

The line before the last is the kernels' JSON record (bf16 K1 and K3/K4
with the launches of tiny_fp16's training run; bf16 K2, K5 and K6 with those
of bevformer_base's bf16 training run; K1 also with its launches on
the V2 presets' samples and its times at V2's shapes; K1 and K3/K4 with
their launches per V2 training step and times at V2 training's new
shapes, and with their times at a rank's split shapes and each rank's
launches by call site in phase 18's steps, and at MMBEVFormerLayer's
shapes with the layer's launches): for each kernel its
time, launches, plain version's time, bound (bevformer_torch/tools/
roofline.py, against the H100 SXM data sheet's peaks) and what bounds it,
and the time of one PyTorch call that computes the same function, or null
with the reason there is none; the last line is
`{"ok": true, "device": {...}}`. Any failure raises and exits nonzero;
without a CUDA device the script exits nonzero at once.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))

# per-frame launches on bevformer_base: 6 TSA + 6 SCA + 6 decoder msda, and
# the DCN conv2 of the 23 + 3 blocks of stages 3-4
K1_PER_FRAME = 18
K2_PER_FRAME = 26
# the dense conv kernel (`conv_fwd`): every backbone and neck conv but the
# stem, 84 a base frame (`conv_launches`)
CONV_PER_FRAME = 84
FRAMES = (3, 1)  # scene lengths
# per training step (queue 4): K1 in 3 history frames (encoder only, 12
# each) and the trained frame (18); K2 in one backbone pass over the 18
# history images and one over the trained frame's 6; the backward kernels
# once per K1 / K2 call of the trained frame; the dense conv kernel in the
# history pass and in the trained frame's frozen stage 1 (10 convs)
TRAIN_PER_STEP = dict(msda_fwd=3 * 12 + 18, dcn_conv_fwd=2 * 26, msda_bwd=18,
                      dcn_im2col=26, dcn_col2im=26, conv_fwd=CONV_PER_FRAME + 10,
                      msda_fwd_bf16=0, msda_bwd_bf16=0, dcn_conv_fwd_bf16=0, dcn_im2col_bf16=0,
                      dcn_col2im_bf16=0)
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
WITNESS_BATCH_SEED = 2  # the training witness's batch (see check_training_witness)
PROFILE_ROWS = 10
# bf16 K1's output, K3/K4's dValue, K2's output, K5's column and K6's dx:
# bf16 ulps at max |plain|
BF16_FWD_ULPS = 1
# bf16 K3/K4's dLoc and dAttw, K6's d offsets and dmask, the bf16 DCN's
# fp32 gradients: max abs err over max |plain|
BF16_AUX_TOL = 1e-3
# the other v1 presets (phase 13) and the relative noise of bf16 rounding's
# size on the bf16 preset's plain msda outputs (its witness)
PRESETS = ("bevformer_tiny", "bevformer_small", "bevformer_tiny_fp16")
# the DCN presets at dtype=bfloat16 (phase 16): bf16 K1, K2, K3/K4, K5, K6
BF16_DCN_PRESETS = ("bevformer_base", "bevformer_small")
BF16_CLI_STEPS = 2  # tools.train bevformer_base --cfg-options dtype=bfloat16
BF16_CLI_FRAMES = 4  # tools.test bevformer_base --cfg-options dtype=bfloat16 --max-samples
PRESET_TRAIN_STEPS = 4
BF16_WITNESS_NOISE = 2.0 ** -8


def log(msg: str) -> None:
    print(msg, flush=True)


class Failure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise Failure(msg)


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


# K1's shapes on bevformer_base's frame: (name, B, Q, H, D, shapes, P,
# launches per frame); SCA's Q is the capacity 0.25 of 40000 queries rounded
# up to 128
K1_CASES = [
    ("tsa", 2, 40000, 8, 32, ((200, 200),), 4, 6),
    ("sca", 6, 10112, 8, 32, ((116, 200), (58, 100), (29, 50), (15, 25)), 8, 6),
    ("decoder", 1, 900, 8, 32, ((200, 200),), 4, 6),
]
# ... and on a BEVFormerV2 sample (6 x 640 x 1600 input: 4 levels of 21250
# keys), per frame encoded (the decoder's once per sample)
K1_V2_CASES = [
    ("tsa", 2, 40000, 8, 32, ((200, 200),), 4, 6),
    ("sca", 6, 10112, 8, 32, ((80, 200), (40, 100), (20, 50), (10, 25)), 8, 6),
    ("decoder", 1, 900, 8, 32, ((200, 200),), 4, 6),
]


def check_k1(device, gen, cases=K1_CASES, tag="k1"):
    import torch
    from bevformer_torch.kernels import msda
    from bevformer_torch.tools import roofline

    rows = []
    for name, b, q, h, d, shapes, p, per_frame in cases:
        args = msda_inputs(b, q, h, d, shapes, p, gen, device)
        out = msda.ms_deform_attn(args[0], shapes, args[1], args[2])
        ref = msda.ms_deform_attn_plain(args[0], shapes, args[1], args[2])
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        same = float((out == ref).float().mean())
        outside = float(((args[1] < 0) | (args[1] > 1)).float().mean())
        ms = time_ms(lambda: msda.ms_deform_attn(args[0], shapes, args[1], args[2]), 20)
        k7_ms = time_ms(lambda: msda.ms_deform_attn_ho(args[0], shapes, args[1], args[2]), 20)
        plain_ms = time_ms(lambda: msda.ms_deform_attn_plain(args[0], shapes, args[1], args[2]), 3)
        # every corner of every sample is one 128-byte row per 32 channels
        corner_bytes = b * q * h * len(shapes) * p * 4 * (d // 32) * 128
        cost = roofline.msda_fwd(b, q, h, d, shapes, p)
        log(f"[{tag}] {name}: value {list(args[0].shape)} loc {list(args[1].shape)} "
            f"({outside:.1%} of coords outside [0,1]) max_abs_err {err:.3e} "
            f"(tol {K1_TOL:.0e}; {same:.1%} bitwise equal) kernel {ms:.4f} ms "
            f"(tile {msda.k1_tile_for(args[0], args[1])}; "
            f"corner requests {corner_bytes / 1e9:.3f} GB, {corner_bytes / ms / 1e9:.2f} TB/s; "
            f"bound {cost.bound_ms:.4f} ms by {cost.bound_by}, {cost.bound_ms / ms:.1%} of it; "
            f"{per_frame} launches per frame) K7 {k7_ms:.4f} ms plain {plain_ms:.4f} ms")
        check(err <= K1_TOL, f"K1 {name}: max abs error {err} > {K1_TOL}")
        rows.append(dict(shape=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         per_frame=per_frame, k7_ms=k7_ms, bitwise_equal_share=same,
                         corner_TB_per_s=corner_bytes / ms / 1e9, cost=cost))
        del args, out, ref
    return rows


def check_k2(device, gen):
    import torch
    from bevformer_torch.kernels import dcn
    from bevformer_torch.tools import roofline

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
        # both against the float64 product of the plain path's fp32 column
        exact = (dcn.dcn_im2col_plain(x, off_y, off_x, mask).double() @ weight.double())
        exact = exact.view(out.shape)
        exact_scale = float(exact.abs().max())
        vs_exact = [float((o.double() - exact).abs().max()) / exact_scale for o in (out, ref)]
        del exact
        big_dy = float((off_y.abs() > 2).float().mean())
        ky = torch.arange(3, device=device).repeat_interleave(3)  # tap row
        py = torch.arange(h, device=device)[None, :, None, None] - 1 + ky + off_y
        off_img = float(((py <= -1) | (py >= h)).float().mean())
        ms = time_ms(lambda: dcn.dcn_conv(*args), 10)
        plain_ms = time_ms(lambda: dcn.dcn_conv_plain(*args), 3)
        # yardstick, used nowhere in the port: the column by K5, then one
        # fp32 cuBLAS product (TF32 is off)
        wm = weight.view(9 * c, cout)
        two_call_ms = time_ms(lambda: dcn.dcn_im2col(x, off_y, off_x, mask) @ wm, 10)
        gflop = 2.0 * b * h * w * 9 * c * cout / 1e9
        log(f"[k2] {name}: x {list(x.shape)} weight {list(weight.shape)} "
            f"(|dy|>2: {big_dy:.1%}, rows off the image: {off_img:.1%}) "
            f"max_abs_err {err:.3e} = {err / scale:.2e} of max|plain| "
            f"(tol {K2_TOL:.0e}; against float64 products of the plain column: kernel "
            f"{vs_exact[0]:.2e}, plain {vs_exact[1]:.2e} of scale) "
            f"kernel {ms:.4f} ms ({gflop / ms:.2f} TFLOP/s) "
            f"dcn_im2col + matmul {two_call_ms:.4f} ms ({gflop / two_call_ms:.2f} TFLOP/s) "
            f"plain {plain_ms:.4f} ms")
        check(err <= K2_TOL * scale, f"K2 {name}: error {err} > {K2_TOL} x {scale}")
        rows.append(dict(shape=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         per_frame=per_frame, TFLOP_per_s=gflop / ms,
                         im2col_matmul_ms=two_call_ms, err_vs_float64=vs_exact[0],
                         plain_err_vs_float64=vs_exact[1],
                         cost=roofline.dcn_conv(b, h, w, c, cout)))
        del x, off_y, off_x, mask, weight, args, out, ref
    return rows


CONV_FLOOR = 4e-7  # a conv error that always passes: a few fp32 roundings of the scale


def check_conv(device, gen, config="bevformer_base"):
    """The dense conv kernel against its plain version at each distinct
    (shape, residual, ReLU) of `config`'s engaged sites in a frame, with
    their launches a frame; seeded weights, scale 1 + 0.1 N(0, 1), shift
    0.1 N(0, 1)."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.kernels import conv
    from bevformer_torch.models.conv_sites import conv_sites
    from bevformer_torch.tools import roofline

    shapes = {}
    for site in conv_sites(get_config(config)):
        if site["engaged"]:
            key = tuple(site[k] for k in ("cin", "cout", "k", "stride", "pad", "h", "w", "relu",
                                          "residual"))
            shapes.setdefault(key, [site, 0])[1] += 1
    rows = []
    for site, per_frame in shapes.values():
        b, h, w, cin, cout, k = (site[n] for n in ("b", "h", "w", "cin", "cout", "k"))
        oh, ow = site["oh"], site["ow"]
        x = torch.randn((b, h, w, cin), generator=gen, device=device)
        weight = torch.randn((cout, cin, k, k), generator=gen, device=device)
        weight *= (2.0 / (cin * k * k)) ** 0.5
        scale = 1 + 0.1 * torch.randn(cout, generator=gen, device=device)
        shift = 0.1 * torch.randn(cout, generator=gen, device=device)
        res = (torch.randn((b, oh, ow, cout), generator=gen, device=device)
               if site["residual"] else None)
        args = (x, weight, site["stride"], site["pad"], scale, shift, res, site["relu"])
        before = conv.conv2d_nhwc.launches
        out = conv.conv2d_nhwc(*args)
        ref = conv.conv2d_nhwc_plain(*args)
        exact = conv.conv2d_nhwc_plain(*(a.double() if torch.is_tensor(a) else a for a in args))
        torch.cuda.synchronize()
        check(conv.conv2d_nhwc.launches == before + 1, f"conv {site['name']}: no launch")
        err = float((out - ref).abs().max())
        exact_scale = float(exact.abs().max())
        vs_exact = [float((o.double() - exact).abs().max()) / exact_scale for o in (out, ref)]
        del exact
        ms = time_ms(lambda: conv.conv2d_nhwc(*args), 10)
        plain_ms = time_ms(lambda: conv.conv2d_nhwc_plain(*args), 3)
        cost = roofline.conv_fwd(b, h, w, cin, oh, ow, cout, k, site["residual"])
        gflop = 2.0 * b * oh * ow * cout * cin * k * k / 1e9
        name = (f"{site['name']} {cin}->{cout} k{k} s{site['stride']} {h}x{w}"
                + (" +res" if site["residual"] else "") + (" relu" if site["relu"] else ""))
        log(f"[conv] {config} {name} ({per_frame} a frame): against float64 kernel "
            f"{vs_exact[0]:.2e}, plain {vs_exact[1]:.2e} of scale (kernel within "
            f"max(2x plain, {CONV_FLOOR:.0e})); kernel vs plain {err / float(ref.abs().max()):.2e}; "
            f"kernel {ms:.4f} ms ({gflop / ms:.2f} TFLOP/s, {cost.bound_ms / ms:.1%} of its bound "
            f"{cost.bound_ms:.4f} by {cost.bound_by}) plain {plain_ms:.4f} ms")
        check(vs_exact[0] <= max(2 * vs_exact[1], CONV_FLOOR),
              f"conv {config} {name}: error {vs_exact[0]:.2e} > 2 x plain {vs_exact[1]:.2e}")
        rows.append(dict(shape=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         per_frame=per_frame, TFLOP_per_s=gflop / ms,
                         err_vs_float64=vs_exact[0], plain_err_vs_float64=vs_exact[1],
                         cost=cost))
        del x, weight, res, args, out, ref
    return rows


# K3/K4's shapes on bevformer_base's training step: (name, B, Q, H, D,
# shapes, P, launches per training step)
K34_CASES = [
    ("tsa", 2, 40000, 8, 32, ((200, 200),), 4, 6),
    ("sca", 6, 10112, 8, 32, ((116, 200), (58, 100), (29, 50), (15, 25)), 8, 6),
    ("decoder", 1, 900, 8, 32, ((200, 200),), 4, 6),
]


def check_k34(device, gen, cases=K34_CASES):
    import torch
    from bevformer_torch.tools import common, roofline

    rows = []
    for name, b, q, h, d, shapes, p, per_step in cases:
        value, loc, attw = msda_inputs(b, q, h, d, shapes, p, gen, device)
        g = torch.randn((b, q, h * d), generator=gen, device=device)
        cost = roofline.msda_bwd(b, q, h, d, shapes, p)
        row = dict(shape=name, per_step=per_step, cost=cost,
                   **k34_case(name, value, shapes, loc, attw, g, cost))
        del value, loc, attw, g
        if name == "sca":
            # locations as the kernel tools build them: y-coherent, as SCA's
            # anchor sort leaves them; not part of the per-step sum
            value, loc, attw = common.to_device(
                common.coherent_inputs(common.sca_shape(q)), device)
            g = torch.randn((b, q, h * d), generator=gen, device=device)
            row["coherent"] = k34_case(f"{name} y-coherent", value, shapes, loc, attw, g, cost,
                                       plain=False)
            row["max_abs_err"] = max(row["max_abs_err"], row["coherent"]["max_abs_err"])
            del value, loc, attw, g
        rows.append(row)
    return rows


def msda_bwd_traffic(loc, attw, shapes, d):
    """(corner rows, 16-byte atomic adds) K3/K4 makes for these inputs: it
    reads one 128-byte row per in-bounds corner of a sample and 32 channels,
    and each lane adds 4 channels into every in-bounds corner whose weight x
    attw is not 0 (D/4 vector atomics per corner)."""
    from bevformer_torch.kernels import msda

    rows = adds = 0
    for lvl, (hh, ww) in enumerate(shapes):
        for _, wgt, valid in msda._corners(loc[:, :, :, lvl], hh, ww):
            rows += int(valid.sum())
            adds += int((valid & (wgt * attw[:, :, :, lvl] != 0)).sum())
    return rows * (d // 32), adds * (d // 4)


def k34_case(name, value, shapes, loc, attw, g, cost, plain=True):
    """K3/K4 on one input against autograd through the plain msda: the
    errors, the time, and the corner-request and atomic rates (and the plain
    version's time)."""
    import torch
    from bevformer_torch.kernels import msda

    ours = msda.ms_deform_attn_backward(value, shapes, loc, attw, g)
    ref = msda.ms_deform_attn_backward_plain(value, shapes, loc, attw, g)
    torch.cuda.synchronize()
    errs = {k: rel_err(a, r) for k, a, r in zip(("dvalue", "dloc", "dattw"), ours, ref)}
    del ours, ref
    ms = time_ms(lambda: msda.ms_deform_attn_backward(value, shapes, loc, attw, g), 10)
    rows, adds = msda_bwd_traffic(loc, attw, shapes, value.shape[3])
    out = dict(max_abs_err=max(errs.values()), ms=ms, share_of_bound=cost.bound_ms / ms,
               corner_rows=rows, corner_TB_per_s=rows * 128 / ms / 1e9, atomic_adds=adds,
               atomic_TB_per_s=adds * 16 / ms / 1e9)
    if plain:
        out["plain_ms"] = time_ms(
            lambda: msda.ms_deform_attn_backward_plain(value, shapes, loc, attw, g), 2)
    log(f"[k3k4] {name}: value {list(value.shape)} loc {list(loc.shape)} "
        f"max abs err / max |plain|: {fmt_errors(errs)} (tol {K34_TOL:.0e}) kernel {ms:.4f} ms "
        f"({cost.bound_ms / ms:.1%} of its bound {cost.bound_ms:.4f}; tile "
        f"{msda.k1_tile_for(value, loc)}; corner rows {rows / 1e6:.2f} M, "
        f"{out['corner_TB_per_s']:.2f} TB/s; 16-byte atomic adds {adds / 1e6:.1f} M, "
        f"{out['atomic_TB_per_s']:.2f} TB/s)"
        + (f" plain {out['plain_ms']:.4f} ms" if plain else ""))
    for k, e in errs.items():
        check(e <= K34_TOL, f"msda_bwd {name} {k}: {e:.2e} > {K34_TOL}")
    return out


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp at `scale`: 2^(e - 7) for 2^e <= scale < 2^(e + 1)."""
    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def ulps(a, ref) -> float:
    """max |a - ref| in bf16 ulps at max |ref|."""
    return float((a.float() - ref.float()).abs().max()) / bf16_ulp(float(ref.float().abs().max()))


# bf16 K1's and K3/K4's shapes: (name, B, Q, H, D, shapes, P, launches a
# tiny_fp16 frame (= a tiny_fp16 step's backward), launches a bevformer_base
# frame, K1 launches a base step, K3/K4 launches a base step)
BF16_MSDA_CASES = [
    ("tiny_tsa", 2, 2500, 8, 32, ((50, 50),), 4, 3, 0, 0, 0),
    ("tiny_sca", 6, 2500, 8, 32, ((15, 25),), 8, 3, 0, 0, 0),
    ("tiny_decoder", 1, 900, 8, 32, ((50, 50),), 4, 6, 0, 0, 0),
    ("base_tsa", *K1_CASES[0][1:7], 0, 6, 3 * 6 + 6, 6),
    ("base_sca", *K1_CASES[1][1:7], 0, 6, 3 * 6 + 6, 6),
    ("base_decoder", *K1_CASES[2][1:7], 0, 6, 6, 6),
]
# timed plain calls (forward, backward) at tiny's shapes and at base's
BF16_PLAIN_REPS = dict(tiny=(3, 2), base=(1, 1))


def check_bf16_msda(device, gen):
    """bf16 K1 (msda_fwd_bf16) and K3/K4 (msda_bwd_bf16) against their plain
    versions at bevformer_tiny_fp16's three shapes (TSA, dense SCA, decoder)
    and at bevformer_base's three (the path of base and small with
    dtype=bfloat16): errors in bf16 ulps and the bitwise-equal share, times,
    bounds at bf16's 2-byte value and output, the plain versions' times, each
    shape's launches a tiny_fp16 frame or step and a base frame or step, and
    at base's shapes the fp32 entries' times on the same value in fp32."""
    import torch
    from bevformer_torch.kernels import msda
    from bevformer_torch.tools import roofline

    fwd_rows, bwd_rows = [], []
    for name, b, q, h, d, shapes, p, per, base_frame, base_fwd, base_bwd in BF16_MSDA_CASES:
        base = name.startswith("base")
        plain_reps = BF16_PLAIN_REPS[name.split("_")[0]]
        value, loc, attw = msda_inputs(b, q, h, d, shapes, p, gen, device)
        value = value.bfloat16()
        g = torch.randn((b, q, h * d), generator=gen, device=device).bfloat16()
        tile = msda.k1_bf16_tile_for(value, loc)
        out = msda.ms_deform_attn(value, shapes, loc, attw)
        ref = msda.ms_deform_attn_plain(value, shapes, loc, attw)
        torch.cuda.synchronize()
        check(out.dtype == ref.dtype == torch.bfloat16, f"bf16 K1 {name}: {out.dtype}")
        fwd_ulps, same = ulps(out, ref), float((out == ref).float().mean())
        fwd_err = float((out.float() - ref.float()).abs().max())
        del out, ref
        ms = time_ms(lambda: msda.ms_deform_attn(value, shapes, loc, attw), 20)
        plain_ms = time_ms(lambda: msda.ms_deform_attn_plain(value, shapes, loc, attw),
                           plain_reps[0])
        fp32_ms = fp32_bwd_ms = None
        if base:
            v32, g32 = value.float(), g.float()
            fp32_ms = time_ms(lambda: msda.ms_deform_attn(v32, shapes, loc, attw), 20)
            fp32_bwd_ms = time_ms(
                lambda: msda.ms_deform_attn_backward(v32, shapes, loc, attw, g32), 10)
            del v32, g32
        cost = roofline.msda_fwd(b, q, h, d, shapes, p, itemsize=2)
        launches = (f"{base_frame} launches a base frame, {base_fwd} a base step; fp32 K1 "
                    f"{fp32_ms:.4f} ms" if base else f"{per} launches a tiny_fp16 frame")
        log(f"[bf16-k1] {name}: value {list(value.shape)} bf16 max abs err {fwd_err:.3e} = "
            f"{fwd_ulps:.2f} bf16 ulps at max|plain| (tol {BF16_FWD_ULPS}; {same:.2%} bitwise "
            f"equal) kernel {ms:.4f} ms ({cost.bound_ms / ms:.1%} of its bound "
            f"{cost.bound_ms:.4f}; tile {tile}; {launches}) plain "
            f"{plain_ms:.4f} ms")
        check(fwd_ulps <= BF16_FWD_ULPS, f"bf16 K1 {name}: {fwd_ulps:.2f} ulps")
        fwd_rows.append(dict(shape=name, max_abs_err=fwd_err, ulps=fwd_ulps, ms=ms,
                             plain_ms=plain_ms, per_frame=per, base_per_frame=base_frame,
                             base_per_step=base_fwd, share_of_bound=cost.bound_ms / ms,
                             bitwise_equal_share=same, tile=tile, fp32_ms=fp32_ms,
                             cost=cost))

        ours = msda.ms_deform_attn_backward(value, shapes, loc, attw, g)
        ref = msda.ms_deform_attn_backward_plain(value, shapes, loc, attw, g)
        torch.cuda.synchronize()
        check(ours[0].dtype == torch.bfloat16 and ours[1].dtype == ours[2].dtype == torch.float32,
              f"bf16 K3/K4 {name}: dtypes {[x.dtype for x in ours]}")
        dv_ulps = ulps(ours[0], ref[0])
        dv_same = float((ours[0] == ref[0]).float().mean())
        aux = {k: rel_err(a, r) for k, a, r in zip(("dloc", "dattw"), ours[1:], ref[1:])}
        err = max(float((ours[0].float() - ref[0].float()).abs().max()),
                  *(float((a - r).abs().max()) for a, r in zip(ours[1:], ref[1:])))
        del ours, ref
        bms = time_ms(lambda: msda.ms_deform_attn_backward(value, shapes, loc, attw, g), 10)
        bplain_ms = time_ms(
            lambda: msda.ms_deform_attn_backward_plain(value, shapes, loc, attw, g),
            plain_reps[1])
        bcost = roofline.msda_bwd(b, q, h, d, shapes, p, itemsize=2)
        launches = (f"{base_bwd} launches a base step; fp32 K3/K4 {fp32_bwd_ms:.4f} ms"
                    if base else f"{per} launches a tiny_fp16 step")
        log(f"[bf16-k3k4] {name}: dvalue {dv_ulps:.2f} bf16 ulps at max|plain| (tol "
            f"{BF16_FWD_ULPS}; {dv_same:.2%} bitwise equal), max abs err / max |plain|: "
            f"{fmt_errors(aux)} (tol {BF16_AUX_TOL:.0e}) kernel {bms:.4f} ms "
            f"({bcost.bound_ms / bms:.1%} of its bound {bcost.bound_ms:.4f}; tile {tile}; "
            f"{launches}) plain "
            f"{bplain_ms:.4f} ms")
        check(dv_ulps <= BF16_FWD_ULPS, f"bf16 K3/K4 {name} dvalue: {dv_ulps:.2f} ulps")
        for k, e in aux.items():
            check(e <= BF16_AUX_TOL, f"bf16 K3/K4 {name} {k}: {e:.2e} > {BF16_AUX_TOL}")
        bwd_rows.append(dict(shape=name, max_abs_err=err, dvalue_ulps=dv_ulps, ms=bms,
                             plain_ms=bplain_ms, per_step=per, base_per_step=base_bwd,
                             share_of_bound=bcost.bound_ms / bms, dvalue_bitwise_equal_share=dv_same,
                             tile=tile, fp32_ms=fp32_bwd_ms, cost=bcost, **aux))
        del value, loc, attw, g
    return fwd_rows, bwd_rows


def check_vector_atomics(lib_path):
    """The dValue adds of every msda_bwd_kernel instantiation and bf16 K6's
    dx adds (dcn_col2im_gw_kernel) in the built library are 16-byte vector
    reductions (REDG.E.ADD.F32x4 in the SASS); fp32 K6's are printed beside
    them."""
    from bevformer_torch.kernels import build

    t = time.perf_counter()
    ops = {k: build.atomic_ops(lib_path, k) for k in ("msda_bwd_kernel", "dcn_col2im_gw_kernel")}
    log(f"[build] atomic instructions in the SASS: {ops}, "
        f"dcn_col2im_kernel {build.atomic_ops(lib_path, 'dcn_col2im_kernel')} (the SASS read "
        f"in {time.perf_counter() - t:.1f} s)")
    for kernel, found in ops.items():
        check(bool(found) and all("F32x4" in op for op in found),
              f"{kernel}'s adds are not all 16-byte vector reductions: {found}")


def check_k56(device, gen):
    import torch
    from bevformer_torch.kernels import dcn
    from bevformer_torch.tools import roofline

    cases = [("layer3", 6, 58, 100, 256, 256, 23), ("layer4", 6, 29, 50, 512, 512, 3)]
    im2col_rows, col2im_rows = [], []
    for name, b, h, w, c, cout, per_step in cases:
        x = torch.randn((b, h, w, c), generator=gen, device=device)
        off_y = torch.randn((b, h, w, 9), generator=gen, device=device) * 3
        off_x = torch.randn((b, h, w, 9), generator=gen, device=device) * 3
        mask = torch.rand((b, h, w, 9), generator=gen, device=device)
        weight = torch.randn((9 * c, cout), generator=gen, device=device) / (9 * c) ** 0.5
        g = torch.randn((b, h, w, cout), generator=gen, device=device)
        dcols = torch.randn((b * h * w, 9 * c), generator=gen, device=device)

        cols, ref_cols = dcn.dcn_im2col(x, off_y, off_x, mask), dcn.dcn_im2col_plain(
            x, off_y, off_x, mask)
        cols_err = rel_err(cols, ref_cols)
        cols_same = float((cols == ref_cols).float().mean())
        del cols, ref_cols
        im2col_ms = time_ms(lambda: dcn.dcn_im2col(x, off_y, off_x, mask), 10)
        im2col_plain_ms = time_ms(lambda: dcn.dcn_im2col_plain(x, off_y, off_x, mask), 3)
        im2col_cost = roofline.dcn_im2col(b, h, w, c)
        log(f"[k5] {name}: x {list(x.shape)} max abs err / max |plain| {cols_err:.2e} "
            f"({cols_same:.4%} of the column bitwise equal); dcn_im2col {im2col_ms:.4f} ms "
            f"({im2col_cost.bound_ms / im2col_ms:.1%} of its bound {im2col_cost.bound_ms:.4f}; "
            f"plain {im2col_plain_ms:.4f})")
        check(cols_err <= K56_TOL, f"dcn_im2col {name}: {cols_err:.2e} > {K56_TOL}")
        im2col_rows.append(dict(shape=name, max_abs_err=cols_err, ms=im2col_ms,
                                plain_ms=im2col_plain_ms, per_step=per_step,
                                share_of_bound=im2col_cost.bound_ms / im2col_ms,
                                bitwise_equal_share=cols_same, cost=im2col_cost))
        col2im_rows.append(dict(shape=name, per_step=per_step, cost=roofline.dcn_col2im(
            b, h, w, c), **k6_case(name, x, off_y, off_x, mask, weight, g, dcols)))
        del x, off_y, off_x, mask, weight, g, dcols
    return im2col_rows, col2im_rows


def col2im_dx_adds(x_shape, off_y, off_x, stride: int = 1) -> int:
    """The corners K6 adds into dx for these offsets: the on-image corners
    of every (pixel, tap) that passes the backward's bounds test (-1 <= p <
    size), each C floats through a global atomic."""
    import torch
    from bevformer_torch.kernels import dcn

    _, h, w, _ = x_shape
    py, px = dcn._grid(off_y.shape[1], off_y.shape[2], stride, off_y, off_x)
    live = (py >= -1) & (px >= -1) & (py < h) & (px < w)
    y0, x0 = torch.floor(py), torch.floor(px)
    adds = 0
    for yy in (y0, y0 + 1):
        for xx in (x0, x0 + 1):
            adds += int((live & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).sum())
    return adds


def k6_case(name, x, off_y, off_x, mask, weight, g, dcols):
    """K6 at one stage: the DCN backward it ends (K5, two products, K6)
    against autograd through the plain DCN, and K6 alone against
    dcn_col2im_plain on `dcols`; K6's time, share of its bound, the bytes it
    adds into dx by global atomics and their rate; the yardstick, ATen's
    grid_sampler_2d_backward on the same sampling (dx and the position
    gradient, not dmask: with grid_sampler_2d and a channel dot for dmask it
    is the two-call composition); the plain versions' times."""
    import torch
    from bevformer_torch.kernels import dcn
    from bevformer_torch.tools import roofline

    b, h, w, c = x.shape
    cout = weight.shape[1]
    gm = g.view(-1, cout)
    cost = roofline.dcn_col2im(b, h, w, c)

    def kernel_bwd():
        cols = dcn.dcn_im2col(x, off_y, off_x, mask)
        dweight = cols.t() @ gm
        del cols
        return (*dcn.dcn_col2im(x, off_y, off_x, mask, gm @ weight.t()), dweight)

    names = ("dx", "doff_y", "doff_x", "dmask", "dweight")
    ours = kernel_bwd()
    ref = dcn.dcn_conv_backward_plain(x, off_y, off_x, mask, weight, g)
    torch.cuda.synchronize()
    errs = {k: rel_err(a, r) for k, a, r in zip(names, ours, ref)}
    del ours, ref
    ours = dcn.dcn_col2im(x, off_y, off_x, mask, dcols)
    ref = dcn.dcn_col2im_plain(x, off_y, off_x, mask, dcols)
    torch.cuda.synchronize()
    errs.update({f"{k} alone": rel_err(a, r) for k, a, r in zip(names, ours, ref)})
    dx = ours[0]
    del ours, ref
    ms = time_ms(lambda: dcn.dcn_col2im(x, off_y, off_x, mask, dcols), 10)
    bwd_ms = time_ms(kernel_bwd, 5)
    adds = col2im_dx_adds(x.shape, off_y, off_x)

    # the yardstick's tensors, made outside the timed region: NCHW x, the
    # sample positions as an align_corners grid [B, OH, OW*9, 2], and the
    # column gradient times the mask as its NCHW output gradient
    py, px = dcn._grid(h, w, 1, off_y, off_x)
    grid = torch.stack([px * (2 / (w - 1)) - 1, py * (2 / (h - 1)) - 1], -1).view(b, h, w * 9, 2)
    xn = x.permute(0, 3, 1, 2).contiguous()
    gcols = dcols.view(b, h, w, 9, c).permute(0, 4, 1, 2, 3).reshape(b, c, h, w * 9)
    gout = (dcols.view(b, h, w, 9, c) * mask[..., None]).permute(0, 4, 1, 2, 3).reshape(
        b, c, h, w * 9)
    aten = torch.ops.aten

    def grid_bwd():
        return aten.grid_sampler_2d_backward(gout, xn, grid, 0, 0, True, [True, True])

    def grid_pair():
        grads = grid_bwd()
        return grads, (aten.grid_sampler_2d(xn, grid, 0, 0, True) * gcols).sum(1)

    yard_dx = rel_err(grid_bwd()[0].permute(0, 2, 3, 1), dx)
    gs_ms = time_ms(grid_bwd, 10)
    pair_ms = time_ms(grid_pair, 10)
    del grid, xn, gcols, gout, dx
    out = dict(max_abs_err=max(errs.values()), ms=ms, backward_ms=bwd_ms,
               share_of_bound=cost.bound_ms / ms, dx_add_bytes=adds * c * 4,
               dx_add_TB_per_s=adds * c * 4 / ms / 1e9, grid_sampler_ms=gs_ms,
               grid_sampler_pair_ms=pair_ms)
    out["plain_ms"] = time_ms(lambda: dcn.dcn_col2im_plain(x, off_y, off_x, mask, dcols), 3)
    out["backward_plain_ms"] = time_ms(
        lambda: dcn.dcn_conv_backward_plain(x, off_y, off_x, mask, weight, g), 2)
    log(f"[k6] {name}, offsets N(0, 3) px: max abs err / max |plain|: {fmt_errors(errs)} "
        f"(tol {K56_TOL:.0e}); dcn_col2im {ms:.4f} ms ({cost.bound_ms / ms:.1%} of its bound "
        f"{cost.bound_ms:.4f}); dx adds through global atomics {adds * c * 4 / 1e6:.1f} MB "
        f"({adds / 1e6:.2f} M corners x {c} channels, {out['dx_add_TB_per_s']:.2f} TB/s); "
        f"whole backward (im2col + 2 matmuls + col2im) {bwd_ms:.4f} ms; yardstick aten "
        f"grid_sampler_2d_backward {gs_ms:.4f} ms (dx vs K6 {yard_dx:.2e} of scale), + "
        f"grid_sampler_2d and the dmask dot {pair_ms:.4f} ms; plain dcn_col2im "
        f"{out['plain_ms']:.4f} ms, plain autograd backward {out['backward_plain_ms']:.4f} ms")
    for k, e in errs.items():
        check(e <= K56_TOL, f"DCN backward {name} {k}: {e:.2e} > {K56_TOL}")
    return out


# bf16 K2, K5 and K6 at the DCN stages of bevformer_base and bevformer_small
# in bf16: (name, B, H, W, C, Cout, launches per base frame = per base
# step's backward; small's rows count 0 in the kernels' line)
BF16_DCN_CASES = [
    ("base_layer3", 6, 58, 100, 256, 256, 23), ("base_layer4", 6, 29, 50, 512, 512, 3),
    ("small_layer3", 6, 46, 80, 256, 256, 0), ("small_layer4", 6, 23, 40, 512, 512, 0),
]


# bf16 K2 where a persistent schedule, a 32-deep tail or a bulk copy could
# go wrong: (name, B, H, W, C, Cout, stride, x's offset in elements from a
# 16-byte boundary)
BF16_K2_RAGGED = [
    ("m143", 1, 11, 13, 64, 256, 1, 0),  # M = 143 over 3 blocks
    ("m34933", 1, 181, 193, 64, 256, 1, 0),  # 264-265 pixels a block: 4 tiles of 64, 8-9 more
    ("cout40", 2, 23, 40, 256, 40, 1, 0),  # one column block, 40 of its 256 stored
    ("cout320", 2, 23, 40, 256, 320, 1, 0),  # a second column block, 64 of it stored
    ("c32", 2, 29, 50, 32, 256, 1, 0),  # every K tile 32 deep
    ("c96", 2, 29, 50, 96, 256, 1, 0),  # a 64- and a 32-deep K tile a tap
    ("stride2", 6, 58, 100, 256, 256, 2, 0),  # base's stage-3 input at stride 2
    ("x8", 1, 13, 21, 32, 96, 1, 4),  # x on an 8-byte boundary, the least the kernel takes
]


def bf16_column_bitwise(dcn, x, off_y, off_x, mask, stride=1) -> bool:
    """bf16 K2 with the identity weight [9C, 9C] returns its bf16 column:
    one product of 1 in each output's sum. True if that is the plain
    column, bitwise."""
    import torch

    eye = torch.eye(9 * x.shape[3], device=x.device)
    col = dcn.dcn_conv(x, off_y, off_x, mask, eye, stride)
    same = torch.equal(col.view(-1, eye.shape[0]),
                       dcn.dcn_im2col_plain(x, off_y, off_x, mask, stride))
    del col, eye
    return same


def check_bf16_dcn(device, gen):
    """bf16 K2 (dcn_conv_fwd_bf16), K5 (dcn_im2col_bf16) and K6
    (dcn_col2im_gw, from the bf16 output gradient and the weight) against
    their plain versions at the DCN stages of bevformer_base and
    bevformer_small, offsets N(0, 3) px: K2's output, K5's column and K6's
    dx within BF16_FWD_ULPS bf16 ulps at their scale, K2's own column
    bitwise (bf16_column_bitwise), K6's d offsets and dmask within
    BF16_AUX_TOL and bitwise the same in a second launch; the whole bf16
    DCN gradient (`_DCNConv`: K5, the fp32 dWeight product, K6) against
    autograd through the plain conv. Times, bounds at bf16's 2-byte
    tensors, the plain versions' times, K6's dx adds, and the yardsticks:
    K5 bf16 + one bf16 cuBLAS product for K2; for K6 ATen's
    grid_sampler_2d_backward on bf16 and the fp32 product g W_bf16^T
    alone."""
    import torch
    from bevformer_torch.kernels import dcn
    from bevformer_torch.tools import roofline

    k2_rows, k5_rows, k6_rows = [], [], []
    for name, b, h, w, c, cout, per in BF16_DCN_CASES:
        x = torch.randn((b, h, w, c), generator=gen, device=device).bfloat16()
        off_y = torch.randn((b, h, w, 9), generator=gen, device=device) * 3
        off_x = torch.randn((b, h, w, 9), generator=gen, device=device) * 3
        mask = torch.rand((b, h, w, 9), generator=gen, device=device)
        weight = torch.randn((9 * c, cout), generator=gen, device=device) / (9 * c) ** 0.5
        g = torch.randn((b, h, w, cout), generator=gen, device=device).bfloat16()
        args = (x, off_y, off_x, mask, weight, 1)

        # K2
        out, ref = dcn.dcn_conv(*args), dcn.dcn_conv_plain(*args)
        sched = dcn.bf16_conv_grid()  # the launch's own record of its grid
        torch.cuda.synchronize()
        check(out.dtype == ref.dtype == torch.bfloat16, f"bf16 K2 {name}: {out.dtype}")
        k2_ulps, k2_err = ulps(out, ref), float((out.float() - ref.float()).abs().max())
        exact = (dcn.dcn_im2col_plain(x, off_y, off_x, mask).double()
                 @ weight.bfloat16().double()).view(out.shape)
        vs_exact = [ulps(o, exact) for o in (out, ref)]
        same = float((out == ref).float().mean())
        del out, ref, exact
        column = bf16_column_bitwise(dcn, x, off_y, off_x, mask)
        ms = time_ms(lambda: dcn.dcn_conv(*args), 10)
        plain_ms = time_ms(lambda: dcn.dcn_conv_plain(*args), 3)
        wb = weight.bfloat16()
        two_call_ms = time_ms(lambda: dcn.dcn_im2col(x, off_y, off_x, mask) @ wb, 10)
        cost = roofline.dcn_conv(b, h, w, c, cout, itemsize=2)
        log(f"[bf16-k2] {name}: x {list(x.shape)} bf16 weight {list(weight.shape)} max abs err "
            f"{k2_err:.3e} = {k2_ulps:.2f} bf16 ulps at max|plain| (tol {BF16_FWD_ULPS}; "
            f"{same:.2%} bitwise equal; against the float64 product of the bf16 column and "
            f"weight: kernel {vs_exact[0]:.2f}, plain {vs_exact[1]:.2f} ulps; its column "
            f"{'bitwise' if column else 'NOT bitwise'} the plain one) kernel {ms:.4f} ms "
            f"({cost.bound_ms / ms:.1%} of its bound {cost.bound_ms:.4f}, "
            f"{cost.bf16_flops / ms / 1e9:.1f} TFLOP/s; {sched['blocks']} blocks on "
            f"{sched['sms']} SMs, <= {sched['pixels_per_block']} pixels = "
            f"{sched['tiles_per_sm']} {sched['tile_pixels']}-pixel tiles per SM) dcn_im2col_bf16 "
            f"+ bf16 matmul {two_call_ms:.4f} ms plain {plain_ms:.4f} ms")
        check(0 < sched["blocks"] <= sched["sms"], f"bf16 K2 {name}: not persistent: {sched}")
        check(k2_ulps <= BF16_FWD_ULPS, f"bf16 K2 {name}: {k2_ulps:.2f} ulps")
        check(column, f"bf16 K2 {name}: the column is not the plain one bitwise")
        k2_rows.append(dict(shape=name, max_abs_err=k2_err, ulps=k2_ulps, ms=ms, plain_ms=plain_ms,
                            per_frame=per, share_of_bound=cost.bound_ms / ms,
                            bitwise_equal_share=same, im2col_matmul_ms=two_call_ms,
                            ulps_vs_float64=vs_exact[0], plain_ulps_vs_float64=vs_exact[1],
                            column_bitwise=column, cost=cost, **sched))

        # K5
        cols, ref = dcn.dcn_im2col(x, off_y, off_x, mask), dcn.dcn_im2col_plain(x, off_y, off_x,
                                                                               mask)
        torch.cuda.synchronize()
        check(cols.dtype == torch.bfloat16, f"bf16 K5 {name}: {cols.dtype}")
        k5_ulps, k5_err = ulps(cols, ref), float((cols.float() - ref.float()).abs().max())
        same = float((cols == ref).float().mean())
        del cols, ref
        ms = time_ms(lambda: dcn.dcn_im2col(x, off_y, off_x, mask), 10)
        plain_ms = time_ms(lambda: dcn.dcn_im2col_plain(x, off_y, off_x, mask), 3)
        cost = roofline.dcn_im2col(b, h, w, c, itemsize=2)
        log(f"[bf16-k5] {name}: column {k5_ulps:.2f} bf16 ulps at max|plain| (tol "
            f"{BF16_FWD_ULPS}; {same:.4%} bitwise equal) kernel {ms:.4f} ms "
            f"({cost.bound_ms / ms:.1%} of its bound {cost.bound_ms:.4f}) plain {plain_ms:.4f} ms")
        check(k5_ulps <= BF16_FWD_ULPS, f"bf16 K5 {name}: {k5_ulps:.2f} ulps")
        k5_rows.append(dict(shape=name, max_abs_err=k5_err, ulps=k5_ulps, ms=ms,
                            plain_ms=plain_ms, per_step=per, share_of_bound=cost.bound_ms / ms,
                            bitwise_equal_share=same, cost=cost))

        # K6 alone, then the whole gradient through _DCNConv
        k6_args = (x, off_y, off_x, mask, g.view(-1, cout), weight)
        ours = dcn.dcn_col2im_gw(*k6_args)
        again = dcn.dcn_col2im_gw(*k6_args)
        ref = dcn.dcn_col2im_gw_plain(*k6_args)
        torch.cuda.synchronize()
        check(ours[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in ours[1:]),
              f"bf16 K6 {name}: dtypes {[t.dtype for t in ours]}")
        same = all(torch.equal(a, a2) for a, a2 in zip(ours[1:], again[1:]))
        check(same, f"bf16 K6 {name}: d offsets or dmask differ between two launches")
        errs = {"dx ulps": ulps(ours[0], ref[0])}
        errs.update({k: rel_err(a, r) for k, a, r in zip(("doff_y", "doff_x", "dmask"), ours[1:],
                                                           ref[1:])})
        k6_err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(ours, ref))
        del ours, again, ref
        leaves = [t.detach().requires_grad_() for t in (x, off_y, off_x, mask, weight)]
        grads = torch.autograd.grad(dcn.dcn_conv(*leaves, 1), leaves, g)
        ref = dcn.dcn_conv_backward_plain(x, off_y, off_x, mask, weight, g)
        torch.cuda.synchronize()
        check([t.dtype for t in grads] == [torch.bfloat16] + [torch.float32] * 4,
              f"bf16 DCN gradient {name}: dtypes {[t.dtype for t in grads]}")
        errs["gradient dx ulps"] = ulps(grads[0], ref[0])
        errs.update({f"gradient {k}": rel_err(a, r) for k, a, r in zip(
            ("doff_y", "doff_x", "dmask", "dweight"), grads[1:], ref[1:])})
        del grads, ref, leaves
        ms = time_ms(lambda: dcn.dcn_col2im_gw(*k6_args), 10)
        plain_ms = time_ms(lambda: dcn.dcn_col2im_gw_plain(*k6_args), 3)
        cost = roofline.dcn_col2im_gw(b, h, w, c, cout)
        adds = col2im_dx_adds(x.shape, off_y, off_x)
        # the yardsticks: the fp32 product alone (the column gradient the
        # route before this kernel made), and ATen's sampler backward on
        # bf16 (its grid bf16 too: ATen takes one dtype)
        gm, wb = g.view(-1, cout).float(), weight.bfloat16().float()
        product_ms = time_ms(lambda: gm @ wb.t(), 10)
        dcols = gm @ wb.t()
        del gm, wb
        py, px = dcn._grid(h, w, 1, off_y, off_x)
        grid = torch.stack([px * (2 / (w - 1)) - 1, py * (2 / (h - 1)) - 1],
                           -1).view(b, h, w * 9, 2).bfloat16()
        xn = x.permute(0, 3, 1, 2).contiguous()
        gout = (dcols.view(b, h, w, 9, c) * mask[..., None]).permute(0, 4, 1, 2, 3).reshape(
            b, c, h, w * 9).bfloat16()
        gs_ms = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            gout, xn, grid, 0, 0, True, [True, True]), 10)
        del grid, xn, gout, dcols
        log(f"[bf16-k6] {name}: dcn_col2im_gw {fmt_errors(errs)} (dx tol {BF16_FWD_ULPS} ulps, "
            f"the rest {BF16_AUX_TOL:.0e}; d offsets and dmask bitwise the same in a second "
            f"launch) kernel {ms:.4f} ms ({cost.bound_ms / ms:.1%} of its bound "
            f"{cost.bound_ms:.4f}, {cost.bound_by}); dx adds through global atomics "
            f"{adds * c * 4 / 1e6:.1f} MB ({adds * c * 4 / ms / 1e9:.2f} TB/s); yardsticks: the "
            f"fp32 product g W^T alone {product_ms:.4f} ms, aten grid_sampler_2d_backward (bf16) "
            f"{gs_ms:.4f} ms; plain {plain_ms:.4f} ms")
        for k, e in errs.items():
            check(e <= (BF16_FWD_ULPS if "ulps" in k else BF16_AUX_TOL),
                  f"bf16 K6 {name} {k}: {e:.3e}")
        k6_rows.append(dict(shape=name, max_abs_err=k6_err, ms=ms, plain_ms=plain_ms,
                            per_step=per, share_of_bound=cost.bound_ms / ms,
                            grid_sampler_ms=gs_ms, product_ms=product_ms,
                            dx_add_bytes=adds * c * 4, cost=cost, **errs))
        del x, off_y, off_x, mask, weight, g, args, k6_args
        torch.cuda.empty_cache()
    return k2_rows, k5_rows, k6_rows


def check_bf16_k2_ragged(device, gen):
    """bf16 K2 at BF16_K2_RAGGED against its plain version, offsets N(0, 3)
    px: the output within BF16_FWD_ULPS bf16 ulps at its scale and the
    column (identity weight) bitwise."""
    import torch
    from bevformer_torch.kernels import dcn

    rows = []
    for name, b, h, w, c, cout, stride, shift in BF16_K2_RAGGED:
        oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
        flat = torch.randn((b * h * w * c + shift,), generator=gen, device=device).bfloat16()
        x = flat[shift:].view(b, h, w, c)
        off_y = torch.randn((b, oh, ow, 9), generator=gen, device=device) * 3
        off_x = torch.randn((b, oh, ow, 9), generator=gen, device=device) * 3
        mask = torch.rand((b, oh, ow, 9), generator=gen, device=device)
        weight = torch.randn((9 * c, cout), generator=gen, device=device) / (9 * c) ** 0.5
        args = (x, off_y, off_x, mask, weight, stride)
        out, ref = dcn.dcn_conv(*args), dcn.dcn_conv_plain(*args)
        sched = dcn.bf16_conv_grid()
        torch.cuda.synchronize()
        err = ulps(out, ref)
        column = bf16_column_bitwise(dcn, x, off_y, off_x, mask, stride)
        log(f"[bf16-k2] ragged {name}: x {list(x.shape)} at byte {x.data_ptr() % 16} of 16, "
            f"stride {stride}, Cout {cout}: {err:.2f} bf16 ulps at max|plain| (tol "
            f"{BF16_FWD_ULPS}; {float((out == ref).float().mean()):.2%} bitwise equal; its column "
            f"{'bitwise' if column else 'NOT bitwise'} the plain one; {sched['blocks']} blocks, "
            f"<= {sched['pixels_per_block']} pixels a block)")
        check(err <= BF16_FWD_ULPS, f"bf16 K2 ragged {name}: {err:.2f} ulps")
        check(column, f"bf16 K2 ragged {name}: the column is not the plain one bitwise")
        rows.append(dict(shape=name, ulps=err, column_bitwise=column, **sched))
        del flat, x, off_y, off_x, mask, weight, args, out, ref
    return rows


# ---------------------------------------------------------------- probes

PROBE_REPS = 5  # timed launches per case (the tools' default is 20)
GATHER_REPS = 20
PROBE_TOL = 1e-5  # msda: max abs error; probe modes: max abs error over max |plain|


def check_probes():
    """The kernel benchmark and probe entry points, each through its `main`
    at its default full-width shapes, with every launch count set to 0 just
    before and read just after. Each case's first launch is its warm-up and
    the output its tool holds against the plain version, so the comparison
    adds no launch; the plain versions launch no kernel."""
    from bevformer_torch.tools import (bench_dma_gather, bench_hi_probe, bench_kernel_probe,
                                       bench_kernel_probe3, bench_msda_decompose,
                                       bench_msda_kernel, common)

    counters = common.launch_counters()
    for fn in counters.values():
        fn.launches = 0
    reps = ["--reps", str(PROBE_REPS)]
    t0 = time.perf_counter()
    runs = dict(
        bench=bench_msda_kernel.main(reps),
        sweep=bench_kernel_probe3.main(reps),
        k7_modes=bench_kernel_probe.main(reps),
        k1_modes=bench_hi_probe.main(reps),
        k1_modes_tsa=bench_hi_probe.main(reps + ["--tsa"]),
        level0=bench_msda_decompose.main(reps),
        gather=bench_dma_gather.main(["--reps", str(GATHER_REPS)]),
    )
    counts = {k: fn.launches for k, fn in counters.items()}
    log(f"[probes] the six tools ran {sum(len(r) for r in runs.values())} cases in "
        f"{time.perf_counter() - t0:.1f} s; launches {counts}")
    check(all(v > 0 for v in counts.values()), f"a kernel of the probes never launched: {counts}")
    for tool, recs in runs.items():
        for r in recs:
            what = f"{r['tool']} {r['case']}"
            if r["case"] != "plain":
                check(r["launches"] > 0, f"{what}: no kernel launched")
            if "bitwise_equal" in r:
                check(r["bitwise_equal"], f"{what}: not bitwise equal to take_along_dim")
            elif r["case"].endswith("_bf16"):
                check(r["max_abs_err"] <= BF16_FWD_ULPS * bf16_ulp(r["scale"]),
                      f"{what}: max abs error {r['max_abs_err']:.2e} > {BF16_FWD_ULPS} bf16 ulp "
                      f"at {r['scale']:.3e}")
            elif r.get("mode", "full") == "full":
                check(r["max_abs_err"] <= PROBE_TOL,
                      f"{what}: max abs error {r['max_abs_err']:.2e} > {PROBE_TOL}")
            else:
                check(r["max_abs_err"] <= PROBE_TOL * r["scale"],
                      f"{what}: max abs error {r['max_abs_err']:.2e} > {PROBE_TOL} x {r['scale']:.3e}")
    log(f"[probes] every case within tolerance (msda {PROBE_TOL:.0e} max abs, bf16 msda "
        f"{BF16_FWD_ULPS} bf16 ulp at max |plain|, probe modes {PROBE_TOL:.0e} of max |plain|, "
        f"row gather bitwise)")
    return runs, counts


def probe_records(runs, counts):
    """The `kernels` line's records of the probes' kernels."""
    def pick(tool, case):
        return next(r for r in runs[tool] if r["case"] == case)

    def rec(name, source, replaces, r, launches, plain_ms, library_ms=None, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=plain_ms, bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=library_ms, shape=r["shape"], **extra)

    no_call = "no single PyTorch call computes msda"
    ho, ho_src = "msda_fwd_ho", "bevformer_torch/csrc/msda_fwd_ho.cu"
    k7, plain = pick("bench", "k7"), pick("bench", "plain")
    sweep = runs["sweep"]
    best = min(sweep, key=lambda r: r["ms"])
    level0 = pick("level0", "k7")
    records = [
        rec(ho, ho_src, "bevformer_tpu/kernels/msda_pallas.py:159", k7, counts[ho],
            plain["ms"], library_note=no_call,
            incoherent=dict((k, pick("bench", "check_k7")[k]) for k in ("ms", "max_abs_err")),
            k1_ms=pick("bench", "k1")["ms"]),
        rec(f"{ho}[sweep]", ho_src, "tools/bench_kernel_probe3.py:63", best,
            sum(r["launches"] for r in sweep), plain["ms"], library_note=no_call,
            fastest=f"tile {best['tile']}, acc {best['acc']}",
            sweep=[dict((k, r[k]) for k in ("tile", "acc", "ms", "max_abs_err")) for r in sweep]),
        rec(f"{ho}[level0]", ho_src, "tools/bench_msda_decompose.py:107", level0,
            level0["launches"], level0["plain_ms"], library_note=no_call,
            k1_ms=pick("level0", "k1")["ms"],
            random_ms=dict((c, pick("level0", c)["ms"]) for c in ("k7_random", "k1_random"))),
    ]
    for tool, name, source, replaces in (
            ("k7_modes", ho, ho_src, "tools/bench_kernel_probe.py:42"),
            ("k1_modes", "msda_fwd", "bevformer_torch/csrc/msda_fwd.cuh",
             "tools/bench_hi_probe.py:74")):
        for r in runs[tool]:
            if r["mode"] == "full":
                continue
            extra = {}
            if tool == "k1_modes":
                tsa = pick("k1_modes_tsa", r["mode"])
                extra["tsa"] = dict((k, tsa[k]) for k in ("ms", "plain_ms", "bound_ms", "max_abs_err"))
            records.append(rec(f"{name}[{r['mode']}]", source, replaces, r, r["launches"],
                               r["plain_ms"], library_note="no single PyTorch call",
                               scale=r["scale"], **extra))
    bf16, fp32 = pick("gather", "bf16"), pick("gather", "fp32")
    records.append(rec("row_gather", "bevformer_torch/csrc/row_gather.cu",
                       "tools/bench_dma_gather.py:46", bf16, counts["row_gather"],
                       bf16["plain_ms"], bf16["library_ms"], GB_per_s=bf16["GB_per_s"],
                       fp32=dict((k, fp32[k]) for k in ("ms", "library_ms", "bound_ms",
                                                        "GB_per_s", "bitwise_equal"))))
    return records


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
    """Route the model's three kernel call sites (msda, the DCN, the dense
    convs) to the plain versions (their gradients then come from autograd).
    With `noise`, each output is multiplied by (1 + noise * N(0, 1)), and so
    is each gradient that flows back into their inputs: a perturbation of
    the size of a few fp32 roundings. With `recompute`, each plain call runs under
    `torch.utils.checkpoint`: autograd recomputes its gathers in backward
    instead of keeping them (the SCA's alone are ~8 GB per encoder layer),
    with the same arithmetic."""
    import torch
    import torch.utils.checkpoint
    from bevformer_torch.kernels import conv, dcn, msda
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

    saved = attention.ms_deform_attn, resnet.dcn_conv, resnet.conv2d_nhwc
    attention.ms_deform_attn = perturbed(msda.ms_deform_attn_plain)
    resnet.dcn_conv = perturbed(dcn.dcn_conv_plain)
    resnet.conv2d_nhwc = perturbed(conv.conv2d_nhwc_plain)
    try:
        yield
    finally:
        attention.ms_deform_attn, resnet.dcn_conv, resnet.conv2d_nhwc = saved


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
    from bevformer_torch.kernels import conv, dcn, launch_counts, msda, zero_counts
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
    counts = launch_counts()
    k1, k2, kc = counts["msda_fwd"], counts["dcn_conv_fwd"], counts["conv_fwd"]
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[slice] launches: K1 {k1} ({k1 / n:g}/frame), K2 {k2} ({k2 / n:g}/frame), conv_fwd "
        f"{kc} ({kc / n:g}/frame)")
    check(counts["msda_bwd"] == counts["dcn_im2col"] == counts["dcn_col2im"] == 0,
          f"inference launched a backward kernel: {counts}")
    check(k1 == K1_PER_FRAME * n, f"K1 launched {k1} times, expected {K1_PER_FRAME * n}")
    check(k2 == K2_PER_FRAME * n, f"K2 launched {k2} times, expected {K2_PER_FRAME * n}")
    check(kc == CONV_PER_FRAME * n, f"conv_fwd launched {kc} times, expected {CONV_PER_FRAME * n}")
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
    check(msda.ms_deform_attn.launches == k1 and dcn.dcn_conv.launches == k2
          and conv.conv2d_nhwc.launches == kc, "the plain run launched a kernel")
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
    return dict(k1=k1, k2=k2, conv=kc, median_ms=median * 1e3, peak_gib=peak / 2**30,
                model=model, video=video)


FP32_TOL = 1e-6  # max abs err over max |flags off| of a frame run with the caller's TF32 on


def check_precision(model, video):
    """One frame with the caller's TF32 flags on for cuBLAS and cuDNN (cuDNN's
    is on by PyTorch's default) equals the same frame with them off (as this
    script runs): `VideoEvaluator.step` computes in the config's fp32 whatever
    the caller's flags, and hands them back."""
    import torch
    from bevformer_torch.runtime import VideoEvaluator

    sample = video.get_test_sample(0)

    def frame():
        preds = []
        hook = model.register_forward_hook(lambda m, i, out: preds.append(out))
        try:
            VideoEvaluator(model).infer_frame(sample)
        finally:
            hook.remove()
        return preds[0]

    off = frame()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        on = frame()
        after = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    errs = {k: rel_err(on[k], off[k]) for k in ("bev_embed", "all_cls_scores", "all_bbox_preds")}
    log(f"[precision] frame 0 with the caller's TF32 on vs off, max abs err / max |off|: "
        f"{fmt_errors(errs)} (tol {FP32_TOL:.0e}); flags after the frame: matmul "
        f"{after[0]}, cuDNN {after[1]}")
    check(after == (True, True), f"the caller's TF32 flags were not restored: {after}")
    for key, e in errs.items():
        check(e <= FP32_TOL, f"{key}: TF32-on caller vs off {e:.2e} > {FP32_TOL}")


# ---------------------------------------------------------------- presets

def conv_launches(cfg):
    """(a backbone pass's, a training step's trained frame's) launches of
    the dense conv kernel: the sites `engage_rule` gives it in a frame and
    in the trained frame (`models.conv_sites`)."""
    from bevformer_torch.models.conv_sites import conv_sites

    return tuple(sum(s["engaged"] for s in conv_sites(cfg, train=train))
                 for train in (False, True))


def path_launches(cfg):
    """(per frame, per training step) launches of every kernel counter on
    `cfg`'s paths: per frame TSA and SCA in each encoder layer and the
    cross-attention of each decoder layer (K1) and the DCN conv2 of every
    block of the DCN stages (K2), each kernel's bf16 entry under bf16; a
    training step runs its queue_length - 1 history frames encoder only,
    with one backbone pass over all their images, then the trained frame,
    whose K1 and K2 calls each run a backward (K3/K4; K5 and K6)."""
    from bevformer_torch.kernels import kernel_counters
    from bevformer_torch.models.resnet import ARCH_SETTINGS

    zero = dict.fromkeys(kernel_counters(), 0)
    sfx = "_bf16" if cfg.dtype == "bfloat16" else ""
    k1, k34, k2, k5, k6 = (name + sfx for name in ("msda_fwd", "msda_bwd", "dcn_conv_fwd",
                                                     "dcn_im2col", "dcn_col2im"))
    enc, dec = 2 * cfg.encoder_layers, cfg.decoder_layers
    dcn = sum(ARCH_SETTINGS[cfg.backbone_depth][s] for s in cfg.backbone_dcn_stages)
    history = cfg.data.queue_length - 1
    per_pass, trained = conv_launches(cfg)
    frame = dict(zero, **{k1: enc + dec, k2: dcn, "conv_fwd": per_pass})
    step = dict(zero, **{k1: history * enc + enc + dec, k34: enc + dec,
                         k2: (2 if history else 1) * dcn, k5: dcn, k6: dcn,
                         "conv_fwd": (per_pass if history else 0) + trained})
    return frame, step


def times(per: dict, n: int) -> dict:
    return {k: v * n for k, v in per.items()}


def preset_witness(model, video, noise, run=run_video):
    """Kernel vs plain and noisy plain vs plain over the video (max over the
    frames of max abs err / max |plain|), and the decoded results of the
    kernel and plain runs; the plain runs must launch no kernel. `run`
    (`run_video`, or `run_v2` over V2 samples) returns (results, head
    outputs, seconds, ...)."""
    from bevformer_torch.kernels import launch_counts

    results, preds = run(model, video)[:2]
    counts = launch_counts()
    with plain_kernels():
        plain_results, plain_preds, plain_secs = run(model, video)[:3]
    with plain_kernels(noise=noise):
        noisy_preds = run(model, video)[1]
    check(launch_counts() == counts, "a plain run launched a kernel")
    return (output_errors(preds, plain_preds), output_errors(noisy_preds, plain_preds),
            results, plain_results, plain_secs)


def frozen_bn_bytes(model, video) -> dict:
    """MB into and out of the backbone's FrozenBNs in one frame's backbone
    pass in the config's dtype, by dtype. Under bf16 a FrozenBN takes the
    bf16 output of its conv and, its statistics being fp32, gives fp32."""
    import torch
    from bevformer_torch.device import precision
    from bevformer_torch.models.resnet import FrozenBN

    seen = {"in": {}, "out": {}}

    def hook(m, inputs, out):
        for key, t in (("in", inputs[0]), ("out", out)):
            dt = str(t.dtype).replace("torch.", "")
            seen[key][dt] = seen[key].get(dt, 0.0) + t.nbytes / 1e6

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, FrozenBN)]
    try:
        with torch.no_grad(), precision(model.cfg.dtype, "cuda"):
            model.extract_feat(video.get_test_sample(0)["images"][None])
    finally:
        for h in hooks:
            h.remove()
    return seen


def check_preset(name, device, smi, dtype=None):
    """One of the v1 presets at full size with seeded weights, in its
    config's dtype or `dtype` (`--cfg-options dtype=...`): a
    4-frame video (scenes FRAMES) on the kernel path, with its launches per
    frame, frame median and peak memory, held to phase 10's witness against
    the plain path (undamped: within WITNESS_FACTOR of the plain path with
    noise of the config's rounding size on every msda and DCN output; with
    the reg branches' outputs x0.1: fp32 to SLICE_TOL, bf16 again within
    WITNESS_FACTOR of its noisy path); then PRESET_TRAIN_STEPS train-mode
    steps with their launches per step, step median and peak memory, and
    the damped witness on the trained weights."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.data import SyntheticVideo, train_batch
    from bevformer_torch.kernels import launch_counts, zero_counts
    from bevformer_torch.runtime import Trainer, build_model, init_state_dict

    cfg = get_config(name)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    bf16 = cfg.dtype == "bfloat16"
    noise = BF16_WITNESS_NOISE if bf16 else WITNESS_NOISE
    per_frame, per_step = path_launches(cfg)
    t0 = time.perf_counter()
    model = build_model(cfg, init_state_dict(cfg, seed=0), device)
    video = SyntheticVideo(cfg, scene_lengths=FRAMES, seed=0, device=device)
    n = len(video)
    log(f"[preset] {name}: {cfg.dtype}, {cfg.data.num_cams} x {cfg.data.img_size} images, "
        f"R{cfg.backbone_depth} {cfg.backbone_style} DCN stages {cfg.backbone_dcn_stages}, "
        f"{cfg.num_feature_levels} level(s), SCA capacity {cfg.sca_capacity_ratio}, "
        f"{cfg.encoder_layers}+{cfg.decoder_layers} layers, BEV {cfg.bev_h}x{cfg.bev_w}, queue "
        f"{cfg.data.queue_length}; weights ready in {time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    _, preds, secs = run_video(model, video)
    counts = launch_counts()
    frame_peak = torch.cuda.max_memory_allocated(device)
    check(counts == times(per_frame, n), f"{name}: video launched {counts}, want "
                                         f"{times(per_frame, n)}")
    for i, p in enumerate(preds):
        for key, v in p.items():
            check(bool(torch.isfinite(v).all()), f"{name} frame {i}: {key} not finite")
    check(tuple(preds[0]["all_cls_scores"].shape) ==
          (cfg.decoder_layers, 1, cfg.num_query, cfg.num_classes), f"{name}: cls shape")
    check(tuple(preds[0]["bev_embed"].shape) == (1, cfg.bev_h * cfg.bev_w, cfg.embed_dims),
          f"{name}: bev shape")
    frame_ms = median_of(secs[1:]) * 1e3
    bn_mb = frozen_bn_bytes(model, video)
    log(f"[preset] {name} video: launches per frame {per_frame}; frame seconds "
        f"{', '.join(f'{x:.4f}' for x in secs)}; median of frames 1-{n - 1}: {frame_ms:.1f} ms; "
        f"peak memory {frame_peak / 2**30:.2f} GiB; the backbone's FrozenBNs in one frame: "
        f"inputs {bn_mb['in']} MB, outputs {bn_mb['out']} MB; card: {smi}")
    del preds

    errs, noise_errs, _, _, plain_secs = preset_witness(model, video, noise)
    log(f"[preset] {name} witness, undamped: kernel vs plain: {fmt_errors(errs)}; plain x (1 + "
        f"{noise:.2e} N(0,1)) at every msda and DCN output vs plain: {fmt_errors(noise_errs)} "
        f"(kernel within {WITNESS_FACTOR:g}x); plain frame seconds "
        + ", ".join(f"{x:.4f}" for x in plain_secs))
    for key, e in errs.items():
        check(e <= WITNESS_FACTOR * max(noise_errs[key], 1e-7),
              f"{name} {key}: kernel vs plain {e:.2e} > {WITNESS_FACTOR:g} x {noise_errs[key]:.2e}")
    witness = dict(undamped=errs, undamped_noisy=noise_errs)

    trainer = Trainer(model, total_steps=TRAIN_TOTAL_STEPS, seed=0)
    batch = train_batch(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    step_secs, step_counts = timed_steps(trainer, batch, PRESET_TRAIN_STEPS, f"[preset] {name}")
    train_counts = launch_counts()
    step_peak = torch.cuda.max_memory_allocated(device)
    for i, c in enumerate(step_counts):
        check(c == per_step, f"{name} step {i} launched {c}, want {per_step}")
    step_ms = median_of(step_secs[1:]) * 1e3
    log(f"[preset] {name} training: launches per step {per_step}; step seconds "
        f"{', '.join(f'{x:.4f}' for x in step_secs)}; median of steps 1-"
        f"{PRESET_TRAIN_STEPS - 1}: {step_ms:.1f} ms; peak memory {step_peak / 2**30:.2f} GiB; "
        f"card: {smi}")
    k6 = None
    if bf16 and name == "bevformer_base":
        k6 = check_k6_bf16_training_step(trainer, batch, per_step["dcn_col2im_bf16"], smi)
    del trainer, batch

    damp_box_refinement(model)
    errs, noise_errs, results, plain_results, _ = preset_witness(model, video, noise)
    limit = {k: WITNESS_FACTOR * max(noise_errs[k], 1e-7) if bf16 else SLICE_TOL for k in errs}
    log(f"[preset] {name} witness on the trained weights, reg branch outputs x0.1: kernel vs "
        f"plain: {fmt_errors(errs)} (limits {fmt_errors(limit)}); noisy plain vs plain: "
        f"{fmt_errors(noise_errs)}")
    for key, e in errs.items():
        check(e <= limit[key], f"{name} {key} damped: kernel vs plain {e:.2e} > {limit[key]:.2e}")
    if not bf16:
        for i in range(n):
            sa = torch.as_tensor(results[i]["scores_3d"]).sort().values
            sb = torch.as_tensor(plain_results[i]["scores_3d"]).sort().values
            check(sa.shape == sb.shape and bool(torch.allclose(sa, sb, atol=1e-4)),
                  f"{name} frame {i}: decoded scores differ")
    witness.update(damped=errs, damped_noisy=noise_errs)
    del model, video
    torch.cuda.empty_cache()
    return dict(name=name, dtype=cfg.dtype, frame_ms=frame_ms, frame_peak_gib=frame_peak / 2**30,
                frame_launches=per_frame, step_ms=step_ms, step_peak_gib=step_peak / 2**30,
                step_launches=per_step, train_counts=train_counts, inference_counts=counts,
                witness=witness, frozen_bn_mb=bn_mb, k6=k6)


# ---------------------------------------------------------------- V2

V2_PRESETS = ("bevformerv2-r50-t1", "bevformerv2-r50-t8")
V2_SAMPLES = 4


def v2_per_sample(cfg) -> dict:
    """Launches per V2 sample: TSA and SCA in every encoder layer of every
    frame encoded, the decoder's cross-attention once; nothing else."""
    from bevformer_torch.kernels import kernel_counters

    k1 = len(cfg.frames) * 2 * cfg.encoder_layers + cfg.decoder_layers
    return dict(dict.fromkeys(kernel_counters(), 0), msda_fwd=k1,
                conv_fwd=len(cfg.frames) * conv_launches(cfg)[0])


def v2_samples(cfg, n: int, device):
    """`n` samples as `NuScenesTemporalDatasetV2.get_test_sample_v2` serves
    them: for each offset of `cfg.frames` six noise images (seeded) at the
    network's input size and the synthetic rigs' lidar2img; no flip, the
    identity unwarp."""
    import numpy as np
    from bevformer_torch.data.synth import _noise_images, rig_lidar2img

    h, w = cfg.data.img_size
    t = len(cfg.frames)
    l2i = np.stack([rig_lidar2img(w, h)[: cfg.data.num_cams]] * t).astype(np.float32)
    return [dict(images=_noise_images(cfg, t, 1000 + i, device), lidar2img=l2i,
                 flip=np.bool_(False), bda_mat=np.eye(2, dtype=np.float32),
                 token=f"v2_sample_{i}") for i in range(n)]


def run_v2(model, samples):
    """The samples through `VideoEvaluatorV2`: (results, the current
    frames' head outputs, each sample's seconds on the host clock between
    device syncs, each sample's ResNetFusion milliseconds from CUDA events
    around it, or [] without a fusion)."""
    import torch
    from bevformer_torch.runtime import VideoEvaluatorV2

    preds, fusion = [], []
    hooks = [model.register_forward_hook(lambda m, i, out: preds.append(out))]
    tr = model.pts_bbox_head.transformer
    if hasattr(tr, "fusion"):
        def pre(m, i):
            fusion.append([torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)])
            fusion[-1][0].record()

        hooks += [tr.fusion.register_forward_pre_hook(pre),
                  tr.fusion.register_forward_hook(lambda m, i, o: fusion[-1][1].record())]
    ev = VideoEvaluatorV2(model)
    results, secs = [], []
    try:
        for s in samples:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results.append(ev.infer_sample(s))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    finally:
        for h in hooks:
            h.remove()
    return results, preds, secs, [a.elapsed_time(b) for a, b in fusion]


def check_v2(name, device, smi):
    """A BEVFormerV2 preset at full size with seeded weights: V2_SAMPLES
    samples through `VideoEvaluatorV2` on the kernel path (K1 launches per
    sample, sample median, peak memory, ResNetFusion's time apart), every
    BatchNorm in eval mode, held to phase 10's witness against the plain
    path: within WITNESS_FACTOR of the noisy plain path undamped, to
    SLICE_TOL with the reg branches' outputs x0.1, the same decoded
    scores."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.kernels import launch_counts, zero_counts
    from bevformer_torch.runtime import build_model, init_state_dict

    cfg = get_config(name)
    per_sample = v2_per_sample(cfg)
    t0 = time.perf_counter()
    model = build_model(cfg, init_state_dict(cfg, seed=0), device)
    samples = v2_samples(cfg, V2_SAMPLES, device)
    n = len(samples)
    log(f"[v2] {name}: frames {cfg.frames}, {cfg.data.num_cams} x {cfg.data.img_size} images, "
        f"R{cfg.backbone_depth} {cfg.backbone_style} BN, FPN {len(cfg.neck_in_channels)} -> "
        f"{max(cfg.num_mono_levels, cfg.num_feature_levels)} levels ({cfg.num_feature_levels} "
        f"to the BEV), SCA capacity {cfg.sca_capacity_ratio}, {cfg.encoder_layers}+"
        f"{cfg.decoder_layers} layers, BEV {cfg.bev_h}x{cfg.bev_w}, {cfg.num_query} of "
        f"{cfg.num_query * cfg.group_detr} queries; weights ready in "
        f"{time.perf_counter() - t0:.1f} s")

    bn_modes = []
    bn_hooks = [m.register_forward_hook(lambda m, i, o: bn_modes.append(m.training))
                for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    _, preds, secs, fusion_ms = run_v2(model, samples)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    for h in bn_hooks:
        h.remove()
    check(counts == times(per_sample, n), f"{name}: launched {counts}, want "
                                          f"{times(per_sample, n)}")
    check(bn_modes and not any(bn_modes), f"{name}: {sum(bn_modes)} BN calls in train mode")
    for i, p in enumerate(preds):
        for key, v in p.items():
            check(bool(torch.isfinite(v).all()), f"{name} sample {i}: {key} not finite")
    check(tuple(preds[0]["all_cls_scores"].shape) ==
          (cfg.decoder_layers, 1, cfg.num_query, cfg.num_classes), f"{name}: cls shape")
    check(tuple(preds[0]["bev_embed"].shape) == (1, cfg.bev_h * cfg.bev_w, cfg.embed_dims),
          f"{name}: bev shape")
    sample_ms = median_of(secs[1:]) * 1e3
    fusion_median = median_of(fusion_ms[1:]) if fusion_ms else None
    log(f"[v2] {name}: K1 launches {counts['msda_fwd']} ({counts['msda_fwd'] / n:g} per sample: "
        f"{len(cfg.frames)} x {2 * cfg.encoder_layers} encoder + {cfg.decoder_layers} decoder); "
        f"{len(bn_modes)} BN calls, all in eval mode; sample seconds "
        f"{', '.join(f'{x:.4f}' for x in secs)}; median of samples 1-{n - 1}: {sample_ms:.1f} ms"
        + (f"; ResNetFusion {', '.join(f'{x:.2f}' for x in fusion_ms)} ms (CUDA events), "
           f"median {fusion_median:.2f} ms" if fusion_ms else "")
        + f"; peak memory {peak / 2**30:.2f} GiB; card: {smi}")
    del preds

    errs, noise_errs, _, _, plain_secs = preset_witness(model, samples, WITNESS_NOISE, run_v2)
    log(f"[v2] {name} witness, undamped: kernel vs plain: {fmt_errors(errs)}; plain x (1 + "
        f"{WITNESS_NOISE:.0e} N(0,1)) at every msda output vs plain: {fmt_errors(noise_errs)} "
        f"(kernel within {WITNESS_FACTOR:g}x); plain sample seconds "
        + ", ".join(f"{x:.4f}" for x in plain_secs))
    for key, e in errs.items():
        check(e <= WITNESS_FACTOR * max(noise_errs[key], 1e-7),
              f"{name} {key}: kernel vs plain {e:.2e} > {WITNESS_FACTOR:g} x {noise_errs[key]:.2e}")
    witness = dict(undamped=errs, undamped_noisy=noise_errs)
    damp_box_refinement(model)
    errs, noise_errs, results, plain_results, _ = preset_witness(model, samples, WITNESS_NOISE,
                                                                 run_v2)
    log(f"[v2] {name} witness, reg branch outputs x0.1: kernel vs plain: {fmt_errors(errs)} "
        f"(tol {SLICE_TOL:.0e}); noisy plain vs plain: {fmt_errors(noise_errs)}")
    for key, e in errs.items():
        check(e <= SLICE_TOL, f"{name} {key} damped: kernel vs plain {e:.2e} > {SLICE_TOL}")
    for i in range(n):
        sa = torch.as_tensor(results[i]["scores_3d"]).sort().values
        sb = torch.as_tensor(plain_results[i]["scores_3d"]).sort().values
        check(sa.shape == sb.shape and bool(torch.allclose(sa, sb, atol=1e-4)),
              f"{name} sample {i}: decoded scores differ")
    witness.update(damped=errs, damped_noisy=noise_errs)
    del model, samples
    torch.cuda.empty_cache()
    return dict(name=name, sample_ms=sample_ms, peak_gib=peak / 2**30,
                k1_per_sample=per_sample["msda_fwd"], counts=counts, fusion_ms=fusion_median,
                witness=witness)


KERNEL_NAMES = ("msda_fwd_kernel", "dcn_conv_fwd_kernel", "dcn_conv_fwd_bf16_kernel",
                "msda_bwd_kernel", "dcn_im2col_kernel", "dcn_col2im_kernel",
                "dcn_col2im_gw_kernel", "conv::conv_fwd_kernel")


def profile_run(fn, tag, what, smi):
    """Run `fn` once under torch.profiler: wall time, device kernel time,
    busy share, and the ops that take the device time. Returns (wall ms
    with the profiler on, device kernel ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bevformer_torch.utils.profiler import SPAN_PREFIX

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's events, less the program spans' ranges on its timeline
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.name.startswith(SPAN_PREFIX)]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, f"the profiled {what} ran nothing on the device")
    # device time by the aten op that launched it; the port's kernels are
    # launched through ctypes, under no aten op
    averages = prof.key_averages()
    rows = [
        (a.key, a.self_device_time_total / 1e3, a.count)
        for a in averages
        if a.self_device_time_total > 0
        and (a.key.startswith("aten::") or any(k in a.key for k in KERNEL_NAMES))
    ]
    # each of the port's kernels, all its instantiations together
    port = {k: (sum(a.self_device_time_total for a in averages if k in a.key) / 1e3,
                sum(a.count for a in averages if k in a.key)) for k in KERNEL_NAMES}
    rows.sort(key=lambda r: -r[1])
    log(f"[{tag}] {what}: wall {wall_ms:.2f} ms (profiler on), device kernel time "
        f"{busy_ms:.2f} ms in {len(kernels)} kernels, busy {busy_ms / wall_ms:.1%}, "
        f"idle {1 - busy_ms / wall_ms:.1%}; card: {smi}")
    for name, ms, count in rows[:PROFILE_ROWS]:
        log(f"[{tag}]   {ms:9.3f} ms {ms / busy_ms:6.1%} {count:5d} calls  {name[:70]}")
    log(f"[{tag}] the port's kernels: " + ", ".join(
        f"{k} {ms:.3f} ms ({n} calls)" for k, (ms, n) in port.items()))
    return wall_ms, busy_ms


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

def timed_steps(trainer, batch, steps: int, tag: str):
    """`steps` train steps of `trainer` on `batch`, each timed on the host
    clock between device syncs with its launches counted, its losses
    printed and checked finite: (seconds, launches) per step."""
    import torch
    from bevformer_torch.kernels import launch_counts

    secs, per_step = [], []
    for step in range(steps):
        start = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = trainer.step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        per_step.append({k: v - start[k] for k, v in launch_counts().items()})
        log(f"{tag} step {step}: loss {out['total']:.4f} (cls {out['loss_cls']:.4f}, "
            f"bbox {out['loss_bbox']:.4f}), grad_norm {out['grad_norm']:.3f}, "
            f"lr {out['lr']:.4e}, {secs[-1]:.4f} s, launches {per_step[-1]}")
        check(all(math.isfinite(v) for v in out.values()), f"{tag} step {step}: not finite: {out}")
    return secs, per_step


def check_training(device, smi):
    """bevformer_base at full size: TRAIN_STEPS train-mode steps."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.data import train_batch
    from bevformer_torch.kernels import launch_counts, zero_counts
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
    secs, per_step = timed_steps(trainer, batch, TRAIN_STEPS, "[train]")
    counts = launch_counts()
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
    k6 = check_k6_training_step(trainer, batch, smi)
    del trainer, model, batch, before
    return dict(counts=counts, median_ms=median * 1e3, peak_gib=peak / 2**30, k6=k6)


@contextmanager
def recorded_col2im(calls: list, name: str = "dcn_col2im"):
    """Within the block, each call of `dcn.<name>` (the DCN backward's K6:
    `dcn_col2im`, or `dcn_col2im_gw` on a bf16 x) also appends its
    arguments, defaults filled in, to `calls`: (x, off_y, off_x, mask,
    dcols, stride), or (x, off_y, off_x, mask, g, weight, stride)."""
    import inspect

    from bevformer_torch.kernels import dcn

    kernel = getattr(dcn, name)
    sig = inspect.signature(kernel)

    def recording(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append(tuple(bound.arguments.values()))
        return kernel(*args, **kwargs)

    # the fp32 wrapper counts its launches under the module's name, which
    # is this function's while recording: those launches land here
    recording.launches = 0
    setattr(dcn, name, recording)
    try:
        yield calls
    finally:
        setattr(dcn, name, kernel)


def check_k6_training_step(trainer, batch, smi):
    """K6 on what a training step hands it: one more step with every
    dcn_col2im call recorded (the offsets and masks of the model's offset
    convs, the column gradients of its backward); each call then runs alone
    on those tensors, timed, its dx adds counted, and the first call of each
    shape held against the plain version."""
    import torch
    from bevformer_torch.kernels import dcn
    from bevformer_torch.tools import roofline

    calls = []
    with recorded_col2im(calls):
        trainer.step(batch)
    torch.cuda.synchronize()
    want = TRAIN_PER_STEP["dcn_col2im"]
    check(len(calls) == want, f"the step made {len(calls)} dcn_col2im calls, expected {want}")
    shapes = {}
    for x, off_y, off_x, mask, dcols, stride in calls:
        b, h, w, c = x.shape
        key = f"x [{b}, {h}, {w}, {c}] stride {stride}"
        ms = time_ms(lambda: dcn.dcn_col2im(x, off_y, off_x, mask, dcols, stride), 5)
        adds = col2im_dx_adds(x.shape, off_y, off_x, stride)
        offsets = torch.cat([off_y.reshape(-1), off_x.reshape(-1)])
        if key not in shapes:
            ours = dcn.dcn_col2im(x, off_y, off_x, mask, dcols, stride)
            ref = dcn.dcn_col2im_plain(x, off_y, off_x, mask, dcols, stride)
            torch.cuda.synchronize()
            err = max(rel_err(a, r) for a, r in zip(ours, ref))
            del ours, ref
            check(err <= K56_TOL, f"dcn_col2im on the training step's {key}: {err:.2e} > "
                                  f"{K56_TOL}")
            shapes[key] = dict(calls=0, ms=0.0, dx_add_bytes=0, max_abs_err=err,
                               offset_rms_px=[], bound_ms=0.0)
        s = shapes[key]
        s["calls"] += 1
        s["ms"] += ms
        s["dx_add_bytes"] += adds * c * 4
        s["offset_rms_px"].append(float(offsets.square().mean().sqrt()))
        s["bound_ms"] += roofline.dcn_col2im(b, h, w, c, stride).bound_ms
    del calls
    for key, s in shapes.items():
        rms = s.pop("offset_rms_px")
        s["offset_rms_px"] = [min(rms), max(rms)]
        s["dx_add_TB_per_s"] = s["dx_add_bytes"] / s["ms"] / 1e9
        log(f"[train-k6] {key}: {s['calls']} calls, K6 {s['ms']:.4f} ms in all "
            f"({s['bound_ms'] / s['ms']:.1%} of their bound {s['bound_ms']:.4f}); dx adds "
            f"through global atomics {s['dx_add_bytes'] / 1e6:.1f} MB "
            f"({s['dx_add_TB_per_s']:.2f} TB/s); offsets' rms {s['offset_rms_px'][0]:.3f}"
            f"-{s['offset_rms_px'][1]:.3f} px; first call vs plain {s['max_abs_err']:.2e} of "
            f"scale (tol {K56_TOL:.0e})")
    total = dict(ms=sum(s["ms"] for s in shapes.values()),
                 bound_ms=sum(s["bound_ms"] for s in shapes.values()),
                 dx_add_bytes=sum(s["dx_add_bytes"] for s in shapes.values()), shapes=shapes)
    log(f"[train-k6] K6 on one training step's own inputs: {total['ms']:.4f} ms "
        f"({total['bound_ms'] / total['ms']:.1%} of its bound {total['bound_ms']:.4f}), "
        f"{total['dx_add_bytes'] / 1e6:.1f} MB of dx adds; card: {smi}")
    return total


def check_k6_bf16_training_step(trainer, batch, want: int, smi):
    """bf16 K6 (dcn_col2im_gw) on what a bf16 training step hands it: one
    more step with every call recorded (the offsets and masks of the
    model's offset convs, the bf16 output gradients, the weights); each
    call then runs alone on those tensors, timed, its dx adds counted and
    its offsets' rms taken, and held against the plain version (dx within
    BF16_FWD_ULPS bf16 ulps at its scale, d offsets and dmask within
    BF16_AUX_TOL)."""
    import torch
    from bevformer_torch.kernels import dcn
    from bevformer_torch.tools import roofline

    calls = []
    with recorded_col2im(calls, "dcn_col2im_gw"):
        trainer.step(batch)
    torch.cuda.synchronize()
    check(len(calls) == want, f"the bf16 step made {len(calls)} dcn_col2im_gw calls, expected "
                              f"{want}")
    shapes = {}
    for args in calls:
        x, off_y, off_x, mask, g, weight, stride = args
        b, h, w, c = x.shape
        key = f"x [{b}, {h}, {w}, {c}] Cout {weight.shape[1]} stride {stride}"
        ms = time_ms(lambda: dcn.dcn_col2im_gw(*args), 5)
        ours = dcn.dcn_col2im_gw(*args)
        ref = dcn.dcn_col2im_gw_plain(*args)
        torch.cuda.synchronize()
        errs = [ulps(ours[0], ref[0])] + [rel_err(a, r) for a, r in zip(ours[1:], ref[1:])]
        del ours, ref
        check(errs[0] <= BF16_FWD_ULPS and max(errs[1:]) <= BF16_AUX_TOL,
              f"dcn_col2im_gw on the bf16 step's {key}: dx {errs[0]:.3f} ulps, d offsets and "
              f"dmask {max(errs[1:]):.2e}")
        adds = col2im_dx_adds(x.shape, off_y, off_x, stride)
        offsets = torch.cat([off_y.reshape(-1), off_x.reshape(-1)]).detach()
        s = shapes.setdefault(key, dict(calls=0, ms=0.0, dx_add_bytes=0, dx_ulps=0.0,
                                        aux_err=0.0, offset_rms_px=[], bound_ms=0.0))
        s["calls"] += 1
        s["ms"] += ms
        s["dx_add_bytes"] += adds * c * 4
        s["dx_ulps"] = max(s["dx_ulps"], errs[0])
        s["aux_err"] = max(s["aux_err"], max(errs[1:]))
        s["offset_rms_px"].append(float(offsets.square().mean().sqrt()))
        s["bound_ms"] += roofline.dcn_col2im_gw(b, h, w, c, weight.shape[1], stride).bound_ms
    del calls
    for key, s in shapes.items():
        rms = s.pop("offset_rms_px")
        s["offset_rms_px"] = [min(rms), max(rms)]
        s["dx_add_TB_per_s"] = s["dx_add_bytes"] / s["ms"] / 1e9
        log(f"[train-k6-bf16] {key}: {s['calls']} calls, bf16 K6 {s['ms']:.4f} ms in all "
            f"({s['bound_ms'] / s['ms']:.1%} of their bound {s['bound_ms']:.4f}); dx adds "
            f"through global atomics {s['dx_add_bytes'] / 1e6:.1f} MB "
            f"({s['dx_add_TB_per_s']:.2f} TB/s); offsets' rms {s['offset_rms_px'][0]:.3f}"
            f"-{s['offset_rms_px'][1]:.3f} px; every call vs plain: dx {s['dx_ulps']:.3f} ulps "
            f"(tol {BF16_FWD_ULPS}), d offsets and dmask {s['aux_err']:.2e} (tol "
            f"{BF16_AUX_TOL:.0e})")
    total = dict(ms=sum(s["ms"] for s in shapes.values()),
                 bound_ms=sum(s["bound_ms"] for s in shapes.values()),
                 dx_add_bytes=sum(s["dx_add_bytes"] for s in shapes.values()), shapes=shapes)
    log(f"[train-k6-bf16] bf16 K6 on one bf16 training step's own inputs: {total['ms']:.4f} ms "
        f"({total['bound_ms'] / total['ms']:.1%} of its bound {total['bound_ms']:.4f}), "
        f"{total['dx_add_bytes'] / 1e6:.1f} MB of dx adds; card: {smi}")
    return total


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


def witness_model(device):
    """bevformer_base at seeded weights, its parameters trainable as in
    training, for the training witness."""
    from bevformer_torch.configs import get_config
    from bevformer_torch.runtime import build_model, init_state_dict, label_params

    cfg = get_config("bevformer_base")
    model = build_model(cfg, init_state_dict(cfg, seed=0), device)
    labels = label_params(model, cfg.optim.frozen_stages)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    return cfg, model


def witness_errors(model, batch, device):
    """Kernel vs plain and noisy plain vs plain (eval mode; the plain calls
    recompute their gathers in backward, so that they fit the card), and the
    plain path's peak memory."""
    import torch
    from bevformer_torch.kernels import launch_counts

    kernel = train_grads(model, batch)
    counts = launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    with plain_kernels(recompute=True):
        plain = train_grads(model, batch)
    peak = torch.cuda.max_memory_allocated(device)
    check(launch_counts() == counts, "the plain run launched a kernel")
    with plain_kernels(noise=WITNESS_NOISE, recompute=True):
        noisy = train_grads(model, batch)
    return grad_errors(kernel, plain), grad_errors(noisy, plain), peak


def witness_failures(errs, noise_errs, damped: bool):
    """What the training witness refuses, from kernel vs plain (`errs`) and
    noisy plain vs plain (`noise_errs`). Undamped, every key stays within
    WITNESS_FACTOR of the noisy path. Damped, the decoder no longer
    amplifies rounding: the loss and the transformer-side groups are held to
    TRAIN_TOL, on a batch at which the noisy path itself stays within it
    (where it does not, a switch sits within fp32 rounding of its edge and
    the check would measure that switch, not the kernels). The backbone's
    gradient still moves where one of its ~1e8 ReLU inputs sits within fp32
    rounding of 0 and flips between the two paths, which the damping does
    not reach: it is held to the noisy witness, as undamped."""
    fails = []
    for key, e in errs.items():
        noisy = noise_errs[key]
        limit = WITNESS_FACTOR * max(noisy, 1e-7)
        if damped and key != "backbone":
            limit = TRAIN_TOL
            if noisy > TRAIN_TOL:
                fails.append(f"{key}: noisy plain vs plain {noisy:.2e} > {TRAIN_TOL:.0e}: "
                             f"the batch puts a switch within fp32 noise")
        if e > limit:
            fails.append(f"{key}: kernel vs plain {e:.2e} > {limit:.2e}")
    return fails


def check_training_witness(device, smi):
    """Kernel path against plain path at full size, undamped and damped."""
    import torch
    from bevformer_torch.data import train_batch

    cfg, model = witness_model(device)
    # a batch at which fp32-sized noise on the plain path stays within
    # TRAIN_TOL damped (checked). At seed 1 it does not: a switch in decoder
    # layer 4 sits within fp32 rounding of its edge there, and the noise,
    # like either kernel alone, flips it; every transformer-side group then
    # moves by ~3e-3 (bevformer_torch/tools/witness_seeds.py surveys seeds)
    batch = train_batch(cfg, seed=WITNESS_BATCH_SEED, device=device)
    log(f"[witness] {cfg.name} at {cfg.data.num_cams} x {cfg.data.img_size} images, "
        f"queue {cfg.data.queue_length}, batch seed {WITNESS_BATCH_SEED}, eval mode; errors are "
        f"|loss| relative and ||kernel - plain|| / ||plain|| of each gradient group")

    errs, noise_errs, peak = witness_errors(model, batch, device)
    log(f"[witness] undamped: kernel vs plain: {fmt_errors(errs)}; plain x (1 + "
        f"{WITNESS_NOISE:.0e} N(0,1)) at every msda and DCN output and input gradient vs "
        f"plain: {fmt_errors(noise_errs)} (kernel must stay within {WITNESS_FACTOR:g}x); "
        f"plain path peak memory {peak / 2**30:.2f} GiB; card: {smi}")
    fails = witness_failures(errs, noise_errs, damped=False)
    check(not fails, "; ".join(fails))

    damp_box_refinement(model)
    errs, noise_errs, _ = witness_errors(model, batch, device)
    log(f"[witness] reg branch outputs x0.1: kernel vs plain: {fmt_errors(errs)} "
        f"(tol {TRAIN_TOL:.0e}; backbone within {WITNESS_FACTOR:g}x of noisy); noisy plain vs "
        f"plain: {fmt_errors(noise_errs)}")
    fails = witness_failures(errs, noise_errs, damped=True)
    check(not fails, "; ".join(fails))
    del model, batch
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- V2 training

# (preset, steps at the 640 rung); t1 also takes one step at V2_BIG_RUNG
V2_TRAIN = (("bevformerv2-r50-t1", 4), ("bevformerv2-r50-t8", 4))
V2_BIG_RUNG = 768
V2_GROUPS = GROUPS[:-1] + (("mono", "fcos3d_bbox_head."),) + GROUPS[-1:]
# K1 and K3/K4 at V2 training's new shapes: the decoder over 900 x 11
# GroupDETR queries, SCA over the 768 rung's levels (6 x 768 x 1920 input)
K1_V2_TRAIN_CASES = [
    ("decoder x11 groups", 1, 9900, 8, 32, ((200, 200),), 4, 6),
    ("sca 768 rung", 6, 10112, 8, 32, ((96, 240), (48, 120), (24, 60), (12, 30)), 8, 6),
]


def v2_train_per_step(cfg) -> dict:
    """Launches per V2 training step: K1 in every encoder layer of every
    frame encoded and in the decoder once; K3/K4 once per K1 call of the
    current frame; the dense conv kernel in the history frames (eval-mode
    BN, no gradient); nothing else."""
    zero = v2_per_sample(cfg)
    return dict(zero, msda_bwd=2 * cfg.encoder_layers + cfg.decoder_layers,
                conv_fwd=(len(cfg.frames) - 1) * conv_launches(cfg)[0])


def check_k34_v2(device, gen):
    """K3/K4 against autograd through the plain msda at V2 training's new
    shapes (`K1_V2_TRAIN_CASES`)."""
    import torch
    from bevformer_torch.tools import roofline

    rows = []
    for name, b, q, h, d, shapes, p, per_step in K1_V2_TRAIN_CASES:
        value, loc, attw = msda_inputs(b, q, h, d, shapes, p, gen, device)
        g = torch.randn((b, q, h * d), generator=gen, device=device)
        cost = roofline.msda_bwd(b, q, h, d, shapes, p)
        rows.append(dict(shape=name, per_step=per_step, bound_ms=cost.bound_ms,
                         bound_by=cost.bound_by,
                         **k34_case(f"v2-train {name}", value, shapes, loc, attw, g, cost)))
        del value, loc, attw, g
    return rows


@contextmanager
def fusion_timer(model):
    """CUDA events around ResNetFusion's forward and its backward (from
    the gradient of its output to that of the current frame's BEV, its one
    input with a gradient); yields a list of [fwd_start, fwd_end,
    bwd_start, bwd_end] per call (empty without a fusion)."""
    import torch

    calls = []
    tr = model.pts_bbox_head.transformer
    if not hasattr(tr, "fusion"):
        yield calls
        return
    cur = model.cfg.frames.index(0)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def pre(m, inputs):
        calls.append([event()])

    def post(m, inputs, out):
        calls[-1].append(event())
        rec = calls[-1]
        if out.requires_grad:
            out.register_hook(lambda g: rec.append(event()))
            inputs[0][cur].register_hook(lambda g: rec.append(event()))

    hooks = [tr.fusion.register_forward_pre_hook(pre), tr.fusion.register_forward_hook(post)]
    try:
        yield calls
    finally:
        for h in hooks:
            h.remove()


def v2_step_line(out) -> str:
    mono = sum(v for k, v in out.items() if k.endswith("_mono"))
    return (f"loss {out['total']:.4f} (cls {out['loss_cls']:.4f}, bbox {out['loss_bbox']:.4f}, "
            f"mono {mono:.4f}), grad_norm {out['grad_norm']:.3f}, lr {out['lr']:.4e}")


def v2_train_steps(trainer, batch, steps, tag):
    """`steps` V2 train steps, each timed on the host clock between device
    syncs with its launches and cost transfers counted: (seconds, launches,
    transfers) per step."""
    import torch
    from bevformer_torch.core.assigner import assign_costs
    from bevformer_torch.kernels import launch_counts

    secs, per_step, transfers = [], [], []
    for step in range(steps):
        start, moved = launch_counts(), assign_costs.transfers
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = trainer.step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        per_step.append({k: v - start[k] for k, v in launch_counts().items()})
        transfers.append(assign_costs.transfers - moved)
        log(f"{tag} step {step}: {v2_step_line(out)}, {secs[-1]:.4f} s, K1 "
            f"{per_step[-1]['msda_fwd']}, K3/K4 {per_step[-1]['msda_bwd']}, cost transfers "
            f"{transfers[-1]}")
        check(all(math.isfinite(v) for v in out.values()), f"{tag} step {step}: not finite: {out}")
    return secs, per_step, transfers


def train_grads_v2(model, batch):
    """The V2 loss in the model's mode and its gradients per `V2_GROUPS`
    group; the BatchNorms' running statistics are put back after it."""
    import torch
    from bevformer_torch.runtime import loss_fn_v2

    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k
             or k.endswith("num_batches_tracked")}
    model.zero_grad(set_to_none=True)
    total, _ = loss_fn_v2(model, batch)
    total.backward()
    grads = {}
    for g, prefix in V2_GROUPS:
        grads[g] = torch.cat([p.grad.reshape(-1) for n, p in model.named_parameters()
                              if next(gg for gg, pre in V2_GROUPS if n.startswith(pre)) == g])
    model.zero_grad(set_to_none=True)
    model.load_state_dict(stats, strict=False)
    torch.cuda.empty_cache()
    return float(total.detach()), grads


def v2_training_witness(name, device, smi):
    """The V2 training witness at full size: dropout and GridMask off,
    BatchNorm in train mode, every GroupDETR group and DD3D on; loss and
    per-group gradients of the kernel path against the plain path, held to
    phase 9's rule (`witness_failures`), undamped and with the reg
    branches' outputs x0.1."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.data.synth import train_batch_v2
    from bevformer_torch.kernels import launch_counts
    from bevformer_torch.runtime import build_model, init_state_dict

    cfg = get_config(name, use_grid_mask=False)
    model = build_model(cfg, init_state_dict(cfg, seed=0), device).train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    batch = train_batch_v2(cfg, seed=WITNESS_BATCH_SEED, device=device)
    out = {}
    for damped in (False, True):
        if damped:
            damp_box_refinement(model)
        kernel = train_grads_v2(model, batch)
        counts = launch_counts()
        with plain_kernels(recompute=True):
            plain = train_grads_v2(model, batch)
        with plain_kernels(noise=WITNESS_NOISE, recompute=True):
            noisy = train_grads_v2(model, batch)
        check(launch_counts() == counts, "the plain run launched a kernel")
        errs, noise_errs = grad_errors(kernel, plain), grad_errors(noisy, plain)
        tag = "reg branch outputs x0.1" if damped else "undamped"
        log(f"[v2-train] {name} witness ({tag}; BN in train mode, dropout and GridMask off): "
            f"kernel vs plain: {fmt_errors(errs)}; noisy plain vs plain: {fmt_errors(noise_errs)}"
            f"; card: {smi}")
        fails = witness_failures(errs, noise_errs, damped=damped)
        check(not fails, f"{name} training witness: " + "; ".join(fails))
        out["damped" if damped else "undamped"] = errs
        out[("damped" if damped else "undamped") + "_noisy"] = noise_errs
    del model, batch
    torch.cuda.empty_cache()
    return out


def check_v2_training(name, steps, device, smi):
    """A V2 preset at full size with seeded weights: `steps` AdamW steps
    (`Trainer.step`, train mode: GridMask, dropout, BatchNorm on batch
    statistics, GroupDETR's groups, DD3D) on a seeded synthetic batch at the
    640 rung (`train_batch_v2`): K1 and K3/K4 launches and cost transfers
    per step, finite losses, every parameter and BN running statistic
    moved, the step median and peak memory, ResNetFusion's forward and
    backward (t8). t1 also takes one step at the 768 rung (its peak) and the
    training witness."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.data.synth import train_batch_v2
    from bevformer_torch.kernels import zero_counts
    from bevformer_torch.runtime import Trainer, build_model, init_state_dict

    cfg = get_config(name)
    want = v2_train_per_step(cfg)
    t0 = time.perf_counter()
    model = build_model(cfg, init_state_dict(cfg, seed=0), device)
    trainer = Trainer(model, total_steps=TRAIN_TOTAL_STEPS, seed=0)
    batch = train_batch_v2(cfg, seed=0, device=device)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n_mono = int(batch.mono_targets["num_gt"].sum())
    log(f"[v2-train] {name}: frames {cfg.frames}, {cfg.data.num_cams} x "
        f"{tuple(batch.images.shape[-3:-1])} images (640 rung), {int(batch.num_gt[0])} GT boxes "
        f"({n_mono} DD3D targets over the cameras), GroupDETR {cfg.group_detr} x "
        f"{cfg.num_query} queries, DD3D over {cfg.num_mono_levels} levels, "
        f"{sum(p.numel() for p in trainer.params)} trainable parameters; ready in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    with fusion_timer(model) as fusion:
        secs, per_step, transfers = v2_train_steps(trainer, batch, steps, f"[v2-train] {name}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    for step, c in enumerate(per_step):
        check(c == want, f"{name} step {step} launched {c}, expected {want}")
    check(all(n == 1 for n in transfers), f"{name}: cost transfers per step {transfers}")
    for key, value in model.state_dict().items():
        if not key.endswith(("num_batches_tracked", "_depth_per_level")):
            check(not torch.equal(value, before[key]), f"{name}: {key} did not move")
    median = median_of(secs[1:]) * 1e3
    res = dict(name=name, step_ms=median, peak_gib=peak / 2**30, per_step=want)
    fusion_line = ""
    if fusion:
        fwd = [c[0].elapsed_time(c[1]) for c in fusion]
        bwd = [c[2].elapsed_time(c[3]) for c in fusion if len(c) == 4]
        res.update(fusion_fwd_ms=median_of(fwd[1:]), fusion_bwd_ms=median_of(bwd[1:]))
        fusion_line = (f"; ResNetFusion forward {', '.join(f'{x:.2f}' for x in fwd)} ms, backward "
                       f"{', '.join(f'{x:.2f}' for x in bwd)} ms (CUDA events)")
    log(f"[v2-train] {name}: step seconds {', '.join(f'{x:.4f}' for x in secs)}; median of "
        f"steps 1-{steps - 1}: {median:.1f} ms; K1 {want['msda_fwd']} and K3/K4 "
        f"{want['msda_bwd']} launches per step; 1 cost transfer per step; every parameter and "
        f"running statistic moved; peak memory {peak / 2**30:.2f} GiB{fusion_line}; card: {smi}")
    if name == "bevformerv2-r50-t1":
        del batch
        big = train_batch_v2(cfg, seed=1, device=device, rung=V2_BIG_RUNG)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        secs, per_step, _ = v2_train_steps(trainer, big, 1, f"[v2-train] {name} {V2_BIG_RUNG} rung")
        check(per_step[0] == want, f"{name} {V2_BIG_RUNG} rung launched {per_step[0]}")
        res.update(big_step_ms=secs[0] * 1e3,
                   big_peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
        log(f"[v2-train] {name}: one step at the {V2_BIG_RUNG} rung ({cfg.data.num_cams} x "
            f"{tuple(big.images.shape[-3:-1])} images) {secs[0] * 1e3:.1f} ms (its first), peak "
            f"memory {res['big_peak_gib']:.2f} GiB; card: {smi}")
        del big
    del trainer, model, before
    torch.cuda.empty_cache()
    if name == "bevformerv2-r50-t1":
        res["witness"] = v2_training_witness(name, device, smi)
    return res


# ---------------------------------------------------------------- CLIs

CLI_TRAIN_STEPS = 4  # tools.train bevformer_base, then
CLI_RESUME_STEPS = 6  # --resume-from to here: mid-way through the 8 train frames' epoch
# phase 12's one root: 4 scenes x 4 frames at 1600 x 900 (2 train, 2 val
# scenes); phase 17's tools.test splits its 8 val frames at a scene start
CLI_SCENES, CLI_FRAMES = 4, 4
CLI_TIMEOUT = 600  # seconds per CLI process
PERFECT_TOL = 1e-9  # |mAP - 1| and every TP error of the ground truth scored against itself


def run_cli(args, what):
    """`python3 -m <args>` from the checkout's root. Returns the JSON lines
    it printed and its wall seconds; fails on a nonzero exit."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=CLI_TIMEOUT)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        log(f"[cli] {what} stdout:\n{proc.stdout[-4000:]}\n[cli] {what} stderr:\n"
            f"{proc.stderr[-8000:]}")
    check(proc.returncode == 0, f"{what} exited {proc.returncode}")
    records = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return records, secs


MAINS = """import json, sys
from importlib import import_module
for i, (module, argv) in enumerate(json.loads(sys.argv[1])):
    print(json.dumps({"run": i}), flush=True)
    import_module(module).main(argv)
"""


def run_mains(calls, what):
    """`module.main(argv)` for each (module, argv) of `calls`, in order in
    one process (one start-up; the later runs on a warm card), as `run_cli`
    runs one CLI: the JSON lines of each run, and the process's wall
    seconds. Each CLI counts the launches of its own run."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", MAINS, json.dumps(calls)], cwd=ROOT,
                          capture_output=True, text=True, timeout=CLI_TIMEOUT)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        log(f"[cli] {what} stdout:\n{proc.stdout[-4000:]}\n[cli] {what} stderr:\n"
            f"{proc.stderr[-8000:]}")
    check(proc.returncode == 0, f"{what} exited {proc.returncode}")
    runs = []
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if list(rec) == ["run"]:
                runs.append([])
            else:
                runs[-1].append(rec)
    check(len(runs) == len(calls), f"{what}: {len(runs)} runs of {len(calls)}")
    return runs, secs


def one(records, key, what):
    found = [r for r in records if key in r]
    check(len(found) == 1, f"{what}: {len(found)} lines with {key!r}")
    return found[0]


def perfect_detector(data_root, cfg, device):
    """The val split's own ground truth, scored as predictions by the port's
    evaluate_detections: mAP 1 and every TP error 0."""
    import numpy as np
    from bevformer_torch.core.evaluation import evaluate_detections
    from bevformer_torch.data import NuScenesTemporalDataset

    ds = NuScenesTemporalDataset(os.path.join(data_root, "nuscenes_infos_temporal_val.pkl"),
                                 cfg, load_images=False, data_root=data_root,
                                 device=device)
    gt = ds.gt_by_token(range(len(ds)))
    results = [dict(token=t, boxes_3d=g["boxes"].copy(), labels_3d=g["labels"].copy(),
                    scores_3d=np.linspace(0.9, 0.5, len(g["boxes"]))) for t, g in gt.items()]
    m = evaluate_detections(results, gt)
    n_gt = sum(len(g["boxes"]) for g in gt.values())
    log(f"[cli] perfect detector on the val split ({len(gt)} frames, {n_gt} GT boxes): "
        f"mAP {m['mean_ap']!r}, NDS {m['nd_score']!r}, TP errors {m['tp_errors']}")
    check(n_gt > 0, "the val split has no ground truth")
    check(abs(m["mean_ap"] - 1.0) <= PERFECT_TOL, f"perfect detector mAP {m['mean_ap']}")
    for k, v in m["tp_errors"].items():
        check(abs(v) <= PERFECT_TOL, f"perfect detector {k} {v}")
    return m


def median_of(xs):
    """The median (of an even count, the mean of the middle two); NaN of
    none."""
    xs, m = sorted(xs), len(xs) // 2
    if not xs:
        return float("nan")
    return xs[m] if len(xs) % 2 else (xs[m - 1] + xs[m]) / 2


FP16_CLI_STEPS = 2  # tools.fp16.train bevformer_tiny
FUSE_SCORE_TOL = 1e-4  # tools.test --fuse-conv-bn vs unfolded: decoded scores, max abs
FUSE_BOX_TOL = 1e-3  # ... and matched boxes, max abs err over max |box|


def box_set_errors(ours, ref):
    """Two runs' decoded boxes of one frame, matched as sets (top-k may
    order near-ties differently): each box of `ref` to the unused box of
    `ours` with its label and a score within FUSE_SCORE_TOL that is closest
    to it. Returns (max score difference of the sorted scores, max abs
    error of the matched boxes over max |box|, boxes without a match)."""
    import numpy as np

    if len(ours["scores_3d"]) != len(ref["scores_3d"]):
        return float("inf"), float("inf"), len(ref["scores_3d"])
    so, sr = np.sort(ours["scores_3d"]), np.sort(ref["scores_3d"])
    score_err = float(np.abs(so - sr).max()) if len(sr) else 0.0
    scale = max(float(np.abs(ref["boxes_3d"]).max()) if len(sr) else 0.0, 1e-6)
    used = np.zeros(len(so), bool)
    worst, missing = 0.0, 0
    for i in np.argsort(-ref["scores_3d"], kind="stable"):
        cand = np.flatnonzero(~used & (ours["labels_3d"] == ref["labels_3d"][i])
                              & (np.abs(ours["scores_3d"] - ref["scores_3d"][i]) <= FUSE_SCORE_TOL))
        if not len(cand):
            missing += 1
            continue
        err = np.abs(ours["boxes_3d"][cand] - ref["boxes_3d"][i]).max(-1)
        used[cand[np.argmin(err)]] = True
        worst = max(worst, float(err.min()) / scale)
    return score_err, worst, missing


def check_cli_fp16_and_fuse(data, root, smi):
    """`tools.fp16.train bevformer_tiny` for FP16_CLI_STEPS steps on the
    phase's root (bf16: the bf16 K1 and K3/K4 launches per step of
    bevformer_tiny_fp16), then `tools.test bevformer_tiny` on its checkpoint
    without and with `--fuse-conv-bn`, the three in one process: the K1
    launches per frame of tiny, and the same decoded boxes (scores to
    FUSE_SCORE_TOL, matched boxes to FUSE_BOX_TOL of scale)."""
    from bevformer_torch.configs import get_config

    work = os.path.join(root, "work_fp16")
    what = f"tools.fp16.train bevformer_tiny to step {FP16_CLI_STEPS}"
    ckpt = os.path.join(work, "ckpts", f"iter_{FP16_CLI_STEPS}.pth")
    fold = fold_comparison("bevformer_tiny", data, ckpt, work,
                           path_launches(get_config("bevformer_tiny"))[0], smi, before=[
                               ("bevformer_torch.tools.fp16.train",
                                ["bevformer_tiny", "--data-root", data, "--work-dir", work,
                                 "--max-iters", str(FP16_CLI_STEPS), "--log-interval", "1"])])
    recs = fold["before"][0]
    done = one(recs, "done", what)
    steps = [r for r in recs if "step_ms" in r and "done" not in r]
    want = times(path_launches(get_config("bevformer_tiny_fp16"))[1], done["steps"])
    check(done["launches"] == want, f"{what}: launches {done['launches']}, want {want}")
    check(all(math.isfinite(r["total"]) for r in steps), f"{what}: {steps}")
    log(f"[cli] {what} (first of the process's runs, {fold['seconds']:.1f} s), peak "
        f"{done['peak_gib']} GiB, launches {done['launches']}; steps: " + "; ".join(
            f"{r['step']}: loss {r['total']:.4f} step {r['step_ms']:.1f} ms" for r in steps))
    return dict(fp16_step_ms=median_of([r["step_ms"] for r in steps[1:]]),
                fp16_peak_gib=done["peak_gib"], fuse_score_err=fold["score_err"],
                fuse_box_err=fold["box_err"], fuse_frame_ms=fold["folded_ms"],
                unfused_frame_ms=fold["unfolded_ms"])


def check_cli_base_bf16(data, root, smi):
    """`tools.train bevformer_base --cfg-options dtype=bfloat16` for
    BF16_CLI_STEPS steps on the phase's root, then `tools.test
    bevformer_base --cfg-options dtype=bfloat16` on its checkpoint over
    BF16_CLI_FRAMES val frames, the two in one process: the bf16 K1-K6
    launches per step and per frame, finite losses and metrics."""
    from bevformer_torch.configs import get_config

    cfg = get_config("bevformer_base").replace(dtype="bfloat16")
    per_frame, per_step = path_launches(cfg)
    work = os.path.join(root, "work_bf16")
    what = f"tools.train bevformer_base dtype=bfloat16 to step {BF16_CLI_STEPS}"
    test_what = f"tools.test bevformer_base dtype=bfloat16 over {BF16_CLI_FRAMES} frames"
    (recs, test_recs), secs = run_mains([
        ("bevformer_torch.tools.train",
         ["bevformer_base", "--data-root", data, "--work-dir", work, "--max-iters",
          str(BF16_CLI_STEPS), "--log-interval", "1", "--cfg-options", "dtype=bfloat16"]),
        ("bevformer_torch.tools.test",
         ["bevformer_base", "--data-root", data, "--checkpoint",
          os.path.join(work, "ckpts", f"iter_{BF16_CLI_STEPS}.pth"), "--out",
          os.path.join(work, "results.json"), "--max-samples", str(BF16_CLI_FRAMES),
          "--cfg-options", "dtype=bfloat16"])], f"{what}, then {test_what}")
    done = one(recs, "done", what)
    steps = [r for r in recs if "step_ms" in r and "done" not in r]
    want = times(per_step, done["steps"])
    check(done["launches"] == want, f"{what}: launches {done['launches']}, want {want}")
    check(all(math.isfinite(r["total"]) for r in steps), f"{what}: {steps}")
    log(f"[cli] {what} (the process of it and the test {secs:.1f} s), peak {done['peak_gib']} "
        f"GiB, launches {done['launches']}; steps: " + "; ".join(
            f"{r['step']}: loss {r['total']:.4f} step {r['step_ms']:.1f} ms" for r in steps))

    what = test_what
    timing = one(test_recs, "frame_ms", what)
    summary = one(test_recs, "NDS", what)
    want = times(per_frame, timing["frames"])
    check(timing["frames"] == BF16_CLI_FRAMES, f"{what}: {timing['frames']} frames")
    check(timing["launches"] == want, f"{what}: launches {timing['launches']}, want {want}")
    check(all(math.isfinite(v) for v in summary.values()), f"{what}: {summary}")
    log(f"[cli] {what}: frame ms {[round(x, 1) for x in timing['frame_ms']]}, "
        f"peak {timing['peak_gib']} GiB, launches {timing['launches']}; {json.dumps(summary)}; "
        f"card: {smi}")
    return dict(bf16_step_ms=median_of([r["step_ms"] for r in steps[1:]]),
                bf16_train_peak_gib=done["peak_gib"], bf16_frame_ms=timing["frame_ms_median"],
                bf16_test_peak_gib=timing["peak_gib"])


def fold_comparison(name, data, ckpt, work, per_frame, smi, before=()):
    """`tools.test <name>` on `ckpt` over the val frames without and with
    `--fuse-conv-bn`, the two runs in one process (`run_mains`): each run
    launches every kernel `per_frame` times a frame and gives finite
    metrics, and the two give the same decoded boxes; the (module, argv)
    calls `before` run first in the same process (their JSON lines come
    back as the result's "before")
    (scores to FUSE_SCORE_TOL, matched boxes to FUSE_BOX_TOL of scale).
    Returns each run's frame median and the two errors."""
    import numpy as np

    runs, res = {}, {}
    tags = (("unfolded", []), ("folded", ["--fuse-conv-bn"]))
    outs = {tag: os.path.join(work, f"{name}_{tag}.json") for tag, _ in tags}
    recs_by_run, secs = run_mains([*before] + [
        ("bevformer_torch.tools.test",
         [name, "--data-root", data, "--checkpoint", ckpt, "--out", outs[tag], *more])
        for tag, more in tags], f"tools.test {name} unfolded, then folded, in one process")
    res["before"], res["seconds"] = recs_by_run[:len(before)], secs
    for (tag, _), recs in zip(tags, recs_by_run[len(before):]):
        what = f"tools.test {name} {tag}"
        timing = one(recs, "frame_ms", what)
        summary = one(recs, "NDS", what)
        want = times(per_frame, timing["frames"])
        check(timing["launches"] == want, f"{what}: launches {timing['launches']}, want {want}")
        check(all(math.isfinite(v) for v in summary.values()), f"{what}: {summary}")
        with open(outs[tag]) as f:
            runs[tag] = {r["token"]: {k: np.asarray(v) for k, v in r.items() if k != "token"}
                         for r in json.load(f)}
        log(f"[cli] {what} ({secs:.1f} s for the process's {len(recs_by_run)} runs) over "
            f"{timing['frames']} frames, "
            f"frame ms {[round(x, 1) for x in timing['frame_ms']]} (load "
            f"{[round(x, 1) for x in timing['load_ms']]}), median {timing['frame_ms_median']:.1f} "
            f"ms, peak {timing['peak_gib']} GiB, launches {timing['launches']}; NDS "
            f"{summary['NDS']!r} mAP {summary['mAP']!r}")
        res[f"{tag}_ms"] = timing["frame_ms_median"]
    tokens = sorted(runs["unfolded"])
    check(tokens == sorted(runs["folded"]), f"{name}: the folded run scored other frames")
    errs = [box_set_errors(runs["folded"][t], runs["unfolded"][t]) for t in tokens]
    res.update(score_err=max(e[0] for e in errs), box_err=max(e[1] for e in errs))
    missing = sum(e[2] for e in errs)
    log(f"[cli] {name} --fuse-conv-bn vs unfolded over {len(tokens)} frames: decoded scores max "
        f"abs diff {res['score_err']:.3e} (tol {FUSE_SCORE_TOL:.0e}), matched boxes max abs err / "
        f"max |box| {res['box_err']:.3e} (tol {FUSE_BOX_TOL:.0e}), boxes without a match "
        f"{missing}; card: {smi}")
    check(missing == 0 and res["score_err"] <= FUSE_SCORE_TOL and res["box_err"] <= FUSE_BOX_TOL,
          f"{name} --fuse-conv-bn boxes differ: scores {res['score_err']:.2e}, boxes "
          f"{res['box_err']:.2e}, {missing} unmatched")
    return res


def damped_v2_checkpoint(name, path):
    """A model-zoo-layout `.pth` of `name`'s seeded weights (with each BN's
    num_batches_tracked, as the reference's carry) whose reg branches'
    output layers are scaled by 0.1, as `damp_box_refinement` does: at
    undamped random weights the box refinement turns the fold's fp32
    rounding into moves of 1e-3 in the decoded scores."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.runtime import init_state_dict

    cfg = get_config(name)
    sd = {k: torch.from_numpy(v) for k, v in init_state_dict(cfg, seed=0).items()}
    for lid in range(cfg.decoder_layers):
        sd[f"pts_bbox_head.reg_branches.{lid}.4.weight"] *= 0.1
    torch.save({"meta": {}, "state_dict": sd}, path)


def check_cli_v2(data, root, smi):
    """`tools.test bevformerv2-r50-t1-base` on the phase's root (V2 crops
    its 900-row cameras to 640 rows), from a `.pth` of seeded weights with
    the box refinement damped (`damped_v2_checkpoint`; seeded weights give
    NDS/mAP 0: a plumbing check), with and without `--fuse-conv-bn`
    (`fold_comparison`): 18 K1 launches per sample, the same boxes."""
    from bevformer_torch.configs import get_config

    name = "bevformerv2-r50-t1-base"
    ckpt = os.path.join(root, "v2_damped.pth")
    damped_v2_checkpoint(name, ckpt)
    fold = fold_comparison(name, data, ckpt, root, v2_per_sample(get_config(name)), smi)
    return dict(v2_sample_ms=fold["unfolded_ms"], v2_fused_sample_ms=fold["folded_ms"],
                v2_fuse_score_err=fold["score_err"], v2_fuse_box_err=fold["box_err"])


# tools.train bevformerv2-r50-t1 on phase 12's root: CLI_TRAIN_STEPS steps,
# then resumed to the end of the train split's first epoch (the root's 8
# train frames at batch 1), where the in-training eval runs
V2_CLI_RESUME_STEPS = 8


def check_cli_v2_train(data, root, smi):
    """`tools.train bevformerv2-r50-t1` on the phase's root (V2 crops its
    900-row cameras, draws a rung of the ladder, the flip and
    GlobalRotScaleTrans per sample): CLI_TRAIN_STEPS steps with a
    checkpoint, then `--resume-from` it to V2_CLI_RESUME_STEPS with
    `--eval-interval-epochs 1` (the eval at the epoch's end, through
    `VideoEvaluatorV2`), the two runs in one process (`run_mains`; the
    resumed run restores everything from the checkpoint, as a new process
    does): finite losses, K1 and K3/K4 launches per step (and
    the eval's K1 per val sample), the restored step, lr and generators
    the saved ones, an NDS/mAP line. Returns
    the step, host and data-wait medians and the peak."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.tools.train import rng_digests

    from bevformer_torch.data.dataset import load_infos

    name = "bevformerv2-r50-t1"
    work = os.path.join(root, "work_v2")
    cfg = get_config(name)
    want = v2_train_per_step(cfg)
    # the in-training eval's K1 launches: every val sample's
    n_val = len(load_infos(os.path.join(data, "nuscenes_infos_temporal_val.pkl"))[0])
    per_eval = times(v2_per_sample(cfg), n_val)

    ckpt_path = os.path.join(work, "ckpts", f"iter_{CLI_TRAIN_STEPS}.pth")
    args = [name, "--data-root", data, "--work-dir", work, "--log-interval", "1",
            "--eval-interval-epochs", "1", "--max-iters"]
    runs, secs = run_mains([
        ("bevformer_torch.tools.train", [*args, str(CLI_TRAIN_STEPS)]),
        ("bevformer_torch.tools.train", [*args, str(V2_CLI_RESUME_STEPS), "--resume-from",
                                         ckpt_path])],
        f"tools.train {name} to step {CLI_TRAIN_STEPS}, then resumed to {V2_CLI_RESUME_STEPS}")

    def parsed(recs, steps, evals):
        what = f"tools.train {name} to step {steps}"
        logged = [r for r in recs if "step_ms" in r and "done" not in r]
        done = one(recs, "done", what)
        for r in logged:
            check(all(math.isfinite(v) for v in r.values() if isinstance(v, float)), f"{what}: {r}")
        expect = {k: v * done["steps"] + evals * per_eval[k] for k, v in want.items()}
        check(done["launches"] == expect, f"{what}: launches {done['launches']}, want {expect}")
        log(f"[cli] {what} (the process of both runs {secs:.1f} s), peak {done['peak_gib']} "
            f"GiB, launches {done['launches']}; steps: " + "; ".join(
                f"{r['step']}: loss {r['total']:.4f} step {r['step_ms']:.1f} ms host "
                f"{r['host_ms']:.1f} ms wait {r['data_wait_ms']:.1f} ms" for r in logged))
        return recs, logged, done

    _, first, first_done = parsed(runs[0], CLI_TRAIN_STEPS, 0)
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    saved = dict(step=ckpt["step"], lr=ckpt["scheduler"]["_last_lr"], rng=rng_digests(ckpt["rng"]))
    n_mono = sum(k.startswith("fcos3d_bbox_head.") for k in ckpt["state_dict"])
    del ckpt
    recs, second, second_done = parsed(runs[1], V2_CLI_RESUME_STEPS, 1)
    resumed = one(recs, "resumed_from", f"tools.train {name} --resume-from")
    restored = {k: resumed[k] for k in saved}
    check(restored == saved, f"{name}: restored {restored} != saved {saved}")
    check([r["step"] for r in first + second] == list(range(V2_CLI_RESUME_STEPS)),
          f"{name}: the two runs did not log steps 0-{V2_CLI_RESUME_STEPS - 1} once each")
    ev = one(recs, "NDS", f"tools.train {name} in-training eval")
    check(ev["step"] == V2_CLI_RESUME_STEPS and math.isfinite(ev["NDS"]), f"{name} eval {ev}")
    steady = first[1:] + second[1:]
    res = dict(v2_train_step_ms=median_of([r["step_ms"] for r in steady]),
               v2_train_host_ms=median_of([r["host_ms"] for r in steady]),
               v2_train_data_wait_ms=median_of([r["data_wait_ms"] for r in steady]),
               v2_train_peak_gib=max(first_done["peak_gib"] or 0, second_done["peak_gib"] or 0))
    log(f"[cli] {name}: checkpoint with {n_mono} fcos3d_bbox_head tensors; saved {saved}, "
        f"restored the same; in-training eval at step {ev['step']}: NDS {ev['NDS']!r} mAP "
        f"{ev['mAP']!r}; medians: step {res['v2_train_step_ms']:.1f} ms, host "
        f"{res['v2_train_host_ms']:.1f} ms, data wait {res['v2_train_data_wait_ms']:.1f} ms; "
        f"peak {res['v2_train_peak_gib']} GiB; card: {smi}")
    return res


# tools.train bevformerv2-r50-t8 on phase 12's root (8 frames of 6 images
# a sample): steps 1-2 time its data thread against its step
V2_T8_CLI_STEPS = 3
PHOTOMETRIC_REPEATS = 3  # timed calls of the distortion on each device


def photometric_times(smi):
    """One frame's photometric distortion (`pipeline.photometric_distortion`
    on 6 x 900 x 1600 uint8 images, the CLI root's cameras, taken back to
    the host as uint8 as `dataset_v2` does) on the host's cores and on the
    card: the median of PHOTOMETRIC_REPEATS timed calls after one warm-up
    each, and the largest difference of their outputs."""
    import numpy as np
    import torch
    from bevformer_torch.data.pipeline import photometric_distortion

    imgs = np.random.RandomState(0).randint(0, 256, (6, 900, 1600, 3), np.uint8)

    def run(device):
        rng = np.random.RandomState(0)
        t = time.perf_counter()
        out = photometric_distortion(torch.from_numpy(imgs).to(device).float(), rng)
        out = out.clamp_(0, 255).to(torch.uint8).cpu().numpy()
        return time.perf_counter() - t, out

    res, outs = {}, {}
    for device in ("cpu", "cuda"):
        run(device)
        secs = []
        for _ in range(PHOTOMETRIC_REPEATS):
            dt, outs[device] = run(device)
            secs.append(dt)
        res[device] = median_of(secs) * 1e3
    diff = int(np.abs(outs["cpu"].astype(np.int16) - outs["cuda"]).max())
    log(f"[cli] photometric distortion of one frame (6 x 900 x 1600, as uint8 back on the "
        f"host): host {res['cpu']:.1f} ms ({torch.get_num_threads()} threads), card "
        f"{res['cuda']:.1f} ms (median of {PHOTOMETRIC_REPEATS}); outputs differ by at most "
        f"{diff}; card: {smi}")
    return dict(photometric_host_ms=res["cpu"], photometric_card_ms=res["cuda"])


def check_cli_v2_train_t8(data, root, smi):
    """`tools.train bevformerv2-r50-t8` on the phase's root for
    V2_T8_CLI_STEPS steps: each sample's 8 frames of 6 JPEGs through the
    photometric distortion, PIL's resize and the flip in the data thread,
    against t8's step. Finite losses, 102 K1 and 18 K3/K4 launches per
    step; the medians of steps 1-2 of the step, host and data-wait times,
    and the peak."""
    from bevformer_torch.configs import get_config

    name = "bevformerv2-r50-t8"
    what = f"tools.train {name} to step {V2_T8_CLI_STEPS}"
    want = v2_train_per_step(get_config(name))
    recs, secs = run_cli(["bevformer_torch.tools.train", name, "--data-root", data, "--work-dir",
                          os.path.join(root, "work_v2_t8"), "--max-iters", str(V2_T8_CLI_STEPS),
                          "--log-interval", "1"], what)
    logged = [r for r in recs if "step_ms" in r and "done" not in r]
    done = one(recs, "done", what)
    for r in logged:
        check(all(math.isfinite(v) for v in r.values() if isinstance(v, float)), f"{what}: {r}")
    check([r["step"] for r in logged] == list(range(V2_T8_CLI_STEPS)), f"{what}: logged {logged}")
    expect = {k: v * done["steps"] for k, v in want.items()}
    check(done["launches"] == expect, f"{what}: launches {done['launches']}, want {expect}")
    steady = logged[1:]
    res = dict(v2_t8_train_step_ms=median_of([r["step_ms"] for r in steady]),
               v2_t8_train_host_ms=median_of([r["host_ms"] for r in steady]),
               v2_t8_train_data_wait_ms=median_of([r["data_wait_ms"] for r in steady]),
               v2_t8_train_peak_gib=done["peak_gib"])
    log(f"[cli] {what}: {secs:.1f} s, launches {done['launches']}; steps: " + "; ".join(
        f"{r['step']}: loss {r['total']:.4f} step {r['step_ms']:.1f} ms host {r['host_ms']:.1f} "
        f"ms wait {r['data_wait_ms']:.1f} ms" for r in logged)
        + f"; medians of steps 1-{V2_T8_CLI_STEPS - 1}: step {res['v2_t8_train_step_ms']:.1f} "
        f"ms, host {res['v2_t8_train_host_ms']:.1f} ms, data wait "
        f"{res['v2_t8_train_data_wait_ms']:.1f} ms; peak {done['peak_gib']} GiB; card: {smi}")
    return res


def check_cli(smi):
    """The port's CLIs as a user runs them, through their `main(argv)` in
    processes of their own (a few CLIs a process, `run_mains`: each
    process's start-up costs 10-25 s), at bevformer_base full size:
    create_data synth of CLI_SCENES x CLI_FRAMES (x 6 cameras at 1600 x
    900, JPEG: half the scenes train, half validate), tools.train for
    CLI_TRAIN_STEPS steps with a checkpoint, tools.train --resume-from it
    to CLI_RESUME_STEPS (mid-way through the train split's first epoch: the
    restored step, lr and random generators must be the saved ones, and
    the two runs log each step once), tools.test on the last checkpoint
    over the val frames; each must finish with finite numbers and launch
    every kernel of its path as often as the path does.
    Then the perfect detector, one frame's decodes timed (`decode_times`),
    and the other CLI checks on the same root. The root is removed
    afterwards."""
    import shutil
    import tempfile

    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.core.evaluation import ERR_NAME_MAPPING
    from bevformer_torch.tools.train import rng_digests

    t_start = time.perf_counter()
    root = tempfile.mkdtemp(prefix="bevformer_cli_")
    data, work = os.path.join(root, "data"), os.path.join(root, "work")
    try:
        ckpt_path = os.path.join(work, "ckpts", f"iter_{CLI_TRAIN_STEPS}.pth")
        out = os.path.join(work, "results.json")
        train_args = ["bevformer_base", "--data-root", data, "--work-dir", work,
                      "--log-interval", "1", "--max-iters"]
        (_, recs, second, test_recs), secs = run_mains([
            ("bevformer_torch.tools.create_data",
             ["synth", "--out-dir", data, "--scenes", str(CLI_SCENES), "--frames",
              str(CLI_FRAMES)]),
            ("bevformer_torch.tools.train", [*train_args, str(CLI_TRAIN_STEPS)]),
            ("bevformer_torch.tools.train",
             [*train_args, str(CLI_RESUME_STEPS), "--resume-from", ckpt_path]),
            ("bevformer_torch.tools.test",
             ["bevformer_base", "--data-root", data, "--checkpoint",
              os.path.join(work, "ckpts", f"iter_{CLI_RESUME_STEPS}.pth"), "--out", out])],
            "create_data, tools.train, tools.train --resume-from, tools.test")
        names = os.listdir(os.path.join(data, "samples"))
        check(len(names) == CLI_SCENES * CLI_FRAMES * 6 and all(n.endswith(".jpg") for n in names),
              f"create_data synth wrote {len(names)} files, not all .jpg")
        log(f"[cli] create_data synth: {len(names)} JPEG images; then tools.train, its "
            f"--resume-from and tools.test in the same process, {secs:.1f} s for the four")

        def train_run(recs, steps):
            what = f"tools.train to step {steps}"
            logged = [r for r in recs if "step_ms" in r and "done" not in r]
            done = one(recs, "done", what)
            for r in logged:
                check(all(math.isfinite(r[k]) for k in ("total", "loss_cls", "loss_bbox",
                                                        "grad_norm")), f"{what}: {r}")
            want = {k: v * done["steps"] for k, v in TRAIN_PER_STEP.items()}
            check(done["launches"] == want, f"{what}: launches {done['launches']}, want {want}")
            log(f"[cli] {what}: peak {done['peak_gib']} GiB, launches {done['launches']}; "
                f"steps: " + "; ".join(
                    f"{r['step']}: loss {r['total']:.4f} step {r['step_ms']:.1f} ms host "
                    f"{r['host_ms']:.1f} ms wait {r['data_wait_ms']:.1f} ms" for r in logged))
            return logged, done

        first_steps, first_done = train_run(recs, CLI_TRAIN_STEPS)
        second_steps, second_done = train_run(second, CLI_RESUME_STEPS)
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        saved = dict(step=ckpt["step"], lr=ckpt["scheduler"]["_last_lr"],
                     rng=rng_digests(ckpt["rng"]))
        check(sorted(ckpt) == ["meta", "optimizer", "rng", "scheduler", "state_dict", "step"],
              f"checkpoint keys {sorted(ckpt)}")
        del ckpt
        resumed = one(second, "resumed_from", "tools.train --resume-from")
        restored = {k: resumed[k] for k in saved}
        log(f"[cli] saved {saved}; restored {restored}")
        check(restored == saved, f"restored {restored} != saved {saved}")
        check(saved["step"] == CLI_TRAIN_STEPS, f"saved step {saved['step']}")
        check("torch_cuda" in saved["rng"], f"saved rng {saved['rng']}")
        check([r["step"] for r in first_steps + second_steps] == list(range(CLI_RESUME_STEPS)),
              f"the two runs did not log steps 0-{CLI_RESUME_STEPS - 1} once each")

        cfg = get_config("bevformer_base")
        timing = one(test_recs, "frame_ms", "tools.test")
        summary = one(test_recs, "NDS", "tools.test")
        frames = timing["frames"]
        per_frame = dict(TRAIN_PER_STEP, msda_fwd=K1_PER_FRAME, dcn_conv_fwd=K2_PER_FRAME,
                         msda_bwd=0, dcn_im2col=0, dcn_col2im=0, conv_fwd=CONV_PER_FRAME)
        want = {k: v * frames for k, v in per_frame.items()}
        check(timing["launches"] == want, f"tools.test launches {timing['launches']}, want {want}")
        keys = ["NDS", "mAP", *ERR_NAME_MAPPING.values()]
        check(sorted(summary) == sorted(keys), f"tools.test summary keys {sorted(summary)}")
        check(all(math.isfinite(summary[k]) for k in keys), f"tools.test summary {summary}")
        with open(os.path.join(work, "metrics_summary.json")) as f:
            metrics = json.load(f)
        check(sorted(metrics) == ["label_aps", "label_tp_errors", "mean_ap", "nd_score",
                                  "tp_errors"], f"metrics_summary.json keys {sorted(metrics)}")
        check(os.path.exists(os.path.splitext(out)[0] + "_nusc.json"), "no submission json")
        log(f"[cli] tools.test over {frames} val frames: frame ms "
            f"{[round(x, 1) for x in timing['frame_ms']]} (load "
            f"{[round(x, 1) for x in timing['load_ms']]}), peak {timing['peak_gib']} GiB, "
            f"launches {timing['launches']}; SCA queries dropped "
            f"{timing['max_capacity_clipped']} (most visible {timing['max_visible']} of capacity "
            f"{timing['sca_capacity']}); {json.dumps(summary)}")
        check(timing["max_capacity_clipped"] == 0,
              f"tools.test dropped {timing['max_capacity_clipped']} visible SCA queries")

        perfect_detector(data, cfg, "cuda")
        decode = decode_times(data, smi)
        fp16 = check_cli_fp16_and_fuse(data, root, smi)
        fp16.update(check_cli_base_bf16(data, root, smi))
        v2 = check_cli_v2(data, root, smi)
        v2.update(check_cli_v2_train(data, root, smi))
        v2.update(check_cli_v2_train_t8(data, root, smi))
        v2.update(photometric_times(smi))
        v2.update(check_dp_cli(data, root, ckpt_path, first_steps, smi))

        # each run's first step carries its warm-up
        steady = first_steps[1:] + second_steps[1:]
        res = dict(
            step_ms=median_of([r["step_ms"] for r in steady]),
            host_ms=median_of([r["host_ms"] for r in steady]),
            data_wait_ms=median_of([r["data_wait_ms"] for r in steady]),
            frame_ms=timing["frame_ms_median"], load_ms=timing["load_ms_median"],
            train_peak_gib=max(first_done["peak_gib"] or 0, second_done["peak_gib"] or 0),
            test_peak_gib=timing["peak_gib"], NDS=summary["NDS"], mAP=summary["mAP"],
        )
        res.update(fp16, **v2, **decode)
        res["seconds"] = time.perf_counter() - t_start
        log(f"[cli] medians: tools.train step {res['step_ms']:.1f} ms (steps "
            f"{[r['step'] for r in steady]}), host {res['host_ms']:.1f} ms, data wait "
            f"{res['data_wait_ms']:.1f} ms; tools.test frame {res['frame_ms']:.1f} ms (load "
            f"{res['load_ms']:.1f} ms); peak train {res['train_peak_gib']} / test "
            f"{res['test_peak_gib']} GiB; seeded weights after {CLI_RESUME_STEPS} steps: NDS "
            f"{res['NDS']!r} mAP {res['mAP']!r}; phase wall time {res['seconds']:.1f} s; card: {smi}")
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------ phase 17: data parallel, remat

DP_CLI_STEPS = CLI_TRAIN_STEPS  # tools.train over one NCCL rank, against phase 12's first run
DP_STEPS = (("bevformer_base", 2), ("bevformerv2-r50-t1", 1))  # dp_step over 2 gloo ranks
# the DP_STEPS configs whose dp_step runs as a further job (`--then`) of
# phase 18's launch of the same config: one torchrun start-up for both
DP_IN_SP = ("bevformer_base",)
DP_GT_COUNTS = (12, 5)  # the two samples' ground-truth counts (unequal)
# ||update(2 ranks) - update(1 process)|| / ||update(1 process)|| of a group.
# Adam's first steps move each element by about lr x sign(g): the error is
# 2 sqrt(share of elements whose gradient sign differs), here those within
# rounding of 0 (behind a train-mode BatchNorm's ReLUs, ~1e-2 of a
# gradient: tests/test_torch_v2_train.py). Ranks stepping their own
# gradients without the all-reduce disagree on a third or more (error ~1).
DP_UPDATE_TOL = 0.1
DP_STATS_TOL = 1e-3  # BatchNorm running statistics, max abs err over max |one process|
DP_BOX_TOL = 1e-5  # tools.test on 2 ranks vs 1: scores, and boxes over max |box|
REMAT_STEPS = 2
REMAT_PRESETS = ("bevformer_base", "bevformerv2-r50-t8")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def torchrun(nproc: int):
    """`torch.distributed.run` arguments for `run_cli`: nproc ranks on this
    host, a free port."""
    return ["torch.distributed.run", "--nproc-per-node", str(nproc), "--master-addr",
            "localhost", "--master-port", str(free_port())]


def check_dp_cli(data, root, ckpt, first_steps, smi):
    """Phase 17 (a) and (b)'s tools.test, on phase 12's root: `tools.train
    bevformer_base` under torchrun with one rank over NCCL (DDP, the
    process group, the rank-mean normalisers) for DP_CLI_STEPS steps
    against phase 12's one-process run of the same steps: the first step's
    losses and grad norm within TRAIN_TOL (K3/K4 and K6 add with atomics:
    not bitwise), the later ones reported (`step_errors`); then
    `tools.test` on two gloo ranks of the one card against this process on
    the root's val split (2 scenes of CLI_FRAMES: the split falls on a
    scene start), from phase 12's checkpoint `ckpt`: the same boxes within
    DP_BOX_TOL."""
    import json as _json

    import numpy as np
    from bevformer_torch.tools import test as test_cli

    t0 = time.perf_counter()
    what = "torchrun --nproc-per-node 1 tools.train (NCCL)"
    recs, secs = run_cli([*torchrun(1), "-m", "bevformer_torch.tools.train", "bevformer_base",
                          "--data-root", data, "--work-dir", os.path.join(root, "dp_work"),
                          "--max-iters", str(DP_CLI_STEPS), "--log-interval", "1"], what)
    steps = [r for r in recs if "step_ms" in r and "done" not in r]
    done = one(recs, "done", what)
    check(done["dp"] == 1 and len(steps) == DP_CLI_STEPS, f"{what}: {done}")
    want = {k: v * DP_CLI_STEPS for k, v in TRAIN_PER_STEP.items()}
    check(done["launches"] == want, f"{what}: launches {done['launches']}, want {want}")
    errs = step_errors(steps, first_steps)
    check(errs[0] <= TRAIN_TOL, f"{what} step 0: {steps[0]} vs one process {first_steps[0]}")
    res = dict(nccl_step_ms=median_of([r["step_ms"] for r in steps[1:]]),
               nccl_peak_gib=done["peak_gib"], nccl_loss_err=errs[0], nccl_later_err=errs[1:])
    log(f"[dp] {what}: {secs:.1f} s; totals {[round(r['total'], 4) for r in steps]} vs phase 12's "
        f"one process {[round(r['total'], 4) for r in first_steps]}; grad norms "
        f"{[round(r['grad_norm'], 2) for r in steps]} / {[round(r['grad_norm'], 2) for r in first_steps]}"
        f"; relative errors by step (every loss term, the first step's grad norm) "
        f"{[float(f'{e:.3e}') for e in errs]} (held: the first); step median "
        f"{res['nccl_step_ms']:.1f} ms (phase 12's "
        f"{median_of([r['step_ms'] for r in first_steps[1:]]):.1f}), peak {done['peak_gib']:.2f} GiB, "
        f"launches {done['launches']}; card: {smi}")

    outs = {}
    for n in (2, 1):
        out = os.path.join(root, f"dp_test{n}", "r.json")
        os.makedirs(os.path.dirname(out))
        args = ["bevformer_base", "--data-root", data, "--checkpoint", ckpt, "--out", out]
        t1 = time.perf_counter()
        if n == 2:
            recs, _ = run_cli([*torchrun(2), "-m", "bevformer_torch.tools.test", *args, "--device",
                               "cuda:0", "--dist-backend", "gloo"], "tools.test on 2 ranks")
            frame_ms = one(recs, "frame_ms", "tools.test on 2 ranks")["frame_ms"]
        else:  # one process: this one
            frame_ms = test_cli.main(args)["timing"]["frame_ms"]
        with open(out) as f:
            outs[n] = [{k: np.asarray(v) for k, v in r.items()} for r in _json.load(f)]
        res[f"test{n}_s"] = time.perf_counter() - t1
        res[f"test{n}_frame_ms"] = frame_ms
    n_val = CLI_SCENES // 2 * CLI_FRAMES
    check([r["token"] for r in outs[2]] == [r["token"] for r in outs[1]]
          and len(outs[1]) == n_val, "tools.test on 2 ranks: other frames than on 1")
    errs = []
    for a, b in zip(outs[2], outs[1]):
        score_err, box_err, missing = box_set_errors(a, b)
        check(missing == 0 and score_err <= DP_BOX_TOL and box_err <= DP_BOX_TOL,
              f"tools.test 2 ranks vs 1, {b['token']}: scores {score_err}, boxes {box_err}, "
              f"{missing} unmatched")
        errs.append((score_err, box_err))
    res["test_box_err"] = max(max(e) for e in errs)
    res["dp_cli_seconds"] = time.perf_counter() - t0
    log(f"[dp] tools.test bevformer_base over {n_val} val frames (2 scenes) on 2 gloo ranks of "
        f"the one card ({res['test2_s']:.1f} s; rank 0's frame ms "
        f"{[round(x, 1) for x in res['test2_frame_ms']]}) vs this process ({res['test1_s']:.1f} s): "
        f"max score / box error {res['test_box_err']:.3e}; card: {smi}")
    return res


def with_gt_count(batch, n: int):
    """A one-sample v1 `Batch` or V2 `BatchV2` with its first n boxes."""
    import torch

    boxes, labels = batch.gt_boxes.clone(), batch.gt_labels.clone()
    boxes[:, n:] = 0
    labels[:, n:] = 0
    return batch._replace(gt_boxes=boxes, gt_labels=labels, num_gt=torch.full_like(batch.num_gt, n))


def two_sample_batch(cfg):
    """Two seeded samples (unequal ground-truth counts) as one batch, on
    the CPU."""
    import torch
    from bevformer_torch.data import train_batch
    from bevformer_torch.data.synth import train_batch_v2
    from bevformer_torch.runtime import Batch, BatchV2

    if cfg.version == "v2":
        a, b = (with_gt_count(train_batch_v2(cfg, seed=s, device="cpu"), n)
                for s, n in zip((0, 1), DP_GT_COUNTS))
        return BatchV2(*[torch.cat(t) for t in zip(a[:9], b[:9])],
                       mono_targets={k: torch.cat([a.mono_targets[k], b.mono_targets[k]])
                                     for k in a.mono_targets})
    a, b = (with_gt_count(train_batch(cfg, seed=s, device="cpu"), n)
            for s, n in zip((0, 1), DP_GT_COUNTS))
    return Batch(*[torch.cat(t) for t in zip(a, b)])


def step_errors(outs, ref):
    """Per step, the largest relative error of the loss terms, and at the
    first step (the same weights on both sides) of the grad norm: a later
    step starts from weights that Adam's sign steps moved apart wherever
    rounding put a gradient element on the other side of 0, which random
    weights amplify."""
    return [max(abs(o[k] - r[k]) / max(abs(r[k]), 1e-6)
                for k in ("total", "loss_cls", "loss_bbox") + (("grad_norm",) if i == 0 else ()))
            for i, (o, r) in enumerate(zip(outs, ref))]


def one_process_steps(cfg, sd, batch, steps, device):
    """`steps` steps of `batch` in one process (dropout off): the outputs,
    step ms, peak GiB, and the state before and after, on the CPU."""
    import torch
    from bevformer_torch.runtime import Trainer, build_model

    torch.cuda.synchronize(device)  # (the allocator's peak resets only once it is set up)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg, sd, device)
    trainer = Trainer(model, total_steps=TRAIN_TOTAL_STEPS, seed=0)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    on_card = type(batch)(*[{k: v.to(device) for k, v in t.items()} if isinstance(t, dict)
                            else t.to(device) for t in batch])
    outs, ms, states = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(trainer.step(on_card))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        states.append({k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()})
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    del trainer, model, on_card
    torch.cuda.empty_cache()
    return dict(outs=outs, ms=ms, peak_gib=peak, before=before, states=states)


def update_errors(state, ref, names):
    """Per parameter group, ||update - ref's update|| / ||ref's update||,
    of the first step."""
    sums = {}
    for k in names:
        d = state[k].double() - ref["before"][k].double()
        d_ref = ref["states"][0][k].double() - ref["before"][k].double()
        acc = sums.setdefault(group_of(k), [0.0, 0.0])
        acc[0] += float(((d - d_ref) ** 2).sum())
        acc[1] += float((d_ref ** 2).sum())
    return {g: math.sqrt(a / max(b, 1e-30)) for g, (a, b) in sums.items()}


def swap_samples(batch):
    """`batch` of two samples in the other order (a `BatchV2`'s DD3D
    targets too, one row per camera image): the same step, with every sum
    over the batch in another order."""
    if not hasattr(batch, "mono_targets"):
        return type(batch)(*[t.flip(0) for t in batch])
    cams = batch.images.shape[2]

    def swap(t):
        return t.view(2, cams, *t.shape[1:]).flip(0).reshape(t.shape)

    return type(batch)(*[t.flip(0) for t in batch[:9]],
                       mono_targets={k: swap(v) for k, v in batch.mono_targets.items()})


def dp_job(name, steps, tmp):
    """Phase 17 (b)'s `tools.dp_step` job for `name`, its spec written into
    `tmp`: full size, GridMask off, seeded weights, `two_sample_batch`."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.runtime import init_state_dict

    t0 = time.perf_counter()
    cfg = get_config(name).replace(use_grid_mask=False)
    sd = init_state_dict(cfg, seed=0)
    batch = two_sample_batch(cfg)
    spec, out = os.path.join(tmp, f"dp_{name}.pt"), os.path.join(tmp, f"dp_{name}_out.pt")
    torch.save(dict(cfg=cfg, state_dict=sd, batch=batch, steps=steps,
                    total_steps=TRAIN_TOTAL_STEPS), spec)
    return dict(name=name, steps=steps, cfg=cfg, sd=sd, batch=batch, spec=spec, out=out,
                made_s=time.perf_counter() - t0)


def check_dp_step(name, steps, device, smi, launched=None):
    """Phase 17 (b): `name` at full size, `steps` steps of two samples
    (GridMask and dropout off) over two gloo ranks of the one card
    (`tools.dp_step` under torchrun: DDP, the synced BatchNorms, the
    rank-mean normalisers), held against one process stepping both samples
    as one batch, by phase 9's rule against a witness, one process stepping
    them in the other order (every sum over the batch in another order, as
    the ranks' split orders them). The first step, from the same weights: its losses and
    grad norm within TRAIN_TOL or WITNESS_FACTOR x the witness's error,
    each group's parameter update within DP_UPDATE_TOL or that factor, V2's
    running statistics within DP_STATS_TOL. A later step starts from
    weights that the first step's Adam sign steps moved apart wherever
    rounding put a gradient element on the other side of 0, which random
    weights amplify: it runs (DDP's second iteration) and is reported.
    `launched`: (the `dp_job`, its output, the launch's seconds) of a job
    another launch ran (`DP_IN_SP`); else this launches it."""
    import shutil
    import tempfile

    import torch

    if launched is None:
        tmp = tempfile.mkdtemp(prefix="bevformer_dp_")
        try:
            job = dp_job(name, steps, tmp)
            _, secs = run_cli([*torchrun(2), "-m", "bevformer_torch.tools.dp_step", job["spec"],
                               job["out"], "--device", str(device), "--dist-backend", "gloo"],
                              f"dp_step {name} on 2 gloo ranks")
            out = torch.load(job["out"], map_location="cpu", weights_only=False)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    else:
        job, out, secs = launched
    cfg, sd, batch, made_s = job["cfg"], job["sd"], job["batch"], job["made_s"]
    ref = one_process_steps(cfg, sd, batch, steps, device)
    witness = one_process_steps(cfg, sd, swap_samples(batch), 1, device)

    loss_err, loss_noise = step_errors(out["outs"], ref["outs"]), step_errors(
        witness["outs"], ref["outs"])
    check(loss_err[0] <= max(TRAIN_TOL, WITNESS_FACTOR * loss_noise[0]),
          f"dp {name} step 0: losses {out['outs'][0]} vs one process {ref['outs'][0]} "
          f"(witness {loss_noise[0]})")
    check(all(math.isfinite(v) for o in out["outs"] for v in o.values()),
          f"dp {name}: {out['outs']}")
    names = set(out["grads"])
    upd, upd_noise = (update_errors(out["states"][0], ref, names),
                      update_errors(witness["states"][0], ref, names))
    for g, e in upd.items():
        check(e <= max(DP_UPDATE_TOL, WITNESS_FACTOR * upd_noise[g]),
              f"dp {name}: {g} update error {e} (witness {upd_noise[g]})")
    first = ref["states"][0]
    stats = [k for k in first if k.endswith(("running_mean", "running_var"))]
    stats_err = max([float((out["states"][0][k] - first[k]).abs().max()
                           / max(float(first[k].abs().max()), 1e-6)) for k in stats] or [0.0])
    check(stats_err <= DP_STATS_TOL, f"dp {name}: running statistics error {stats_err}")
    res = dict(name=name, steps=steps, dp_step_ms=out["step_ms"], dp_peak_gib=out["peak_gib"],
               one_step_ms=ref["ms"] + witness["ms"], one_peak_gib=ref["peak_gib"],
               loss_err=loss_err[0], loss_witness=loss_noise[0], later_loss_err=loss_err[1:],
               update_err=upd,
               update_witness=upd_noise, stats_err=stats_err, seconds=secs)

    def short(d):
        return {g: float(f"{e:.3e}") for g, e in d.items()}

    log(f"[dp] {name}: {steps} step(s) of 2 samples ({DP_GT_COUNTS} GT boxes) on 2 gloo ranks "
        f"of the one card vs 1 process (the witness: 1 process, the samples swapped): totals "
        f"{[round(o['total'], 4) for o in out['outs']]} vs "
        f"{[round(r['total'], 4) for r in ref['outs']]} "
        f"({[round(r['total'], 4) for r in witness['outs']]}), grad norms "
        f"{[round(o['grad_norm'], 3) for o in out['outs']]} vs "
        f"{[round(r['grad_norm'], 3) for r in ref['outs']]} "
        f"({[round(r['grad_norm'], 3) for r in witness['outs']]}); relative errors by step "
        f"{[float(f'{e:.3e}') for e in loss_err]} (witness "
        f"{[float(f'{e:.3e}') for e in loss_noise]}; held: the first); the first step's "
        f"parameter updates' relative L2 error by group {short(upd)} (witness "
        f"{short(upd_noise)}); its running statistics "
        f"{len(stats)} tensors, max error {stats_err:.3e}; rank 0's step ms "
        f"{[round(x, 1) for x in out['step_ms']]} and peak {out['peak_gib']:.2f} GiB (gloo "
        f"through the host: plumbing, not a speed), one process's "
        f"{[round(x, 1) for x in res['one_step_ms']]} ms and peak {ref['peak_gib']:.2f} GiB; "
        f"the launch {secs:.1f} s, spec {made_s:.1f} s; card: {smi}")
    return res


def remat_step_counts(cfg) -> dict:
    """Extra launches a training step makes with `use_remat`: K1 in every
    recomputed encoder layer of the trained frame (TSA and SCA), K2 in every
    recomputed DCN block (all but each DCN stage's first)."""
    from bevformer_torch.models.resnet import ARCH_SETTINGS

    blocks = ARCH_SETTINGS[cfg.backbone_depth]
    dcn = sum(blocks[s] - 1 for s in cfg.backbone_dcn_stages)
    k2 = "dcn_conv_fwd_bf16" if cfg.dtype == "bfloat16" else "dcn_conv_fwd"
    return {"msda_fwd": 2 * cfg.encoder_layers, k2: dcn}


def check_remat(name, device, smi):
    """Phase 17 (c): `name` at full size with seeded weights, REMAT_STEPS
    train-mode steps (dropout and GridMask on, the same seed) with
    `use_remat` off, then on: the first step's losses and grad norm equal
    within TRAIN_TOL (the later ones reported), the launches a step (with
    remat also the recomputed encoder layers' K1 and DCN blocks' K2), the
    step times and the peak memory."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.data import train_batch
    from bevformer_torch.data.synth import train_batch_v2
    from bevformer_torch.kernels import launch_counts
    from bevformer_torch.runtime import Trainer, build_model, init_state_dict

    base = get_config(name)
    sd = init_state_dict(base, seed=0)
    per_step = v2_train_per_step(base) if base.version == "v2" else TRAIN_PER_STEP
    runs = {}
    for remat in (False, True):
        cfg = base.replace(use_remat=remat)
        model = build_model(cfg, sd, device)
        trainer = Trainer(model, total_steps=TRAIN_TOTAL_STEPS, seed=0)
        batch = (train_batch_v2(cfg, seed=0, device=device) if cfg.version == "v2"
                 else train_batch(cfg, seed=0, device=device))
        want = dict(per_step)
        if remat:
            for k, v in remat_step_counts(cfg).items():
                want[k] += v
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        outs, secs = [], []
        for step in range(REMAT_STEPS):
            start = launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs.append(trainer.step(batch))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            got = {k: v - start[k] for k, v in launch_counts().items()}
            check(got == want, f"remat {name} use_remat={remat} step {step}: launches {got}, "
                  f"want {want}")
            check(all(math.isfinite(v) for v in outs[-1].values()), f"remat {name}: {outs[-1]}")
        runs[remat] = dict(outs=outs, ms=[x * 1e3 for x in secs],
                           peak_gib=torch.cuda.max_memory_allocated(device) / 2**30, launches=want)
        del trainer, model, batch
        torch.cuda.empty_cache()
    off, on = runs[False], runs[True]
    # the first step, from the same weights (`step_errors`: a later one
    # starts from weights the atomic sums' rounding moved apart)
    errs = step_errors(on["outs"], off["outs"])
    loss_err = errs[0]
    check(loss_err <= TRAIN_TOL, f"remat {name}: {on['outs']} vs {off['outs']}")
    k2 = "dcn_conv_fwd_bf16" if base.dtype == "bfloat16" else "dcn_conv_fwd"
    res = dict(name=name, peak_gib=off["peak_gib"], remat_peak_gib=on["peak_gib"],
               step_ms=off["ms"][-1], remat_step_ms=on["ms"][-1], loss_err=loss_err,
               launches={r: {k: runs[r]["launches"][k] for k in ("msda_fwd", k2)} for r in runs})
    log(f"[remat] {name}: use_remat off / on: peak {off['peak_gib']:.2f} / {on['peak_gib']:.2f} "
        f"GiB, step ms {[round(x, 1) for x in off['ms']]} / {[round(x, 1) for x in on['ms']]} "
        f"({on['ms'][-1] / off['ms'][-1] - 1:+.1%} at the last step), K1 "
        f"{off['launches']['msda_fwd']} / {on['launches']['msda_fwd']} and K2 {off['launches'][k2]}"
        f" / {on['launches'][k2]} launches a step, losses {[round(o['total'], 4) for o in off['outs']]}"
        f" / {[round(o['total'], 4) for o in on['outs']]} (relative errors by step "
        f"{[float(f'{e:.3e}') for e in errs]}, the first step's grad norm included; held: the "
        f"first); card: {smi}")
    return res


# ------------------------------------------------ phase 18: the sp axis

# tools.dp_step on dp x sp gloo ranks of the one card, dp samples: (name,
# dp, sp, config overrides); each against one process stepping the same
# samples. Four full-size t1 ranks want more than the card's 80 GB (one
# ran out at 16.5 GiB allocated a rank): t1 steps with use_remat
# at 2 encoder layers: the split's path at a cut depth (each layer splits
# and gathers alike), for the script's time
SP_STEPS = (("bevformer_base", 1, 2, {"encoder_layers": 2}),
            ("bevformerv2-r50-t1", 2, 2, {"use_remat": True, "encoder_layers": 2}))
SP_ENCODER_TOL = SLICE_TOL  # a base frame's BEV at sp 2 vs 1: max abs error over max |BEV|


def sca_cap(cfg) -> int:
    """SCA's routed rows a camera (`attention.sca_capacity_routing`)."""
    q = cfg.bev_h * cfg.bev_w
    return min((int(q * cfg.sca_capacity_ratio) + 127) // 128 * 128, q)


def split_calls(rec, key, cfg, rows):
    """One rank's launches of msda counter `key` by call site, from its
    (B, Q) record: TSA (B = 2, the queue of 2), SCA (B = the cameras) and
    the decoder (B = 1), each {Q: launches}. Fails unless every TSA launch
    covers the rank's `rows` queries and every SCA launch at most the
    capacity's rows."""
    sites = {2: "tsa", cfg.data.num_cams: "sca", 1: "decoder"}
    calls = {site: {} for site in sites.values()}
    for b, q, n in rec["queries"][key]:
        check(b in sites, f"{key}: a launch at B = {b}")
        calls[sites[b]][q] = calls[sites[b]].get(q, 0) + n
    check(set(calls["tsa"]) <= {rows}, f"{key}: TSA launches at {calls['tsa']}, want Q = {rows}")
    check(all(q <= sca_cap(cfg) for q in calls["sca"]),
          f"{key}: SCA launches at {calls['sca']} above the capacity {sca_cap(cfg)}")
    return calls


def base_frame(cfg):
    """A v1 frame to encode, on the CPU: the last frame of a seeded
    `train_batch` without a previous BEV (so that each layer's TSA samples
    the BEV the last gather made)."""
    import torch
    from bevformer_torch.data import train_batch

    b = train_batch(cfg, seed=0, device="cpu")
    q = cfg.bev_h * cfg.bev_w
    return (b.images[:, -1], b.can_bus[:, -1], b.lidar2img[:, -1],
            torch.zeros((1, q, cfg.embed_dims)), torch.zeros((1,), dtype=torch.bool))


def check_sp_encoder(out, cfg, sd, frame, bounds, device, smi):
    """Phase 18 (c), from (a)'s launch: the ranks' BEV of a base frame
    (backbone, FPN and the 6 encoder layers, eval mode, the queries split)
    against this process's within SP_ENCODER_TOL, and per rank the K1
    launches by call site and queries, the peak and the frame's time.
    Returns each rank's SCA rows (its packed routed rows)."""
    import torch
    from bevformer_torch.runtime import build_model
    from bevformer_torch.tools.dp_step import encode

    torch.cuda.empty_cache()
    model = build_model(cfg, sd, device)
    one = encode(model, frame, device)
    del model
    torch.cuda.empty_cache()
    err = float((out["bev"] - one["bev"]).abs().max()) / float(one["bev"].abs().max())
    check(err <= SP_ENCODER_TOL, f"the base encoder at sp 2: BEV error {err} > {SP_ENCODER_TOL}")
    q = cfg.bev_h * cfg.bev_w
    one_calls = split_calls(one, "msda_fwd", cfg, q)
    sca_rows, peaks = [], []
    for r, rank in enumerate(out["ranks"]):
        rec, (lo, hi) = rank["encode"], bounds[r]
        check(rec["launches"]["msda_fwd"] == 2 * cfg.encoder_layers,
              f"the base encoder rank {r}: {rec['launches']}")
        calls = split_calls(rec, "msda_fwd", cfg, hi - lo)
        sca_rows.append(max(calls["sca"]))
        peaks.append(rec["peak_gib"])
        log(f"[sp] base encoder rank {r} (queries [{lo}, {hi}) of {q}): K1 by call site "
            f"{{Q: launches}} {calls} (one process {one_calls}); peak {rec['peak_gib']:.2f} GiB "
            f"(one process {one['peak_gib']:.2f}); frame {rec['ms']:.2f} ms (one process "
            f"{one['ms']:.2f}; the ranks share the card and gloo goes through the host: no "
            f"speed); card: {smi}")
    log(f"[sp] base encoder at sp {len(bounds)} vs 1: BEV max abs error / max |BEV| {err:.3e} "
        f"(tol {SP_ENCODER_TOL:.0e}); card: {smi}")
    return dict(err=err, sca_rows=sca_rows, peaks=peaks, one_peak_gib=one["peak_gib"],
                one_ms=one["ms"])


def check_sp_step(name, dp, sp, overrides, device, smi):
    """Phase 18 (a), (b): `name` at full size (with `overrides`), one step
    of `dp` samples (GridMask and dropout off) through `tools.dp_step` at
    --dp dp --sp sp on dp x sp gloo ranks of the one card, against one
    process stepping the same samples, by phase 17's rules (two samples:
    the witness is one process with the samples swapped; one sample: the
    loss within TRAIN_TOL and each group's update within DP_UPDATE_TOL).
    Per rank: K1 and K3/K4 launches by call site and queries (every TSA
    launch at the rank's range, SCA at its packed rows), the launches a
    step, the peak against the one process's, the step time (gloo through
    the host: no speed). A v1 config's launch first encodes a frame
    (`check_sp_encoder`). A config of DP_IN_SP runs its phase 17 (b)
    `dp_job` as a further job of the launch (`--then`), checked by
    `check_dp_step` into the result's "dp_step"."""
    import shutil
    import tempfile

    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.runtime import init_state_dict, parallel
    from bevformer_torch.tools.dp_step import rank_share

    cfg = get_config(name).replace(use_grid_mask=False, **overrides)
    per_step = dict(v2_train_per_step(cfg) if cfg.version == "v2" else path_launches(cfg)[1])
    if cfg.use_remat:
        for k, v in remat_step_counts(cfg).items():
            per_step[k] += v
    frame = None if cfg.version == "v2" else base_frame(cfg)
    tmp = tempfile.mkdtemp(prefix="bevformer_sp_")
    then, dp_launched = [], None
    try:
        if name in DP_IN_SP:
            job = dp_job(name, dict(DP_STEPS)[name], tmp)
            then = ["--then", job["spec"], job["out"], "2", str(dp * sp // 2)]
        sd = init_state_dict(cfg, seed=0)
        batch = two_sample_batch(cfg)
        if dp == 1:
            batch = rank_share(batch, 0, 2)
        spec, out_path = os.path.join(tmp, "spec.pt"), os.path.join(tmp, "out.pt")
        torch.save(dict(cfg=cfg, state_dict=sd, batch=batch, steps=1,
                        total_steps=TRAIN_TOTAL_STEPS,
                        **({} if frame is None else {"frame": frame})), spec)
        what = f"dp_step {name} {overrides or ''} at --dp {dp} --sp {sp} on {dp * sp} gloo ranks"
        _, secs = run_cli([*torchrun(dp * sp), "-m", "bevformer_torch.tools.dp_step", spec,
                           out_path, "--dp", str(dp), "--sp", str(sp), *then, "--device",
                           str(device), "--dist-backend", "gloo"], what)
        out = torch.load(out_path, map_location="cpu", weights_only=False)
        if then:
            dp_launched = (job, torch.load(job["out"], map_location="cpu", weights_only=False),
                           secs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(out["mesh"] == (dp, sp) and len(out["ranks"]) == dp * sp, f"{what}: {out['mesh']}")
    q = cfg.bev_h * cfg.bev_w
    bounds = parallel.query_bounds(q, sp)
    res = dict(name=name, dp=dp, sp=sp, overrides=overrides, seconds=secs,
               launches=out["ranks"][0]["launches"])
    if frame is not None:
        res["encoder"] = check_sp_encoder(out, cfg, sd, frame, bounds, device, smi)
    ref = one_process_steps(cfg, sd, batch, 1, device)
    loss_err = step_errors(out["outs"], ref["outs"])[0]
    names = set(out["grads"])
    upd = update_errors(out["states"][0], ref, names)
    loss_noise, upd_noise = 0.0, dict.fromkeys(upd, 0.0)
    if dp == 2:
        witness = one_process_steps(cfg, sd, swap_samples(batch), 1, device)
        loss_noise = step_errors(witness["outs"], ref["outs"])[0]
        upd_noise = update_errors(witness["states"][0], ref, names)
    check(loss_err <= max(TRAIN_TOL, WITNESS_FACTOR * loss_noise),
          f"{what}: losses {out['outs'][0]} vs one process {ref['outs'][0]} "
          f"(witness {loss_noise})")
    check(all(math.isfinite(v) for v in out["outs"][0].values()), f"{what}: {out['outs']}")
    for g, e in upd.items():
        check(e <= max(DP_UPDATE_TOL, WITNESS_FACTOR * upd_noise[g]),
              f"{what}: {g} update error {e} (witness {upd_noise[g]})")
    first = ref["states"][0]
    stats = [k for k in first if k.endswith(("running_mean", "running_var"))]
    stats_err = max([float((out["states"][0][k] - first[k]).abs().max()
                           / max(float(first[k].abs().max()), 1e-6)) for k in stats] or [0.0])
    check(stats_err <= DP_STATS_TOL, f"{what}: running statistics error {stats_err}")

    ranks = []
    for r, rec in enumerate(out["ranks"]):
        lo, hi = bounds[r % sp]
        check(rec["launches"] == per_step,
              f"{what} rank {r}: launches {rec['launches']}, want {per_step}")
        fwd = split_calls(rec, "msda_fwd", cfg, hi - lo)
        bwd = split_calls(rec, "msda_bwd", cfg, hi - lo)
        ranks.append(dict(rank=r, queries=(lo, hi), k1=fwd, k34=bwd, peak_gib=rec["peak_gib"],
                          step_ms=rec["step_ms"]))
        log(f"[sp] {name}{overrides or ''} (dp {dp}, sp {sp}) rank {r} (d {r // sp}, s {r % sp}; "
            f"queries [{lo}, {hi}) of {q}): K1 {rec['launches']['msda_fwd']} launches a step, by "
            f"call site {{Q: launches}} {fwd}; K3/K4 {rec['launches']['msda_bwd']}, {bwd}; "
            f"peak {rec['peak_gib']:.2f} GiB (one process {ref['peak_gib']:.2f} GiB with "
            f"{dp} sample(s)); step {rec['step_ms'][0]:.1f} ms (gloo through the host: "
            f"plumbing, not a speed); card: {smi}")
    res.update(loss_err=loss_err, loss_witness=loss_noise, update_err=upd,
               update_witness=upd_noise, stats_err=stats_err, ranks=ranks,
               one_peak_gib=ref["peak_gib"], one_step_ms=ref["ms"][0])

    def short(d):
        return {g: float(f"{e:.3e}") for g, e in d.items()}

    log(f"[sp] {name}{overrides or ''} at (dp {dp}, sp {sp}), one step of {dp} sample(s) vs one "
        f"process: totals {out['outs'][0]['total']:.6f} vs {ref['outs'][0]['total']:.6f}, grad "
        f"norms {out['outs'][0]['grad_norm']:.4f} vs {ref['outs'][0]['grad_norm']:.4f}; relative "
        f"error {loss_err:.3e} (witness {loss_noise:.3e}); parameter updates' relative L2 "
        f"error by group {short(upd)} (witness {short(upd_noise)}); running statistics "
        f"{len(stats)} tensors, max error {stats_err:.3e}; one process step "
        f"{ref['ms'][0]:.1f} ms, peak {ref['peak_gib']:.2f} GiB; the launch {secs:.1f} s; "
        f"card: {smi}")
    if dp_launched is not None:
        del ref
        res["dp_step"] = check_dp_step(name, dict(DP_STEPS)[name], device, smi,
                                       launched=dp_launched)
    return res


def sp_kernel_cases(sca_rows):
    """K1's and K3/K4's cases at a base rank's split shapes (sp 2): TSA at
    20000 of the 40000 queries (the value queue whole), SCA at rank 0's
    packed rows; 6 launches each a frame (K1) or a step (K3/K4)."""
    tsa, sca = K34_CASES[0], K34_CASES[1]
    return [("tsa-sp2", tsa[1], tsa[2] // 2, *tsa[3:]),
            ("sca-sp2", sca[1], sca_rows[0], *sca[3:])]


# ------------------------------------------- phase 19: the modules no config builds

VOV_INPUT = (6, 3, 640, 1600)  # V2's crop, six cameras
VOV_OUT = ((512, 80, 200), (768, 40, 100), (1024, 20, 50))  # out_indices (1, 2, 3): strides 8-32
VOV_FOLD_TOL = 1e-4  # folded vs unfolded VoVNet, max abs err over max |unfolded|, per stage
VOV_REPS = 5  # timed forwards (after a warm-up), each model
MM_BEV = (200, 200)  # MMBEVFormerLayer at its defaults: base's widths
MM_LEVELS = K1_CASES[1][5]  # base's 4 FPN levels at 928 x 1600 (K = 30825)
MM_FWD_TOL = 1e-4  # kernel vs plain path: output, max abs err over max |plain|
MM_GRAD_TOL = 1e-3  # ... each gradient, ||kernel - plain|| / ||plain||
MM_REPS = 3  # timed forwards and backwards, each path
HEAD_GT = 12  # FreeAnchor ground-truth boxes (one outside the BEV: a bag of ties)
HEAD_MAX_NUM = 300
HEAD_LOSS_TOL = 1e-5  # card vs CPU losses, relative
HEAD_REPS = 3


def mm_kernel_cases():
    """K1's and K3/K4's new shapes in one MMBEVFormerLayer call at its
    defaults: the lidar branch (one 200 x 200 level, 40,000 queries, 4
    points) and SCA with every query routed (capacity 0: 40,000 rows a
    camera over base's 4 levels); one launch each a forward (K1) or a
    backward (K3/K4). TSA's shape is base's (`K1_CASES`)."""
    q = MM_BEV[0] * MM_BEV[1]
    return [("lidar", 1, q, 8, 32, (MM_BEV,), 4, 1),
            ("sca-dense", 6, q, 8, 32, MM_LEVELS, 8, 1)]


def mm_layer_launches() -> dict:
    """K1 and K3/K4 launches of one MMBEVFormerLayer forward and backward,
    by (B, Q): TSA over the queue of 2, SCA over the 6 cameras (dense),
    the lidar branch; each one K1 call and, in backward, one K3/K4 call."""
    q = MM_BEV[0] * MM_BEV[1]
    calls = [[1, q, 1], [2, q, 1], [6, q, 1]]
    return dict(msda_fwd=calls, msda_bwd=calls)


def check_vovnet(device, smi):
    """Phase 19 (a): VoVNet V2-99 (FrozenBN with seeded statistics, eval
    mode) on a 6 x 3 x 640 x 1600 batch in channels-last memory (the
    detectors' NHWC images permuted): the out_indices (1, 2, 3) shapes,
    finite outputs, the CUDA-event median of VOV_REPS forwards and the peak,
    and the folded model (`runtime.fuse.fuse_conv_bn`) against the unfolded
    one per stage within VOV_FOLD_TOL, with its time."""
    import copy

    import torch
    from bevformer_torch.models.resnet import FrozenBN
    from bevformer_torch.models.vovnet import VoVNet
    from bevformer_torch.runtime.fuse import fuse_conv_bn

    gen = torch.Generator(device="cpu").manual_seed(19)
    model = VoVNet(out_indices=(1, 2, 3))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBN):
                n = m.weight.shape[0]
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    model = model.to(device).eval()
    # channels-last memory, as the detectors hand a backbone their NHWC
    # images permuted
    n, c, h, w = VOV_INPUT
    x = torch.randn((n, h, w, c), generator=gen).to(device).permute(0, 3, 1, 2)
    folded = fuse_conv_bn(copy.deepcopy(model))

    def run(m):
        with torch.no_grad():
            outs = m(x)
        torch.cuda.synchronize()
        return outs

    res = {}
    for tag, m in (("unfolded", model), ("folded", folded)):
        run(m)
        torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(VOV_REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs = run(m)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        res[tag] = dict(outs=outs, ms=median_of(times),
                        peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    outs = res["unfolded"]["outs"]
    shapes = [tuple(o.shape) for o in outs]
    check(shapes == [(VOV_INPUT[0], *s) for s in VOV_OUT], f"VoVNet output shapes {shapes}")
    check(all(bool(torch.isfinite(o).all()) and float(o.abs().max()) > 0 for o in outs),
          "VoVNet outputs not finite, or zero")
    errs = [rel_err(f, o) for f, o in zip(res["folded"]["outs"], outs)]
    log(f"[vovnet] V2-99 (FrozenBN, eval) on {list(VOV_INPUT)}: outputs {shapes}; forward "
        f"{res['unfolded']['ms']:.2f} ms (median of {VOV_REPS}, CUDA events), peak "
        f"{res['unfolded']['peak_gib']:.2f} GiB; folded (fuse_conv_bn, "
        f"{sum(isinstance(m, FrozenBN) for m in model.modules())} BNs) "
        f"{res['folded']['ms']:.2f} ms, peak {res['folded']['peak_gib']:.2f} GiB, max abs err / "
        f"max |unfolded| by stage {[float(f'{e:.3e}') for e in errs]} (tol "
        f"{VOV_FOLD_TOL:.0e}); card: {smi}")
    check(max(errs) <= VOV_FOLD_TOL, f"VoVNet folded vs unfolded: {errs}")
    return dict(ms=res["unfolded"]["ms"], peak_gib=res["unfolded"]["peak_gib"],
                folded_ms=res["folded"]["ms"], fold_err=max(errs), shapes=shapes)


def mm_inputs(device):
    """MMBEVFormerLayer's inputs at base's widths, seeded: the BEV query,
    its position and TSA queue, base's 6-camera value over its 4 levels, a
    200 x 200 lidar BEV, the hybrid 2D references (the previous frame's
    shifted by 1.5 cells), and the camera references and `bev_mask` from
    base's `point_sampling` of the synthetic rigs (`data.synth`)."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.core import geometry
    from bevformer_torch.data.synth import rig_lidar2img

    cfg = get_config("bevformer_base")
    gen = torch.Generator(device="cpu").manual_seed(19)
    q, e = MM_BEV[0] * MM_BEV[1], cfg.embed_dims
    k = sum(h * w for h, w in MM_LEVELS)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(device)

    ref_3d = geometry.reference_points_3d(*MM_BEV, cfg.pc_range[5] - cfg.pc_range[2],
                                          cfg.num_points_in_pillar, bs=1, device=device)
    ref_2d = geometry.reference_points_2d(*MM_BEV, bs=1, device=device)
    l2i = torch.from_numpy(rig_lidar2img()).float()[None].to(device)
    ref_cam, bev_mask = geometry.point_sampling(ref_3d, cfg.pc_range, l2i, cfg.data.img_size)
    shift = torch.tensor([1.5 / MM_BEV[1], -1.5 / MM_BEV[0]], device=device)
    return dict(query=rnd(1, q, e), value=rnd(1, 6, k, e), lidar=rnd(1, q, e),
                bev_pos=rnd(1, q, e), vq=rnd(1, 2, q, e),
                ref2d=torch.stack([ref_2d + shift, ref_2d], 1), ref_cam=ref_cam,
                bev_mask=bev_mask, proj=rnd(1, q, e))


MM_ORDER = ("query", "value", "lidar", "bev_pos", "vq", "ref2d", "ref_cam", "bev_mask")
MM_GRAD_INPUTS = ("query", "value", "lidar", "vq")


def check_mm_layer(device, smi):
    """Phase 19 (b): MMBEVFormerLayer at its defaults (base's widths, SCA
    capacity 0) on `mm_inputs`, eval mode (no dropout), on the kernel path
    and on the plain path (`plain_kernels`): one forward and one backward of
    a seeded projection each, the output within MM_FWD_TOL and each
    gradient (inputs and parameters) within MM_GRAD_TOL; the kernel path's
    K1 and K3/K4 launches counted from 0 over its forward and backward
    (`mm_layer_launches`); CUDA-event medians of MM_REPS forwards and
    backwards of each path, and the kernel path's peak."""
    import torch
    from bevformer_torch.kernels import launch_counts, launch_queries, zero_counts
    from bevformer_torch.models.mm_layer import MMBEVFormerLayer

    torch.manual_seed(19)
    layer = MMBEVFormerLayer().to(device).eval()
    a = mm_inputs(device)
    n_vis = a["bev_mask"].any(-1).sum(-1)[0].tolist()

    def run(counted=False):
        xs = {k: (v.clone().requires_grad_(True) if k in MM_GRAD_INPUTS else v)
              for k, v in a.items()}
        layer.zero_grad(set_to_none=True)
        if counted:
            zero_counts()
        out = layer(*[xs[k] for k in MM_ORDER], MM_LEVELS, *MM_BEV)
        (out * xs["proj"]).sum().backward()
        torch.cuda.synchronize()
        counts = (launch_counts(), launch_queries()) if counted else None
        grads = {f"d{k}": xs[k].grad for k in MM_GRAD_INPUTS}
        grads.update({n: p.grad for n, p in layer.named_parameters()})
        return out.detach(), grads, counts

    def timed():
        xs = {k: (v.clone().requires_grad_(True) if k in MM_GRAD_INPUTS else v)
              for k, v in a.items()}
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        out = layer(*[xs[k] for k in MM_ORDER], MM_LEVELS, *MM_BEV)
        marks[1].record()
        (out * xs["proj"]).sum().backward()
        marks[2].record()
        torch.cuda.synchronize()
        return marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])

    torch.cuda.reset_peak_memory_stats(device)
    out, grads, (counts, queries) = run(counted=True)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    ker = [timed() for _ in range(MM_REPS)]
    with plain_kernels():
        ref, ref_grads, _ = run()
        plain = [timed() for _ in range(MM_REPS)]
    want = mm_layer_launches()
    got = {k: queries[k] for k in want}
    check(counts["msda_fwd"] == 3 and counts["msda_bwd"] == 3 and got == want,
          f"mm_layer launches {counts}, by (B, Q) {got}, want {want}")
    check(bool(torch.isfinite(out).all()), "mm_layer output not finite")
    fwd_err = rel_err(out, ref)
    grad_errs = {k: float((g - ref_grads[k]).norm() / ref_grads[k].norm().clamp(min=1e-30))
                 for k, g in grads.items()}
    worst = max(grad_errs, key=grad_errs.get)
    res = dict(fwd_ms=median_of([t[0] for t in ker]), bwd_ms=median_of([t[1] for t in ker]),
               plain_fwd_ms=median_of([t[0] for t in plain]),
               plain_bwd_ms=median_of([t[1] for t in plain]), peak_gib=peak, fwd_err=fwd_err,
               grad_err=grad_errs[worst], launches=counts, queries=got)
    log(f"[mm] MMBEVFormerLayer (defaults: 256 channels, 8 heads, SCA capacity 0) at 40,000 "
        f"queries, 6 x {sum(h * w for h, w in MM_LEVELS)} camera values, a 200 x 200 lidar BEV; "
        f"visible queries by camera {n_vis}: kernel vs plain output max abs err / max |plain| "
        f"{fwd_err:.3e} (tol {MM_FWD_TOL:.0e}), gradients' relative L2 error at most "
        f"{grad_errs[worst]:.3e} ({worst}; tol {MM_GRAD_TOL:.0e}; inputs "
        f"{ {k: float(f'{grad_errs[k]:.2e}') for k in grads if k.startswith('d')} }); forward "
        f"{res['fwd_ms']:.2f} / backward {res['bwd_ms']:.2f} ms (plain {res['plain_fwd_ms']:.2f} / "
        f"{res['plain_bwd_ms']:.2f}; medians of {MM_REPS}, CUDA events), peak {peak:.2f} GiB; "
        f"launches counted from 0 over one forward and backward: K1 {counts['msda_fwd']}, "
        f"K3/K4 {counts['msda_bwd']}, by (B, Q) {got['msda_fwd']}; card: {smi}")
    check(fwd_err <= MM_FWD_TOL, f"mm_layer output {fwd_err}")
    check(grad_errs[worst] <= MM_GRAD_TOL, f"mm_layer gradient {worst}: {grad_errs[worst]}")
    return res


def head_gt(cfg):
    """HEAD_GT bottom-z boxes [1, G, 9] and labels, seeded: boxes of the
    classes' sizes inside the BEV, one a 0.3 m box at a cell's centre, and
    one outside the BEV (its bag: IoU-0 anchors, every one a tie)."""
    import numpy as np
    import torch
    from bevformer_torch.models.bev_head import ANCHOR_SIZES

    rng = np.random.RandomState(19)
    labels = rng.randint(0, len(ANCHOR_SIZES), HEAD_GT)
    boxes = np.zeros((HEAD_GT, 9), np.float32)
    boxes[:, :2] = rng.uniform(-45, 45, (HEAD_GT, 2))
    boxes[:, 2] = rng.uniform(-2, 0, HEAD_GT)
    boxes[:, 3:6] = np.asarray(ANCHOR_SIZES)[labels] * rng.uniform(0.8, 1.2, (HEAD_GT, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, HEAD_GT)
    boxes[:, 7:] = rng.randn(HEAD_GT, 2)
    cell = (cfg.pc_range[3] - cfg.pc_range[0]) / cfg.bev_w
    boxes[0, :7] = [cfg.pc_range[0] + 100.5 * cell, cfg.pc_range[1] + 80.5 * cell, -1.0, 0.3,
                    0.3, 1.0, 0.0]
    boxes[1, :2] = [200.0, -200.0]
    return (torch.from_numpy(boxes)[None], torch.from_numpy(labels.astype(np.int64))[None],
            torch.tensor([HEAD_GT]))


def check_bev_head(device, smi):
    """Phase 19 (c): BEVHead at base's 200 x 200 x 256 BEV (800,000
    anchors; the conv_cls bias of every 7th class channel at 40, so that
    its sigmoid saturates to 1 and `get_bboxes` picks among ties), on a
    seeded BEV of that shape: forward, the FreeAnchor loss on HEAD_GT boxes,
    backward and `get_bboxes(max_num=HEAD_MAX_NUM)`, each timed (CUDA
    events, medians of HEAD_REPS), the peak. The same predictions on the
    CPU: the losses within HEAD_LOSS_TOL, every bag's anchors and the
    decoded (anchor, class) picks equal, in order (the tie order)."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.models import bev_head as bh

    cfg = get_config("bevformer_base")
    torch.manual_seed(19)
    head = bh.BEVHead(cfg)
    with torch.no_grad():
        head.conv_cls.bias[::7] = 40.0
    head = head.to(device)
    gen = torch.Generator(device="cpu").manual_seed(19)
    bev = torch.randn((1, cfg.bev_h * cfg.bev_w, cfg.embed_dims), generator=gen).to(device)
    boxes, labels, ng = head_gt(cfg)

    def stamp():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(HEAD_REPS + 1):
        head.zero_grad(set_to_none=True)
        t = [stamp()]
        preds = head(bev)
        t.append(stamp())
        losses = head.loss(preds, boxes.to(device), labels.to(device), ng.to(device))
        t.append(stamp())
        losses["total"].backward()
        t.append(stamp())
        dec = head.get_bboxes(preds, HEAD_MAX_NUM)
        t.append(stamp())
        torch.cuda.synchronize()
        times.append([a.elapsed_time(b) for a, b in zip(t[:-1], t[1:])])
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    ms = [median_of([x[i] for x in times[1:]]) for i in range(4)]

    cpu_preds = {k: v.detach().cpu() for k, v in preds.items()}
    cpu_losses = head.loss(cpu_preds, boxes, labels, ng)
    cpu_dec = head.get_bboxes(cpu_preds, HEAD_MAX_NUM)
    anchors = {d: bh.generate_anchors(cfg.bev_h, cfg.bev_w, cfg.pc_range, d)
               for d in ("cpu", device)}
    bags = {d: bh.positive_bags(anchors[d], boxes[0].to(d), HEAD_GT, head.pre_anchor_topk)
            for d in ("cpu", device)}
    losses = {k: float(v.detach()) for k, v in losses.items()}
    cpu_losses = {k: float(v.detach()) for k, v in cpu_losses.items()}
    loss_errs = {k: abs(v - cpu_losses[k]) / max(abs(cpu_losses[k]), 1e-12)
                 for k, v in losses.items()}
    same_bags = torch.equal(bags[device][2].cpu(), bags["cpu"][2])
    ties = int((bags["cpu"][1] == 0).sum())
    picks = {d: (r["labels"].cpu(), r["bboxes"].cpu()) for d, r in (("card", dec),
                                                                     ("cpu", cpu_dec))}
    same_picks = torch.equal(picks["card"][0], picks["cpu"][0])
    box_err = rel_err(picks["card"][1], picks["cpu"][1])
    saturated = int((dec["scores"] == 1.0).sum())
    log(f"[head] BEVHead (FreeAnchor) on a {cfg.bev_h} x {cfg.bev_w} x {cfg.embed_dims} BEV, "
        f"{anchors['cpu'].shape[0]} anchors, {HEAD_GT} GT boxes: losses "
        f"{ {k: round(v, 6) for k, v in losses.items()} } (CPU relative error "
        f"{max(loss_errs.values()):.2e}, tol {HEAD_LOSS_TOL:.0e}); bags' anchors equal the CPU's "
        f"in order: {same_bags} ({ties} IoU-0 ties among {HEAD_GT} x {head.pre_anchor_topk}); "
        f"get_bboxes({HEAD_MAX_NUM}) picks equal the CPU's in order: {same_picks} ({saturated} "
        f"saturated scores; boxes max abs err / max |box| {box_err:.2e}); forward {ms[0]:.3f}, "
        f"loss {ms[1]:.3f}, backward {ms[2]:.3f}, get_bboxes {ms[3]:.3f} ms (medians of "
        f"{HEAD_REPS}, CUDA events), peak {peak:.2f} GiB; card: {smi}")
    check(all(math.isfinite(v) for v in losses.values()), f"BEVHead losses {losses}")
    check(max(loss_errs.values()) <= HEAD_LOSS_TOL, f"BEVHead card vs CPU losses {loss_errs}")
    check(same_bags and ties > 0, f"BEVHead bags differ on the card, or no tie ({ties})")
    check(same_picks and saturated == HEAD_MAX_NUM and box_err <= SLICE_TOL,
          f"BEVHead get_bboxes picks differ on the card ({saturated} saturated, boxes {box_err})")
    return dict(fwd_ms=ms[0], loss_ms=ms[1], bwd_ms=ms[2], decode_ms=ms[3], peak_gib=peak,
                loss_err=max(loss_errs.values()), ties=ties)


# ---------------------------------------------------------- measuring tools

# phase 20: (tool, argv) in order, each `main(argv)` in this process
TOOL_RUNS = (
    ("benchmark", ["bevformer_base", "--samples", "4"]),
    ("benchmark", ["bevformer_base", "--samples", "4", "--dtype", "bfloat16"]),
    ("bench_train_step", ["bevformer_base", "--steps", "2"]),
    ("bench_components", ["bevformer_base"]),
    ("bench_enc_only", ["--layers", "1", "6"]),
    ("bench_enc_only", ["--glue"]),
    ("bench_dcn", []),
    ("bench_v2", []),
    ("bench_train_v2", ["--iters", "1"]),
    ("bench_train2", []),
    ("bench_train_bisect", []),
    ("audit_sca_capacity", []),
)
TOOL_FRAME_TOL = 0.15  # benchmark's fp32 base frame median against phase 10's, relative


def profile_benchmark_frames(smi, medians):
    """One frame of `tools.benchmark`'s chain on bevformer_base (after its
    warm-up frames) under torch.profiler in each dtype of `medians`: its
    device kernel time against the tool's CUDA-event frame median of that
    dtype (`medians`, an unprofiled frame) gives the device's idle share
    of a frame. {dtype: dict(busy_ms, wall_ms, idle)}."""
    import torch
    from bevformer_torch.device import precision
    from bevformer_torch.runtime.eval import VideoEvaluator
    from bevformer_torch.tools import benchmark, common

    device = torch.device("cuda", 0)
    out = {}
    for dtype, median in medians.items():
        cfg = common.tool_config("bevformer_base", (), dtype)
        chain = benchmark.frames(VideoEvaluator(common.seeded_model(cfg, device)),
                                 common.example_inputs(cfg, 1, device))
        with precision(dtype, device.type):
            for _ in range(benchmark.WARMUP):
                next(chain)
            wall, busy = profile_run(lambda: next(chain), "tools",
                                     f"benchmark bevformer_base {dtype} frame", smi)
        out[dtype] = dict(busy_ms=busy, wall_ms=wall, idle=1 - busy / median)
        log(f"[tools] benchmark bevformer_base {dtype}: device kernel time {busy:.2f} ms of the "
            f"tool's {median:.2f} ms frame median: idle {out[dtype]['idle']:.1%} of an "
            f"unprofiled frame; card: {smi}")
        del chain
        torch.cuda.empty_cache()
    return out


def run_tool(name, argv):
    """`bevformer_torch.tools.<name>.main(argv)` in this process: its
    record, the JSON lines it printed and its wall seconds."""
    import io
    from contextlib import redirect_stdout
    from importlib import import_module

    out = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        rec = import_module(f"bevformer_torch.tools.{name}").main(argv)
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    return rec, lines, time.perf_counter() - t0


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def check_tools(smi, frame_ms):
    """Phase 20: every measuring tool through its `main` (TOOL_RUNS), each
    record's keys, launches and orderings checked; `frame_ms` is phase 10's
    fp32 frame median."""
    import torch
    from bevformer_torch.configs import get_config
    from bevformer_torch.models.conv_sites import conv_sites

    recs = {}
    for name, argv in TOOL_RUNS:
        rec, lines, secs = run_tool(name, argv)
        what = " ".join([name, *argv])
        check(lines == [rec], f"{what}: printed {len(lines)} JSON lines, not its one record")
        check(rec["card"] == smi, f"{what}: card {rec['card']!r}, not {smi!r}")
        check(rec.get("clock", "cuda_events") == "cuda_events", f"{what}: clock {rec.get('clock')}")
        for key in ("metric", "value", "unit", "vs_baseline", "dtype", "tf32", "peak_gib",
                    "launches"):
            check(key in rec, f"{what}: no {key!r} in its line")
        check(math.isfinite(rec["value"]), f"{what}: value {rec['value']}")
        cases = rec.get("cases", {})
        detail = [f"spread {rec['ms_min']:.2f}-{rec['ms_max']:.2f} ms"] if "ms_min" in rec else []
        detail += [f"{k} {c['ms_median']:.2f}" for k, c in cases.items() if "ms_median" in c]
        log(f"[tools] {what}: {rec['value']:.4g} {rec['unit']} ({', '.join(detail)}), peak "
            f"{rec['peak_gib']:.2f} GiB, launches {rec['launches']}, tf32 {rec['tf32']}, "
            f"{secs:.1f} s; {rec['metric']}; card: {smi}")
        recs[what] = rec
        torch.cuda.empty_cache()

    base = get_config("bevformer_base")
    frame, step = path_launches(base)
    fp32 = recs["benchmark bevformer_base --samples 4"]
    bf16 = recs["benchmark bevformer_base --samples 4 --dtype bfloat16"]
    check(fp32["launches"] == nonzero(frame), f"benchmark fp32: launches {fp32['launches']}, "
          f"not {nonzero(frame)}")
    check(bf16["launches"] == nonzero(path_launches(base.replace(dtype="bfloat16"))[0]),
          f"benchmark bf16: launches {bf16['launches']}")
    off = abs(fp32["frame_ms_median"] - frame_ms) / frame_ms
    log(f"[tools] benchmark fp32 frame median {fp32['frame_ms_median']:.2f} ms (CUDA events) "
        f"against phase 10's {frame_ms:.2f} (host clock): {100 * off:.1f}% apart; bf16 "
        f"{bf16['frame_ms_median']:.2f} ms; SCA dropped {fp32['max_capacity_clipped']} (most "
        f"visible {fp32['max_visible']} of capacity {fp32['sca_capacity']})")
    check(off <= TOOL_FRAME_TOL, f"benchmark fp32 frame {fp32['frame_ms_median']:.2f} ms is "
          f"{100 * off:.1f}% from phase 10's {frame_ms:.2f}")
    idle = profile_benchmark_frames(smi, {"float32": fp32["frame_ms_median"],
                                          "bfloat16": bf16["frame_ms_median"]})
    for rec in (fp32, bf16):
        check(rec["max_capacity_clipped"] == 0, f"the example frame dropped "
              f"{rec['max_capacity_clipped']} visible SCA queries")
    ts = recs["bench_train_step bevformer_base --steps 2"]
    want = dict(step)
    for k, v in remat_step_counts(base).items():
        want[k] += v
    check(ts["launches"] == nonzero(want), f"bench_train_step: launches {ts['launches']}, not "
          f"{nonzero(want)}")
    check(math.isfinite(ts["loss"]), f"bench_train_step: loss {ts['loss']}")
    comp = recs["bench_components bevformer_base"]["cases"]
    bb, bev, full = (comp[k]["ms_median"] for k in ("backbone_neck", "bev_only", "full"))
    check(bb < bev < full, f"bench_components: backbone + neck {bb:.2f}, BEV only {bev:.2f}, "
          f"full {full:.2f} ms")
    check(comp["full"]["launches_per_call"] == nonzero(frame),
          f"bench_components: full forward launches {comp['full']['launches_per_call']}")
    enc = recs["bench_enc_only --layers 1 6"]["cases"]
    check(enc["L1"]["ms_median"] < enc["L6"]["ms_median"],
          f"bench_enc_only: L1 {enc['L1']['ms_median']:.2f} >= L6 {enc['L6']['ms_median']:.2f}")
    check(enc["L6"]["launches_per_call"] == {"msda_fwd": 2 * base.encoder_layers},
          f"bench_enc_only L6: launches {enc['L6']['launches_per_call']}")
    dcn = recs["bench_dcn"]["cases"]

    def backbone_convs(cfg):  # the dense conv kernel's launches in a backbone pass
        return sum(s["engaged"] and s["name"].startswith("img_backbone.")
                   for s in conv_sites(cfg))

    want = (dict(dcn_conv_fwd=frame["dcn_conv_fwd"], conv_fwd=backbone_convs(base)),
            dict(conv_fwd=backbone_convs(base.replace(backbone_dcn_stages=()))))
    check((dcn["dcn"]["launches_per_call"], dcn["plain"]["launches_per_call"]) == want,
          f"bench_dcn: launches {dcn['dcn']['launches_per_call']} / "
          f"{dcn['plain']['launches_per_call']}, not {want[0]} / {want[1]}")
    t1 = get_config("bevformerv2-r50-t1")
    check(recs["bench_v2"]["launches"] == nonzero(v2_per_sample(t1)),
          f"bench_v2: launches {recs['bench_v2']['launches']}")
    tv2 = recs["bench_train_v2 --iters 1"]
    check(tv2["launches"].get("msda_bwd") == v2_train_per_step(t1)["msda_bwd"]
          and math.isfinite(tv2["loss"]), f"bench_train_v2: launches {tv2['launches']}, loss "
          f"{tv2['loss']}")
    for what in ("bench_train2", "bench_train_bisect"):
        for case, c in recs[what]["cases"].items():
            check(math.isfinite(c["loss"]) and c["ms_median"] > 0, f"{what} {case}: {c}")
    audit = recs["audit_sca_capacity"]["cases"]
    check(audit["base_synthetic"]["max_capacity_clipped"] == 0,
          f"the synthetic rig dropped {audit['base_synthetic']['max_capacity_clipped']} visible "
          "SCA queries at base")
    log("[tools] SCA audit: visible-query fraction max " + ", ".join(
        f"{k} {c['max_query_fraction']:.4f} (pairs {c['max_pair_fraction']:.4f}, dropped "
        f"{c['max_capacity_clipped']} at ratio {c['capacity_ratio']})" for k, c in audit.items()))
    return dict(frame_ms=fp32["frame_ms_median"], fps=fp32["value"],
                bf16_frame_ms=bf16["frame_ms_median"], step_ms=ts["value"], backbone_ms=bb,
                bev_ms=bev, full_ms=full, v2_ms=recs["bench_v2"]["value"],
                v2_train_ms=tv2["value"], frame_off=off, idle=idle)


DECODE_REPEATS = 3  # timed decodes of one frame's six images, each codec


def decode_times(data, smi):
    """Phase 19 (d): one frame's six camera decodes on the host
    (`data.image_io.read_image`: cv2), JPEG (the CLI root's files) and PNG
    of the same pixels (written here by cv2 at its default level): the
    median of DECODE_REPEATS after a warm-up, and the files' bytes."""
    import shutil
    import tempfile

    import numpy as np
    from bevformer_torch.data.image_io import read_image, write_image

    samples = os.path.join(data, "samples")
    jpgs = sorted(os.path.join(samples, f) for f in os.listdir(samples))[:6]
    tmp = tempfile.mkdtemp(prefix="bevformer_png_")
    try:
        pngs = []
        for p in jpgs:
            pngs.append(os.path.join(tmp, os.path.basename(p)[:-4] + ".png"))
            write_image(pngs[-1], read_image(p))
        res = {}
        for tag, files in (("jpeg", jpgs), ("png", pngs)):
            secs = []
            for _ in range(DECODE_REPEATS + 1):
                t = time.perf_counter()
                imgs = [read_image(f) for f in files]
                secs.append(time.perf_counter() - t)
            res[tag] = median_of(secs[1:]) * 1e3
            res[f"{tag}_mb"] = sum(os.path.getsize(f) for f in files) / 1e6
        check(all(np.array_equal(read_image(a), read_image(b)) for a, b in zip(jpgs, pngs)),
              "the PNGs do not hold the JPEGs' pixels")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[decode] one frame's 6 cameras ({imgs[0].shape[1]} x {imgs[0].shape[0]}) on the host: "
        f"cv2 JPEG {res['jpeg']:.1f} ms ({res['jpeg_mb']:.2f} MB), cv2 PNG of the same pixels "
        f"{res['png']:.1f} ms ({res['png_mb']:.2f} MB); medians of {DECODE_REPEATS}; card: {smi}")
    return dict(jpeg_decode_ms=res["jpeg"], png_decode_ms=res["png"], jpeg_mb=res["jpeg_mb"],
                png_mb=res["png_mb"])


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
    from bevformer_torch.tools import common, roofline

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = common.card_line()
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
    # the library's SASS (one cuobjdump, ~10 s on the host) is read while
    # phases 3-6 run on the card; check_vector_atomics reads it after them
    sass = ThreadPoolExecutor(1)
    pending_sass = sass.submit(build.sass, res.path)

    seconds = {}  # each phase's wall time

    @contextmanager
    def phase(n):
        t = time.perf_counter()
        yield
        seconds[n] = round(time.perf_counter() - t, 1)
        torch.cuda.empty_cache()

    seconds["1-2"] = round(time.perf_counter() - t_start, 1)
    gen = torch.Generator(device=device).manual_seed(0)
    with phase("3"):
        k1_rows = check_k1(device, gen)
        k1_v2_rows = check_k1(device, gen, K1_V2_CASES, "k1-v2")
        k1_v2_train_rows = check_k1(device, gen, K1_V2_TRAIN_CASES, "k1-v2-train")
    with phase("4"):
        k2_rows = check_k2(device, gen)
        conv_rows = check_conv(device, gen)
        conv_v2_rows = check_conv(device, gen, "bevformerv2-r50-t8")
    with phase("5"):
        k34_rows = check_k34(device, gen)
        k34_v2_train_rows = check_k34_v2(device, gen)
        bf16_fwd_rows, bf16_bwd_rows = check_bf16_msda(device, gen)
    with phase("6"):
        im2col_rows, col2im_rows = check_k56(device, gen)
        bf16_k2_rows, bf16_k5_rows, bf16_k6_rows = check_bf16_dcn(device, gen)
        bf16_k2_ragged = check_bf16_k2_ragged(device, gen)
    pending_sass.result()
    sass.shutdown()
    check_vector_atomics(res.path)
    with phase("7"):
        probe_runs, probe_counts = check_probes()
    with phase("8"):
        tr = check_training(device, smi)
    with phase("9"):
        check_training_witness(device, smi)
    with phase("10-11"):
        sl = check_slice(device, smi)
        check_precision(sl["model"], sl["video"])
        profile_frame(sl["model"], sl["video"], smi)
        del sl["model"], sl["video"]
    with phase("12 and 17 (a)"):
        cli = check_cli(smi)
    with phase("13"):
        presets = {name: check_preset(name, device, smi) for name in PRESETS}
    with phase("14"):
        v2 = {name: check_v2(name, device, smi) for name in V2_PRESETS}
    with phase("15"):
        v2_train = {name: check_v2_training(name, steps, device, smi)
                    for name, steps in V2_TRAIN}
    with phase("16"):
        bf16_dcn = {name: check_preset(name, device, smi, dtype="bfloat16")
                    for name in BF16_DCN_PRESETS}
    with phase("17 (b), (c)"):
        dp = [check_dp_step(name, steps, device, smi) for name, steps in DP_STEPS
              if name not in DP_IN_SP]
        remat = [check_remat(name, device, smi) for name in REMAT_PRESETS]
    with phase("18 and 17 (b) of DP_IN_SP"):
        sp = [check_sp_step(*case, device, smi) for case in SP_STEPS]
        dp += [r.pop("dp_step") for r in sp if "dp_step" in r]
        sp_encoder = sp[0]["encoder"]
        sp_cases = sp_kernel_cases(sp_encoder["sca_rows"])
        k1_sp_rows = check_k1(device, gen, sp_cases, "k1-sp")
        k34_sp_rows = check_k34(device, gen, sp_cases)
    with phase("19"):
        vov = check_vovnet(device, smi)
        torch.cuda.empty_cache()
        mm = check_mm_layer(device, smi)
        torch.cuda.empty_cache()
        k1_mm_rows = check_k1(device, gen, mm_kernel_cases(), "k1-mm")
        k34_mm_rows = check_k34(device, gen, mm_kernel_cases())
        torch.cuda.empty_cache()
        head = check_bev_head(device, smi)
    with phase("20"):
        tools = check_tools(smi, sl["median_ms"])

    def record(name, src, replaces, rows, per, library_note, counts=tr["counts"], counter=None):
        bound = roofline.total([(r.pop("cost"), r[per]) for r in rows])
        return dict(
            name=name, route="cuda", source=src, replaces=replaces,
            counter=counter or name, launches=counts[counter or name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            # one frame's (forward kernels) or one training step's (backward
            # kernels) worth of launches at the path's shapes
            ms=sum(r["ms"] * r[per] for r in rows),
            plain_ms=sum(r["plain_ms"] * r[per] for r in rows),
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
            library_ms=None, library_note=library_note,
            shapes=rows,
        )

    no_msda = "no single PyTorch call computes msda"
    no_dcn = "no single PyTorch call computes DCNv2"
    kernels = [
        record("msda_fwd", "bevformer_torch/csrc/msda_fwd.cu",
               "bevformer_tpu/kernels/msda_hi.py:243", k1_rows, "per_frame", no_msda),
        record("dcn_conv_fwd", "bevformer_torch/csrc/dcn_conv_fwd.cu",
               "bevformer_tpu/kernels/dcn_pallas.py:329", k2_rows, "per_frame", no_dcn),
        record("msda_bwd", "bevformer_torch/csrc/msda_bwd.cu",
               "bevformer_tpu/kernels/msda_hi.py:744", k34_rows, "per_step",
               "no single PyTorch call computes the msda backward"),
        record("dcn_im2col", "bevformer_torch/csrc/dcn_im2col.cu",
               "bevformer_tpu/kernels/dcn_pallas.py:112", im2col_rows, "per_step",
               "no single PyTorch call computes a modulated deformable im2col"),
        record("dcn_col2im", "bevformer_torch/csrc/dcn_col2im.cu",
               "bevformer_tpu/kernels/msda_pallas.py:318", col2im_rows, "per_step",
               "no single PyTorch call computes the DCN col2im: grid_sampler_2d_backward "
               "leaves out dmask (grid_sampler_ms, and with grid_sampler_2d and the dmask "
               "dot grid_sampler_pair_ms)"),
    ] + probe_records(probe_runs, probe_counts)
    # bf16 K1 and K3/K4: bevformer_tiny_fp16's training run (phase 13) and
    # its video; per frame / per step over tiny's shapes; over a base frame
    # and step at base's shapes beside, with the fp32 entries' time there
    def base_totals(rows, per):
        base = [r for r in rows if r[per]]
        bound = roofline.total([(r["cost"], r[per]) for r in base])
        return dict(ms=sum(r["ms"] * r[per] for r in base),
                    fp32_ms=sum(r["fp32_ms"] * r[per] for r in base),
                    bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])

    bf16_base = [dict(per_frame=base_totals(bf16_fwd_rows, "base_per_frame"),
                      per_step=base_totals(bf16_fwd_rows, "base_per_step")),
                 dict(per_step=base_totals(bf16_bwd_rows, "base_per_step"))]
    fp16 = presets["bevformer_tiny_fp16"]
    kernels += [
        record("msda_fwd_bf16", "bevformer_torch/csrc/msda_fwd.cu",
               "bevformer_tpu/kernels/msda_hi.py:243", bf16_fwd_rows, "per_frame", no_msda,
               counts=fp16["train_counts"]),
        record("msda_bwd_bf16", "bevformer_torch/csrc/msda_bwd.cu",
               "bevformer_tpu/kernels/msda_hi.py:744", bf16_bwd_rows, "per_step",
               "no single PyTorch call computes the msda backward", counts=fp16["train_counts"]),
    ]
    kernels[-2]["inference_launches"] = fp16["inference_counts"]["msda_fwd_bf16"]
    kernels[-2]["bevformer_base"], kernels[-1]["bevformer_base"] = bf16_base
    # bf16 K2, K5 and K6: bevformer_base's bf16 training run (phase 16) and
    # its video; per frame / per step over base's shapes, small's beside
    base16 = bf16_dcn["bevformer_base"]
    kernels += [
        record("dcn_conv_fwd_bf16", "bevformer_torch/csrc/dcn_conv_fwd.cu",
               "bevformer_tpu/kernels/dcn_pallas.py:329", bf16_k2_rows, "per_frame", no_dcn,
               counts=base16["train_counts"]),
        record("dcn_im2col_bf16", "bevformer_torch/csrc/dcn_im2col.cu",
               "bevformer_tpu/kernels/dcn_pallas.py:112", bf16_k5_rows, "per_step",
               "no single PyTorch call computes a modulated deformable im2col",
               counts=base16["train_counts"]),
        record("dcn_col2im_gw", "bevformer_torch/csrc/dcn_col2im.cu",
               "bevformer_tpu/kernels/msda_pallas.py:318", bf16_k6_rows, "per_step",
               "no single PyTorch call computes g W^T and the DCN col2im: "
               "grid_sampler_2d_backward (bf16) leaves out dmask and the product "
               "(grid_sampler_ms; the fp32 product alone product_ms)",
               counts=base16["train_counts"], counter="dcn_col2im_bf16"),
    ]
    kernels[-3]["inference_launches"] = base16["inference_counts"]["dcn_conv_fwd_bf16"]
    kernels[-3]["ragged"] = bf16_k2_ragged
    kernels[-3]["im2col_matmul_ms"] = sum(r["im2col_matmul_ms"] * r["per_frame"]
                                          for r in bf16_k2_rows)
    for key in ("grid_sampler_ms", "product_ms"):
        kernels[-1][key] = sum(r[key] * r["per_step"] for r in bf16_k6_rows)
    kernels[-1]["training_step"] = base16["k6"]
    for k in kernels[-3:]:
        k["launches_per_preset"] = {name: r["train_counts"][k["counter"]] for name, r in
                                    bf16_dcn.items()}
    # K1 on the V2 presets' samples: launches per preset's run, and at V2's
    # shapes per frame encoded (the decoder's once per sample)
    v2_bound = roofline.total([(r.pop("cost"), r["per_frame"]) for r in k1_v2_rows])
    kernels[0]["v2_launches"] = {name: r["counts"]["msda_fwd"] for name, r in v2.items()}
    kernels[0]["v2_shapes"] = k1_v2_rows
    kernels[0]["v2_ms_per_frame"] = sum(r["ms"] * r["per_frame"] for r in k1_v2_rows)
    kernels[0]["v2_bound_ms_per_frame"] = v2_bound["bound_ms"]
    # K1 and K3/K4 at V2 training's new shapes (per call), and their
    # launches per V2 training step of each preset
    for r in k1_v2_train_rows:
        cost = r.pop("cost")
        r.update(bound_ms=cost.bound_ms, bound_by=cost.bound_by)
    kernels[0]["v2_train_shapes"] = k1_v2_train_rows
    kernels[2]["v2_train_shapes"] = k34_v2_train_rows
    for i, key in ((0, "msda_fwd"), (2, "msda_bwd")):
        kernels[i]["v2_train_launches_per_step"] = {
            name: r["per_step"][key] for name, r in v2_train.items()}
    # K1 and K3/K4 at a base rank's split shapes (sp 2, per call), and
    # each rank's launches by call site and queries in phase 18's steps
    for i, rows in ((0, k1_sp_rows), (2, k34_sp_rows)):
        for r in rows:
            cost = r.pop("cost")
            r.update(bound_ms=cost.bound_ms, bound_by=cost.bound_by)
        kernels[i]["sp_shapes"] = rows
        key = "k1" if i == 0 else "k34"
        kernels[i]["sp_launches_per_rank"] = {
            f"{r['name']} dp{r['dp']} sp{r['sp']}": [rank[key] for rank in r["ranks"]] for r in sp}
    # K1 and K3/K4 at MMBEVFormerLayer's new shapes (per call: one launch
    # each a layer's forward or backward), and the layer's launches counted
    # from 0 over one forward and backward (phase 19)
    for i, rows in ((0, k1_mm_rows), (2, k34_mm_rows)):
        for r in rows:
            cost = r.pop("cost")
            r.update(bound_ms=cost.bound_ms, bound_by=cost.bound_by)
        kernels[i]["mm_layer_shapes"] = rows
        kernels[i]["mm_layer_launches"] = mm["launches"]["msda_fwd" if i == 0 else "msda_bwd"]
    # launches: the training run's (all five kernels); the inference run's too
    kernels[0]["inference_launches"] = sl["k1"]
    kernels[1]["inference_launches"] = sl["k2"]
    # the yardsticks, per frame: K7 at K1's shapes, dcn_im2col + matmul at K2's
    kernels[0]["k7_ms"] = sum(r["k7_ms"] * r["per_frame"] for r in k1_rows)
    kernels[1]["im2col_matmul_ms"] = sum(r["im2col_matmul_ms"] * r["per_frame"] for r in k2_rows)
    # K6 on one training step's own inputs too, and its yardstick: ATen's
    # grid sampler backward (no dmask), and with the forward sampler and the
    # dmask dot, the two-call composition of the same function
    k6 = kernels[4]
    k6["training_step"] = tr["k6"]
    for key in ("grid_sampler_ms", "grid_sampler_pair_ms"):
        k6[key] = sum(r[key] * r["per_step"] for r in col2im_rows)
    # the dense conv kernel: launches of the training run (history frames
    # and the trained frame's stage 1) and of the inference run; per frame
    # at base's shapes, at t8's beside
    kernels.append(record(
        "conv_fwd", "bevformer_torch/csrc/conv_fwd.cu",
        "none: bevformer_tpu's convolutions are XLA's", conv_rows, "per_frame",
        "plain_ms is the library's route: cuDNN fp32 (F.conv2d, TF32 off), then the affine, "
        "the residual and the ReLU"))
    conv_v2_bound = roofline.total([(r.pop("cost"), r["per_frame"]) for r in conv_v2_rows])
    kernels[-1].update(
        inference_launches=sl["conv"], v2_shapes=conv_v2_rows,
        v2_ms_per_frame=sum(r["ms"] * r["per_frame"] for r in conv_v2_rows),
        v2_plain_ms_per_frame=sum(r["plain_ms"] * r["per_frame"] for r in conv_v2_rows),
        v2_bound_ms_per_frame=conv_v2_bound["bound_ms"],
        v2_launches={name: r["counts"]["conv_fwd"] for name, r in v2.items()})
    log(f"[summary] training step median {tr['median_ms']:.1f} ms, peak {tr['peak_gib']:.2f} GiB; "
        f"inference frame median {sl['median_ms']:.1f} ms, peak {sl['peak_gib']:.2f} GiB; "
        f"on {smi}; bounds against {roofline.PEAKS}")
    log(f"[summary] CLIs: tools.train step median {cli['step_ms']:.1f} ms (host "
        f"{cli['host_ms']:.1f} ms, data wait {cli['data_wait_ms']:.1f} ms), tools.test frame "
        f"median {cli['frame_ms']:.1f} ms (load {cli['load_ms']:.1f} ms), phase "
        f"{cli['seconds']:.1f} s")
    log(f"[summary] CLIs: tools.train bevformer_base dtype=bfloat16 step median "
        f"{cli['bf16_step_ms']:.1f} ms, peak {cli['bf16_train_peak_gib']} GiB; tools.test frame "
        f"median {cli['bf16_frame_ms']:.1f} ms, peak {cli['bf16_test_peak_gib']} GiB")
    log(f"[summary] CLIs: tools.fp16.train bevformer_tiny step median {cli['fp16_step_ms']:.1f} ms, "
        f"tools.test bevformer_tiny frame median {cli['unfused_frame_ms']:.1f} ms, with "
        f"--fuse-conv-bn {cli['fuse_frame_ms']:.1f} ms")
    for r in [*presets.values(), *bf16_dcn.values()]:
        log(f"[summary] {r['name']} ({r['dtype']}): frame median {r['frame_ms']:.1f} ms, peak "
            f"{r['frame_peak_gib']:.2f} GiB; training step median {r['step_ms']:.1f} ms, peak "
            f"{r['step_peak_gib']:.2f} GiB; on {smi}")
    for r in v2.values():
        fusion = f", ResNetFusion {r['fusion_ms']:.2f} ms of it" if r["fusion_ms"] else ""
        log(f"[summary] {r['name']} (fp32): sample median {r['sample_ms']:.1f} ms{fusion}, peak "
            f"{r['peak_gib']:.2f} GiB, {r['k1_per_sample']} K1 launches per sample; on {smi}")
    log(f"[summary] CLIs: tools.test bevformerv2-r50-t1-base sample median "
        f"{cli['v2_sample_ms']:.1f} ms, with --fuse-conv-bn {cli['v2_fused_sample_ms']:.1f} ms")
    for r in v2_train.values():
        extra = (f", one step at the {V2_BIG_RUNG} rung {r['big_step_ms']:.1f} ms with peak "
                 f"{r['big_peak_gib']:.2f} GiB" if "big_step_ms" in r else "")
        fusion = (f", ResNetFusion forward {r['fusion_fwd_ms']:.2f} / backward "
                  f"{r['fusion_bwd_ms']:.2f} ms" if "fusion_fwd_ms" in r else "")
        log(f"[summary] {r['name']} training (fp32): step median {r['step_ms']:.1f} ms, peak "
            f"{r['peak_gib']:.2f} GiB at the 640 rung{extra}{fusion}; K1 "
            f"{r['per_step']['msda_fwd']}, K3/K4 {r['per_step']['msda_bwd']} launches per step; "
            f"on {smi}")
    log(f"[summary] CLIs: tools.train bevformerv2-r50-t1 step median "
        f"{cli['v2_train_step_ms']:.1f} ms (host {cli['v2_train_host_ms']:.1f} ms, data wait "
        f"{cli['v2_train_data_wait_ms']:.1f} ms), peak {cli['v2_train_peak_gib']} GiB; "
        f"bevformerv2-r50-t8 step median {cli['v2_t8_train_step_ms']:.1f} ms (host "
        f"{cli['v2_t8_train_host_ms']:.1f} ms, data wait {cli['v2_t8_train_data_wait_ms']:.1f} "
        f"ms), peak {cli['v2_t8_train_peak_gib']} GiB; one frame's photometric distortion host "
        f"{cli['photometric_host_ms']:.1f} / card {cli['photometric_card_ms']:.1f} ms")
    log(f"[summary] phase 17: torchrun tools.train bevformer_base on 1 NCCL rank: step median "
        f"{cli['nccl_step_ms']:.1f} ms, peak {cli['nccl_peak_gib']:.2f} GiB, losses within "
        f"{cli['nccl_loss_err']:.3e} of one process at the first step; tools.test on 2 gloo ranks: boxes within "
        f"{cli['test_box_err']:.3e} of 1 ({cli['dp_cli_seconds']:.1f} s); on {smi}")
    for r in dp:
        log(f"[summary] phase 17: {r['name']} over 2 gloo ranks vs 1 process: losses within "
            f"{r['loss_err']:.3e} (witness {r['loss_witness']:.3e}), updates within "
            f"{max(r['update_err'].values()):.3e}, running "
            f"statistics within {r['stats_err']:.3e}; peak {r['dp_peak_gib']:.2f} GiB a rank, "
            f"{r['one_peak_gib']:.2f} GiB one process; on {smi}")
    for r in remat:
        log(f"[summary] phase 17: {r['name']} use_remat: peak {r['peak_gib']:.2f} -> "
            f"{r['remat_peak_gib']:.2f} GiB, step {r['step_ms']:.1f} -> {r['remat_step_ms']:.1f} "
            f"ms, launches {r['launches']}; on {smi}")
    log(f"[summary] phase 18: base encoder at sp 2 vs 1: BEV within {sp_encoder['err']:.3e}; "
        f"SCA rows a rank {sp_encoder['sca_rows']} of {K34_CASES[1][2]}; peak "
        f"{[round(p, 2) for p in sp_encoder['peaks']]} GiB a rank, "
        f"{sp_encoder['one_peak_gib']:.2f} GiB one process; on {smi}")
    for r in sp:
        log(f"[summary] phase 18: {r['name']} at (dp {r['dp']}, sp {r['sp']}) vs 1 process: "
            f"losses within {r['loss_err']:.3e} (witness {r['loss_witness']:.3e}), updates within "
            f"{max(r['update_err'].values()):.3e}, running statistics within "
            f"{r['stats_err']:.3e}; peak {[round(k['peak_gib'], 2) for k in r['ranks']]} GiB a "
            f"rank, {r['one_peak_gib']:.2f} GiB one process; on {smi}")
    log(f"[summary] phase 19: VoVNet-99 forward on {list(VOV_INPUT)} {vov['ms']:.2f} ms (folded "
        f"{vov['folded_ms']:.2f}, within {vov['fold_err']:.2e}), peak {vov['peak_gib']:.2f} GiB; "
        f"MMBEVFormerLayer forward / backward {mm['fwd_ms']:.2f} / {mm['bwd_ms']:.2f} ms (plain "
        f"{mm['plain_fwd_ms']:.2f} / {mm['plain_bwd_ms']:.2f}), kernel vs plain "
        f"{mm['fwd_err']:.2e} / gradients {mm['grad_err']:.2e}, peak {mm['peak_gib']:.2f} GiB; BEVHead forward "
        f"{head['fwd_ms']:.3f}, FreeAnchor loss {head['loss_ms']:.3f}, backward "
        f"{head['bwd_ms']:.3f}, get_bboxes {head['decode_ms']:.3f} ms, peak "
        f"{head['peak_gib']:.2f} GiB, card = CPU (losses within {head['loss_err']:.1e}); "
        f"phase 12's tools.test load {cli['load_ms']:.1f} ms a frame (JPEG), six decodes "
        f"JPEG {cli['jpeg_decode_ms']:.1f} / PNG {cli['png_decode_ms']:.1f} ms; on {smi}")
    log(f"[summary] phase 20: benchmark bevformer_base fp32 {tools['fps']:.3f} frames/s (frame "
        f"{tools['frame_ms']:.2f} ms, {100 * tools['frame_off']:.1f}% from phase 10, idle "
        f"{tools['idle']['float32']['idle']:.1%}), bf16 frame {tools['bf16_frame_ms']:.2f} ms "
        f"(idle {tools['idle']['bfloat16']['idle']:.1%}); bench_train_step (use_remat) {tools['step_ms']:.1f} "
        f"ms; components backbone + neck {tools['backbone_ms']:.2f} / BEV only "
        f"{tools['bev_ms']:.2f} / full {tools['full_ms']:.2f} ms; V2 t1 sample "
        f"{tools['v2_ms']:.1f} ms, training iteration {tools['v2_train_ms']:.1f} ms; on {smi}")
    log(f"[summary] phase seconds {json.dumps(seconds)}")
    log(f"[summary] chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
