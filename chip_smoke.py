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
  5. the slice: bevformer_base (R101-DCN, 6 x 928 x 1600, fp32) with seeded
     weights runs a 4-frame synthetic video through
     `VideoEvaluator.run` (frames 0-2 one scene, frame 3 a new one). It
     checks 18 K1 and 26 K2 launches per frame and finite outputs. The
     same video through the plain versions: at these weights the kernel
     path stays as close to the plain path as the plain path with fp32-sized
     noise on its msda and DCN outputs does (a witness of how far rounding
     alone moves the outputs); with the reg branches' output layers scaled
     by 0.1, bev_embed, cls and bbox agree to 1e-3;
  6. profile: one frame that carries prev_bev under torch.profiler, its
     device busy share and the ops that take the device time.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Any failure raises and exits nonzero;
without a CUDA device the script exits nonzero at once.
"""

from __future__ import annotations

import json
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

K1_TOL = 1e-5  # max abs error on N(0, 1) values and softmaxed weights
K2_TOL = 1e-4  # max abs error over max |plain|: fp32 sums of 9*C terms
SLICE_TOL = 1e-3  # max abs error over max |plain| of bev_embed, cls, bbox
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
def plain_kernels(noise: float = 0.0, seed: int = 0):
    """Route the model's two kernel call sites to the plain versions. With
    `noise`, each output is multiplied by (1 + noise * N(0, 1)): a
    perturbation of the size of a few fp32 roundings."""
    import torch
    from bevformer_torch.kernels import dcn, msda
    from bevformer_torch.models import attention, resnet

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def perturbed(fn):
        def call(*args):
            out = fn(*args)
            if noise:
                out = out + out * torch.randn(
                    out.shape, generator=gen, device=out.device) * noise
            return out
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
    msda.ms_deform_attn.launches = 0
    dcn.dcn_conv.launches = 0
    results, preds, secs = run_video(model, video)
    k1, k2 = msda.ms_deform_attn.launches, dcn.dcn_conv.launches
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[slice] launches: K1 {k1} ({k1 / n:g}/frame), K2 {k2} ({k2 / n:g}/frame)")
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


def profile_frame(model, video, smi):
    """One frame that carries prev_bev (frame 2 of the first scene) under
    torch.profiler: wall time, device kernel time, and the ops that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bevformer_torch.runtime import VideoEvaluator

    ev = VideoEvaluator(model)
    ev.infer_frame(video.get_test_sample(0))
    ev.infer_frame(video.get_test_sample(1))
    sample = video.get_test_sample(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.infer_frame(sample)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, "the profiled frame ran nothing on the device")
    # device time by the aten op that launched it; the port's kernels are
    # launched through ctypes, under no aten op
    rows = [
        (a.key, a.self_device_time_total / 1e3, a.count)
        for a in prof.key_averages()
        if a.self_device_time_total > 0
        and (a.key.startswith("aten::") or "msda_fwd_kernel" in a.key
             or "dcn_conv_fwd_kernel" in a.key)
    ]
    rows.sort(key=lambda r: -r[1])
    log(f"[profile] frame 2: wall {wall_ms:.2f} ms (profiler on), device kernel time "
        f"{busy_ms:.2f} ms in {len(kernels)} kernels, busy {busy_ms / wall_ms:.1%}, "
        f"idle {1 - busy_ms / wall_ms:.1%}; card: {smi}")
    for name, ms, count in rows[:PROFILE_ROWS]:
        log(f"[profile]   {ms:9.3f} ms {ms / busy_ms:6.1%} {count:5d} calls  {name[:70]}")


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
    torch.cuda.empty_cache()
    sl = check_slice(device, smi)
    profile_frame(sl["model"], sl["video"], smi)

    def record(name, src, replaces, launches, rows):
        return dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            # one frame's worth of launches at the path's shapes
            ms=sum(r["ms"] * r["per_frame"] for r in rows),
            plain_ms=sum(r["plain_ms"] * r["per_frame"] for r in rows),
            shapes=rows,
        )

    kernels = [
        record("msda_fwd", "bevformer_torch/csrc/msda_fwd.cu",
               "bevformer_tpu/kernels/msda_hi.py:243", sl["k1"], k1_rows),
        record("dcn_conv_fwd", "bevformer_torch/csrc/dcn_conv_fwd.cu",
               "bevformer_tpu/kernels/dcn_pallas.py:329", sl["k2"], k2_rows),
    ]
    log(f"[summary] frame median {sl['median_ms']:.1f} ms, peak {sl['peak_gib']:.2f} GiB "
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
