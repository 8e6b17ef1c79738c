"""VoVNet-99 on the card, by how its convolutions are computed: as the
module computes them, outside cuDNN forward and backward (`native`: its
`NativeConv2d`), and in cuDNN (each conv bound here to `nn.Conv2d`'s own
forward) by its heuristics (what `nn.Conv2d` gets by default) or by its
autotuner (`torch.backends.cudnn.benchmark`); each an eval forward, fp32
with TF32 off, on the 6 x 3 x 640 x 1600 batch of `chip_smoke.py` phase 19
in channels-last memory. `train`: the module with BatchNorm (V2-99
fine-tuning) in train mode, one forward and backward of the same batch,
with the aten conv ops that ran in it (`torch.profiler`). Then, in cuDNN by
its heuristics, each conv shape's time in one forward (CUDA events around
each conv).

    python3 -m bevformer_torch.tools.bench_vovnet [modes] [--reps 2]

Prints one JSON line per mode (`ms`: the fastest of `--reps` after a
warm-up; `peak_gib`) and one per conv shape (the SHAPES slowest).
Without a card it raises.
"""

from __future__ import annotations

import argparse
import collections
import json
from typing import List, Optional, Sequence

import torch

from bevformer_torch.tools.common import card_line, require_cuda

BATCH = (6, 640, 1600, 3)  # NHWC, permuted to NCHW channels-last as the detectors do
MODES = ("native", "heuristics", "benchmark", "train")
SHAPES = 12  # conv shapes reported, the slowest first


def in_cudnn(model) -> None:
    """Bind every conv of `model` to `nn.Conv2d`'s own forward, which takes
    cuDNN where the global flags allow it."""
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.forward = torch.nn.Conv2d.forward.__get__(mod)


def _best_ms(step, reps: int):
    """The fastest of `reps` calls of `step` after a warm-up (CUDA events),
    and the peak over them."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return min(times), torch.cuda.max_memory_allocated() / 2**30


def conv_ops(step) -> dict:
    """{aten op name: calls} of the conv ops that one call of `step` ran
    (the host-side events of `torch.profiler`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
        torch.cuda.synchronize()
    counts = collections.Counter(e.name for e in prof.events() if "conv" in e.name)
    return dict(sorted(counts.items()))


def conv_shapes(model, x) -> dict:
    """{(cin, cout, k, stride, (h, w)): [ms of each call]} over one forward."""
    stats, hooks = {}, []

    def pre(mod, inp):
        mod._t0 = torch.cuda.Event(enable_timing=True)
        mod._t0.record()

    def post(mod, inp, out):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        key = (mod.in_channels, mod.out_channels, mod.kernel_size[0], mod.stride[0],
               tuple(inp[0].shape[2:]))
        stats.setdefault(key, []).append(mod._t0.elapsed_time(end))

    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return stats


def run(modes, reps: int, device, smi) -> List[dict]:
    from bevformer_torch.models.vovnet import VoVNet

    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(BATCH, generator=gen).to(device).permute(0, 3, 1, 2)
    records = []

    def emit(rec):
        records.append(dict(rec, card=smi))
        print(json.dumps(records[-1]), flush=True)

    for mode in modes:
        torch.manual_seed(0)
        if mode == "train":
            model = VoVNet(out_indices=(1, 2, 3), norm="bn").to(device).train()

            def step():
                model.zero_grad(set_to_none=True)
                sum(o.float().mean() for o in model(x)).backward()
        else:
            model = VoVNet(out_indices=(1, 2, 3)).to(device).eval()
            if mode != "native":
                in_cudnn(model)

            def step():
                with torch.no_grad():
                    model(x)
        with torch.backends.cudnn.flags(enabled=True, benchmark=mode == "benchmark",
                                        deterministic=False, allow_tf32=False):
            ms, peak = _best_ms(step, reps)
            rec = dict(case=f"vovnet99 {mode}", ms=ms, peak_gib=peak)
            if mode == "train":
                rec["conv_ops"] = conv_ops(step)
        emit(rec)
        del model
        torch.cuda.empty_cache()

    model = VoVNet(out_indices=(1, 2, 3)).to(device).eval()
    in_cudnn(model)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        stats = conv_shapes(model, x)
    total = sum(sum(v) for v in stats.values())
    for key, ms in sorted(stats.items(), key=lambda kv: -sum(kv[1]))[:SHAPES]:
        cin, cout, k, stride, hw = key
        flops = 2 * k * k * cin * cout * x.shape[0] * (hw[0] // stride) * (hw[1] // stride)
        emit(dict(case="conv", cin=cin, cout=cout, k=k, stride=stride, hw=list(hw),
                  calls=len(ms), ms=sum(ms), share=sum(ms) / total,
                  TFLOP_per_s=flops * len(ms) / (sum(ms) * 1e9)))
    return records


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("modes", nargs="*", choices=MODES, metavar="mode",
                   help=f"modes (default all): {', '.join(MODES)}")
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)
    device = require_cuda()
    smi = card_line()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return run(args.modes or MODES, args.reps, device, smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


if __name__ == "__main__":
    main()
