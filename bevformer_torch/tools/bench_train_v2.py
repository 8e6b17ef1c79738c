"""Time BEVFormerV2's training forward and backward on one card: the JAX
package's `tools/bench_train_v2.py`.

    python3 -m bevformer_torch.tools.bench_train_v2 [config] [--iters 2]
        [--dtype ...] [--cfg-options key=val ...]

The loss of `runtime/train_v2.py::loss_fn_v2` (the history frames without
gradient; the current frame in train mode: GridMask, dropout, BatchNorm on
batch statistics, GroupDETR, the DD3D head on) and its backward, with no
optimizer step and the frozen stages frozen as `Trainer` freezes them, for
a V2 config (default bevformerv2-r50-t1) with seeded weights on one
seeded `data.synth.train_batch_v2` at the rung of the resize ladder that the
config's `img_size` gives (640 for the V2 presets: 6 x 640 x 1600), as the
JAX tool sizes it. `use_remat` is on, as in the JAX tool. One iteration
warms up; then each of `--iters` is timed between CUDA events with the
card idle before it. Prints one JSON line: the median
ms an iteration, the spread, the loss, the peak device memory, the kernel
launches per iteration, the dtype, TF32 flags and the card. Without a card
it raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

from bevformer_torch.data.synth import train_batch_v2
from bevformer_torch.device import precision
from bevformer_torch.runtime.train_v2 import loss_fn_v2
from bevformer_torch.tools import common


def parse_args(argv):
    ap = common.bench_parser("Time the port's BEVFormerV2 training forward and backward",
                             "bevformerv2-r50-t1")
    ap.add_argument("--iters", type=int, default=2, help="timed iterations, after one warm-up")
    return ap.parse_args(argv)


def run(args, device) -> dict:
    cfg = common.tool_config(args.config, args.cfg_options, args.dtype, use_remat=True)
    model = common.train_model(cfg, device)
    rung = cfg.data.img_size[0]
    batch = train_batch_v2(cfg, seed=0, device=device, rung=rung)
    step = common.grad_step(model, lambda: loss_fn_v2(model, batch)[0])
    out = {}

    def iteration():
        out["loss"] = step()

    common.reset_peak(device)
    with precision(cfg.dtype, device.type):
        timing = common.time_calls(iteration, args.iters, device)
    return common.json_line(
        f"{args.config} {cfg.dtype} training forward + backward (loss_fn_v2, DD3D on, rung "
        f"{rung}, use_remat {cfg.use_remat}; {common.where(device)})", timing.median,
        "ms/iter", None, device=device, dtype=cfg.dtype, timing=timing, tool="bench_train_v2",
        config=args.config, rung=rung, use_remat=cfg.use_remat, iters=args.iters,
        loss=float(out["loss"]), images=list(batch.images.shape))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    return run(args, common.require_cuda())


if __name__ == "__main__":
    main()
