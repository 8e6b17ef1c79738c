"""Time a training step on one card: the JAX package's
`tools/bench_train_step.py`.

    python3 -m bevformer_torch.tools.bench_train_step [config] [--steps 3]
        [--no-remat] [--dtype float32|bfloat16] [--cfg-options key=val ...]

`Trainer.step` (the history frames without gradient, the loss with the
scipy matcher, backward, clip, AdamW; train mode: dropout and GridMask on)
of the config (default bevformer_tiny, as JAX's) with seeded weights on one
seeded `data.synth.train_batch` (queue = the config's, 12 GT boxes). The
first step warms up (the JAX tool's compile step); then each of `--steps`
steps is timed between CUDA events with the card idle before it.
`use_remat` is on, as in the JAX tool; `--no-remat` times the step that
`chip_smoke.py` phase 8 times. Prints one JSON line: the median ms a step,
its spread, the last step's loss, the peak device memory, the kernel
launches per step, the dtype, TF32 flags and the card. Without a card it
raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

from bevformer_torch.data import train_batch
from bevformer_torch.device import precision
from bevformer_torch.runtime.train import Trainer
from bevformer_torch.tools import common

TOTAL_STEPS = 1000  # the lr schedule's length (the JAX tool's)


def parse_args(argv):
    ap = common.bench_parser("Time the port's training step", "bevformer_tiny")
    ap.add_argument("--steps", type=int, default=3, help="timed steps, after one warm-up step")
    ap.add_argument("--no-remat", dest="remat", action="store_false",
                    help="use_remat off (the JAX tool turns it on)")
    return ap.parse_args(argv)


def run(args, device) -> dict:
    cfg = common.tool_config(args.config, args.cfg_options, args.dtype, use_remat=args.remat)
    trainer = Trainer(common.seeded_model(cfg, device), TOTAL_STEPS, seed=0)
    batch = train_batch(cfg, seed=0, device=device)
    out = {}

    def step():
        out.update(trainer.step(batch))

    common.reset_peak(device)
    with precision(cfg.dtype, device.type):
        timing = common.time_calls(step, args.steps, device)
    return common.json_line(
        f"{args.config} {cfg.dtype} training step (Trainer.step, queue "
        f"{cfg.data.queue_length}, use_remat {cfg.use_remat}; {common.where(device)})",
        timing.median, "ms/step", None, device=device, dtype=cfg.dtype, timing=timing,
        tool="bench_train_step", config=args.config, use_remat=cfg.use_remat,
        steps=args.steps, loss=out["total"], grad_norm=out["grad_norm"])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    return run(args, common.require_cuda())


if __name__ == "__main__":
    main()
