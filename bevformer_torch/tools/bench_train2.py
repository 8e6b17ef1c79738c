"""Gradient times of the parts of a v1 training step on one card: the JAX
package's `tools/bench_train2.py`.

    python3 -m bevformer_torch.tools.bench_train2 [config] [cases]
        [--reps 2] [--dtype ...] [--cfg-options key=val ...]

The config (default bevformer_tiny) with seeded weights in train mode
(dropout and GridMask on, the frozen stages frozen as `Trainer` freezes
them, `use_remat` on as in the JAX tool), on one seeded
`data.synth.train_batch`; each case is a loss's forward and backward (no
optimizer step) on the batch's last frame:
  `backbone`  backbone + neck, the sum of the levels' means;
  `bev`       BEV only (`only_bev`: backbone, neck, encoder; no history),
              the BEV's mean;
  `bev1`      the same with one encoder layer (the first layer's weights);
  `full`      the training loss `runtime/train.py::loss_fn` (the history
              frames without gradient, the scipy matcher).
Default `backbone bev full`, as JAX's. One call warms up; then each of
`--reps` is timed between CUDA events with the card idle before it. Prints
one JSON line: each case's median, spread, loss and kernel launches per
call (`cases`), the peak device memory, the dtype, TF32 flags and the card.
Without a card it raises.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional, Sequence

import torch

from bevformer_torch.data import train_batch
from bevformer_torch.device import precision
from bevformer_torch.runtime.train import loss_fn
from bevformer_torch.tools import common

CASES = ("backbone", "bev", "bev1", "full")
DEFAULT_CASES = ("backbone", "bev", "full")
ENCODER = "pts_bbox_head.transformer.encoder.layers."


def parser(description: str, config: str, cases: Sequence[str]) -> argparse.ArgumentParser:
    ap = common.bench_parser(description, config)
    ap.add_argument("cases", nargs="*", choices=cases, metavar="case",
                    help=f"cases: {', '.join(cases)}")
    ap.add_argument("--reps", type=int, default=2, help="timed calls of each case")
    return ap


def last_frame(batch):
    """(images, can_bus, lidar2img) of the batch's last frame."""
    return batch.images[:, -1], batch.can_bus[:, -1], batch.lidar2img[:, -1]


def no_history(model, batch):
    """A zero prev_bev and a false has_prev for the batch."""
    c, bs = model.cfg, batch.images.shape[0]
    dev = batch.images.device
    return (torch.zeros((bs, c.bev_h * c.bev_w, c.embed_dims), device=dev),
            torch.zeros((bs,), dtype=torch.bool, device=dev))


def backbone_loss(model, batch) -> torch.Tensor:
    """Backbone + neck on the last frame: the sum of the levels' means."""
    return sum(f.float().mean() for f in model.extract_feat(batch.images[:, -1]))


def bev_loss(model, batch) -> torch.Tensor:
    """BEV only on the last frame, without history: the BEV's mean."""
    return model(*last_frame(batch), *no_history(model, batch), only_bev=True).float().mean()


def head_loss(model, batch) -> torch.Tensor:
    """The head's outputs on the last frame, without history and without a
    match: the mean of every layer's class scores plus that of its boxes."""
    preds = model(*last_frame(batch), *no_history(model, batch))
    return preds["all_cls_scores"].float().mean() + preds["all_bbox_preds"].float().mean()


def full_loss(model, batch) -> torch.Tensor:
    return loss_fn(model, batch)[0]


def shallower(model, cfg, layers: int, device):
    """A train-mode copy of `model` with its first `layers` encoder layers."""
    sd = {k: v for k, v in model.state_dict().items()
          if not (k.startswith(ENCODER) and int(k[len(ENCODER):].split(".")[0]) >= layers)}
    from bevformer_torch.runtime import build_model

    return common.frozen_as_trainer(build_model(cfg.replace(encoder_layers=layers), sd, device))


def time_grads(calls: Dict[str, Callable[[], torch.Tensor]], reps: int, device, dtype: str):
    """{case: (Timing, the last loss)} of each gradient call."""
    out = {}
    for name, call in calls.items():
        last = {}

        def timed(call=call):
            last["loss"] = call()

        with precision(dtype, device.type):
            timing = common.time_calls(timed, reps, device)
        out[name] = (timing, float(last["loss"]))
    return out


def record(tool: str, what: str, args, cfg, results, device, head: str) -> dict:
    cases = {k: dict(t.fields(), loss=loss) for k, (t, loss) in results.items()}
    return common.json_line(
        f"{args.config} {cfg.dtype} {what} (use_remat {cfg.use_remat}; value: {head}; "
        f"{common.where(device)})",
        results[head][0].median, "ms", None, device=device, dtype=cfg.dtype,
        timing=results[head][0], tool=tool, config=args.config, use_remat=cfg.use_remat,
        reps=args.reps, cases=cases)


def run(args, device) -> dict:
    cases = args.cases or list(DEFAULT_CASES)
    cfg = common.tool_config(args.config, args.cfg_options, args.dtype, use_remat=True)
    model = common.train_model(cfg, device)
    batch = train_batch(cfg, seed=0, device=device)
    losses = dict(backbone=backbone_loss, bev=bev_loss, bev1=bev_loss, full=full_loss)
    calls = {}
    common.reset_peak(device)
    for name in cases:
        m = shallower(model, cfg, 1, device) if name == "bev1" else model
        calls[name] = common.grad_step(m, lambda m=m, f=losses[name]: f(m, batch))
    results = time_grads(calls, args.reps, device, cfg.dtype)
    return record("bench_train2", "training gradients by part", args, cfg, results, device,
                  "full" if "full" in results else cases[-1])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser("Gradient times of the parts of the port's v1 training step",
                  "bevformer_tiny", CASES).parse_args(argv)
    return run(args, common.require_cuda())


if __name__ == "__main__":
    main()
