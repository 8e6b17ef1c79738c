"""Bisect a v1 training step's time on one card: the JAX package's
`tools/bench_train_bisect.py`, its `finer` stage included.

    python3 -m bevformer_torch.tools.bench_train_bisect [config] [cases]
        [--finer] [--reps 2] [--dtype ...] [--cfg-options ...]

The config (default bevformer_tiny) with seeded weights in train mode
(dropout and GridMask on, the frozen stages frozen as `Trainer` freezes
them, `use_remat` on as in the JAX tool), on one seeded
`data.synth.train_batch`. The cases (`bench_train2`'s losses; each a
forward and backward with no optimizer step unless said otherwise):
  `loss`              the training loss `loss_fn`, forward only, no gradient;
  `head`              the last frame's head outputs without history and
                      without a match (the mean of the class scores plus
                      that of the boxes);
  `encoder`           BEV only on the last frame, without history;
  `encoder_no_remat`  the same with `use_remat` off;
  `full`              the training loss (history, the scipy matcher);
  `match_cost`        the matching costs of every decoder layer on the
                      card (`core/assigner.py::match_cost`), no gradient;
  `match_assign`      their one transfer to the host and scipy's
                      assignment per layer (`assign_costs`): the port's
                      form of the JAX tool's "no hungarian" split;
and with `--finer` (JAX's `finer`): `backbone` (backbone + neck only),
`encoder_1_layer` (BEV only at one encoder layer) and
`encoder_no_grid_mask` (BEV only, GridMask off). JAX's "fused OFF" case
has no counterpart: the port has one msda path. One call warms up; then
each of `--reps` is timed between CUDA events with the card idle before it.
Prints one JSON line: each case's median, spread, loss and kernel launches
per call (`cases`), the peak device memory, the dtype, TF32 flags and the
card. Without a card it raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bevformer_torch.core.assigner import assign_costs, match_cost
from bevformer_torch.data import train_batch
from bevformer_torch.device import precision
from bevformer_torch.runtime.train import history_bev
from bevformer_torch.tools import common
from bevformer_torch.tools.bench_train2 import (
    backbone_loss,
    bev_loss,
    full_loss,
    head_loss,
    last_frame,
    parser,
    record,
    shallower,
    time_grads,
)

CASES = ("loss", "head", "encoder", "encoder_no_remat", "full", "match_cost", "match_assign")
FINER = ("backbone", "encoder_1_layer", "encoder_no_grid_mask")


def matching(model, batch):
    """(the matching costs [layers, B, Q, G] of the trained frame's decoder
    outputs, as `bevformer_loss` builds them, and a call that rebuilds
    them), no gradient."""
    c = model.cfg
    with torch.no_grad(), precision(c.dtype, batch.images.device.type):
        prev, has = history_bev(model, batch)
        preds = model(*last_frame(batch), prev, has)

    def costs():
        with torch.no_grad():
            return torch.stack([
                match_cost(preds["all_cls_scores"][i], preds["all_bbox_preds"][i],
                           batch.gt_boxes, batch.gt_labels, batch.num_gt,
                           cls_weight=c.cls_loss_weight, bbox_weight=c.bbox_loss_weight,
                           focal_alpha=c.focal_alpha, focal_gamma=c.focal_gamma)
                for i in range(preds["all_cls_scores"].shape[0])])
    return costs(), costs


def run(args, device) -> dict:
    cases = args.cases or list(FINER if args.finer else CASES)
    cfg = common.tool_config(args.config, args.cfg_options, args.dtype, use_remat=True)
    model = common.train_model(cfg, device)
    batch = train_batch(cfg, seed=0, device=device)
    common.reset_peak(device)

    def grad(m, loss):
        return common.grad_step(m, lambda: loss(m, batch))

    def variant(**fields):
        return common.train_model(cfg.replace(**fields), device)

    def forward_loss():
        with torch.no_grad():
            return full_loss(model, batch)

    makers = dict(
        loss=lambda: forward_loss,
        head=lambda: grad(model, head_loss),
        encoder=lambda: grad(model, bev_loss),
        encoder_no_remat=lambda: grad(variant(use_remat=False), bev_loss),
        full=lambda: grad(model, full_loss),
        backbone=lambda: grad(model, backbone_loss),
        encoder_1_layer=lambda: grad(shallower(model, cfg, 1, device), bev_loss),
        encoder_no_grid_mask=lambda: grad(variant(use_grid_mask=False), bev_loss),
    )
    if "match_cost" in cases or "match_assign" in cases:
        costs, rebuild = matching(model, batch)
        makers.update(match_cost=lambda: lambda: rebuild().sum(),
                        match_assign=lambda: lambda: assign_costs(costs, batch.num_gt).sum())
    results = time_grads({name: makers[name]() for name in cases}, args.reps, device,
                         cfg.dtype)
    head = "full" if "full" in results else cases[-1]
    return record("bench_train_bisect", "training step bisected", args, cfg, results, device,
                  head)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = parser("Bisect the port's v1 training step", "bevformer_tiny", CASES + FINER)
    ap.add_argument("--finer", action="store_true",
                    help="the second stage: backbone only, one encoder layer, GridMask off")
    args = ap.parse_args(argv)
    return run(args, common.require_cuda())


if __name__ == "__main__":
    main()
