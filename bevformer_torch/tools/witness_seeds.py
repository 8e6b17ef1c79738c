"""The training witness of `chip_smoke.py` (its phase 9) at several batch
seeds, from the repository root on a card:

    python -m bevformer_torch.tools.witness_seeds 0 1 2 3

For each seed, undamped and with the reg branches' outputs x0.1, one JSON
line: kernel vs plain and noisy plain vs plain per gradient group, and what
the witness would refuse (`chip_smoke.witness_failures`). At random weights
some batches put a switch (a ReLU input, a bilinear sample's pixel edge)
within fp32 rounding of its edge, and there any two fp32 computations of
the gradients part by the switch's jump: the noisy path's own errors then
pass the witness's limit. This survey is how `chip_smoke.WITNESS_BATCH_SEED`
was chosen, and how a change of the kernels' rounding is checked against
more than one batch.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional, Sequence

import torch

from bevformer_torch.tools import common

TOOL = "witness_seeds"


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    seeds = [int(s) for s in (sys.argv[1:] if argv is None else argv)] or [0, 1, 2, 3]
    device = common.require_cuda()
    import chip_smoke as smoke  # the repository root is the working directory
    from bevformer_torch.data import train_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model = smoke.witness_model(device)
    batches = {s: train_batch(cfg, seed=s, device=device) for s in seeds}
    records = []
    for damped in (False, True):
        if damped:
            smoke.damp_box_refinement(model)
        for seed, batch in batches.items():
            errs, noise_errs, _ = smoke.witness_errors(model, batch, device)
            rec = dict(tool=TOOL, seed=seed, damped=damped, kernel_vs_plain=errs,
                       noisy_vs_plain=noise_errs,
                       refused=smoke.witness_failures(errs, noise_errs, damped),
                       card=common.card_line())
            print(json.dumps(rec), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
