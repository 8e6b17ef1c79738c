"""GridMask image augmentation (training-time structured dropout).

Port of `bevformer_tpu/models/grid_mask.py` (reference
`models/utils/grid_mask.py:70-124`, with the hyper-parameters of
`detectors/bevformer.py:52-53`): use_h = use_w = True, no rotation, no
offset, ratio 0.5, mode 1, prob 0.7. A 1.5x canvas is striped every `d`
pixels with stripes of width l = clip(int(d * ratio + 0.5), 1, d - 1) in
both axes and centre-cropped; mode 1 KEEPS the union of the row and column
stripes. One mask and one coin flip per batch.

The random draws come from an explicit `torch.Generator` (`GridMask.generator`);
the mask itself is the plain function `grid_mask_keep` of the draws.
"""

from __future__ import annotations

import torch
import torch.nn as nn

PROB = 0.7  # chance that a call masks at all
RATIO = 0.5  # stripe width over period


def grid_mask_keep(h: int, w: int, d: int, st_h: int, st_w: int, apply: bool,
                   device=None) -> torch.Tensor:
    """[h, w] float mask: 1 on the union of the row and column stripes (all
    ones when `apply` is false)."""
    if not apply:
        return torch.ones((h, w), device=device)
    l = min(max(int(d * RATIO + 0.5), 1), d - 1)
    hh, ww = int(1.5 * h), int(1.5 * w)

    def in_stripe(n, canvas, st):
        # canvas coordinate n + off; stripes at [d*i + st, d*i + st + l)
        # for 0 <= i < canvas // d
        c = torch.arange(n, device=device) + (canvas - n) // 2 - st
        i = torch.div(c, d, rounding_mode="floor")
        phase = c - i * d
        return (phase < l) & (i >= 0) & (i < canvas // d)

    keep = in_stripe(h, hh, st_h)[:, None] | in_stripe(w, ww, st_w)[None, :]
    return keep.float()


class GridMask(nn.Module):
    """Masks [n, h, w, c] images with one `grid_mask_keep` per call, drawn
    from `generator` (on the host) as the reference draws from numpy."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.generator = torch.Generator().manual_seed(seed)

    def draw(self, h: int):
        """(d, st_h, st_w, apply) as the reference draws them."""
        g = self.generator
        apply = bool(torch.rand((), generator=g) < PROB)
        d = int(torch.randint(2, h, (), generator=g))
        st_h = int(torch.randint(0, 1 << 30, (), generator=g)) % d
        st_w = int(torch.randint(0, 1 << 30, (), generator=g)) % d
        return d, st_h, st_w, apply

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = images.shape
        d, st_h, st_w, apply = self.draw(h)
        keep = grid_mask_keep(h, w, d, st_h, st_w, apply, images.device)
        return images * keep[None, :, :, None].to(images.dtype)
