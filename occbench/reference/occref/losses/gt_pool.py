"""Mode-pooling of the ground truth to the coarse grid.

Counterpart of coocc_tpu/losses/gt_pool.py (reference occ_head.py:270-281):
each ratio^3 block becomes the majority of its nonzero labels; an all-empty
block stays 0; a winner needs a count >= 2, else the block is 255; ties go
to the smaller label (torch.mode).
"""
from __future__ import annotations

import torch


def mode_pool_gt(target: torch.Tensor, ratio: int,
                 num_classes: int) -> torch.Tensor:
    """target int [B, X, Y, Z] (0..C-1 and 255) -> [B, X/r, Y/r, Z/r]."""
    if ratio == 1:
        return target
    B, X, Y, Z = target.shape
    x = target.reshape(B, X // ratio, ratio, Y // ratio, ratio,
                       Z // ratio, ratio)
    x = x.permute(0, 1, 3, 5, 2, 4, 6).reshape(
        B, X // ratio, Y // ratio, Z // ratio, ratio ** 3)
    nbins = num_classes + 1          # bin C stands for 255
    lab = torch.where(x == 255, num_classes, x).long()
    counts = (lab[..., None] == torch.arange(nbins, device=x.device)).sum(-2)
    counts[..., 0] = 0               # zeros never win the vote
    maxc = counts.max(-1).values
    winner = (counts == maxc[..., None]).int().argmax(-1)  # smallest max bin
    empty_block = (x == 0).all(-1)
    out = torch.where(empty_block, 0, torch.where(maxc >= 2, winner,
                                                  num_classes))
    out = torch.where(out == num_classes, 255, out)
    return out.to(target.dtype)
