"""Lovasz-softmax loss (per_image=False, classes='present', ignore=255).

Counterpart of coocc_tpu/losses/lovasz.py (reference
dense_heads/lovasz_softmax.py): ignored cells keep their slots with zero
error, which a stable descending sort puts last, where they add nothing.
All classes are sorted at once, each row as JAX's per-class vmap does.
"""
from __future__ import annotations

import torch


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension w.r.t. the sorted errors, per row
    of gt_sorted [C, P]."""
    def cumsum(x):  # XLA's cumsum of bf16 sums in fp32, rounds each prefix
        return torch.cumsum(x, -1, dtype=torch.float32).to(x.dtype)
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - cumsum(gt_sorted)
    union = gts + cumsum(1.0 - gt_sorted)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], -1)


def lovasz_softmax(probs, target, ignore_index=255, classes="present"):
    """probs [..., C] softmax probabilities; target int [...] -> scalar."""
    C = probs.shape[-1]
    p = probs.reshape(-1, C)
    t = target.reshape(-1)
    valid = t != ignore_index
    t_safe = torch.where(valid, t, 0)
    cls = torch.arange(C, device=p.device)[:, None]
    fg = ((t_safe[None] == cls) & valid[None]).to(p.dtype)       # [C, P]
    errors = (fg - p.T).abs() * valid[None]
    order = torch.sort(-errors, dim=-1, stable=True).indices
    errors_sorted = torch.gather(errors, -1, order)
    fg_sorted = torch.gather(fg, -1, order)
    losses = (errors_sorted * _lovasz_grad(fg_sorted)).sum(-1)
    if classes == "present":
        present = fg.sum(-1) > 0
        return (losses * present).sum() / present.sum().clamp(min=1.0)
    return losses.mean()
