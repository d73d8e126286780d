"""The single-device train step.

Counterpart of coocc_tpu/parallel/train_step.py `make_train_step` with
mesh=None: the training forward (BatchNorm on batch statistics, which it
moves; dropout and the cascade's priorities drawn from `generator`), the
losses, the gradient of their sum, and the optimizer's update (clip,
AdamW, LR schedule; train/state.py). Data parallelism is not ported.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..models.losses import compute_losses
from ..nn.layers import Dropout


def train_step(model, optimizer, batch, generator: torch.Generator
               ) -> Dict[str, torch.Tensor]:
    """One update of `model` (a CoOccRay) on `batch`; `generator` lives on
    the batch's device. -> {"loss_total", every loss term, "grad_norm"}, as
    detached scalars on the device (no host sync)."""
    model.train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    B = batch.gt_occ.shape[0]
    n = math.prod(model.cfg.lss_grid_size)  # the coarse cells
    prio = torch.rand((B, n), generator=generator,
                      device=batch.gt_occ.device)
    outs = model(batch, fine_priorities=prio)
    losses = compute_losses(outs, batch, model.cfg)
    total = sum(v for k, v in losses.items() if k.startswith("loss"))
    optimizer.zero_grad()
    total.backward()
    norm = optimizer.step()
    return {"loss_total": total.detach(),
            **{k: v.detach() for k, v in losses.items()},
            "grad_norm": norm}
