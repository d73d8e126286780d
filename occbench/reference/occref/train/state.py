"""AdamW + global-norm clip + step LR, the JAX package's optimizer.

Counterpart of coocc_tpu/train/state.py `make_optimizer` (reference
coocc_multi_r50_256x704.py:263-288 + mmcv's DefaultOptimizerConstructor):
optax.chain(clip_by_global_norm(5), adamw(lr 1e-4 on a step schedule,
betas (0.9, 0.999), eps 1e-8, weight decay 0.01 on the parameters with
ndim >= 2 only)).

Two traps the port avoids:
  * the clip is optax's, written out: g stays as it is while the global
    norm is below max_norm, else becomes (g / norm) * max_norm. torch's
    clip_grad_norm_ scales by max_norm / (norm + 1e-6) and always;
  * a parameter without a gradient (unused by the forward, as the LiDAR
    stem's spconv weight is) gets a zero one, so AdamW still decays it as
    optax does with its zero gradient; torch.optim skips it otherwise.
The step schedule is optax.piecewise_constant_schedule: the rate of update
number `count` (0 for the first) is lr times gamma for every boundary
int(epoch * steps_per_epoch) <= count.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch

from ..config.base import OptimConfig


def step_lr(cfg: OptimConfig, steps_per_epoch: int):
    """count -> the factor on cfg.lr."""
    bounds = [int(e * steps_per_epoch) for e in cfg.lr_step_epochs]

    def factor(count: int) -> float:
        f = 1.0
        for b in bounds:
            if count >= b:
                f *= cfg.lr_step_gamma
        return f
    return factor


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on a list of gradients, in place, without
    a host sync; -> the global norm (before clipping)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, max_norm * one, one))
    return norm


class Optimizer:
    """clip -> AdamW -> LR schedule, one `step()` per update."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 cfg: OptimConfig, steps_per_epoch: int):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.params = [p for _, p in named]
        decay = [p for _, p in named if p.ndim >= 2]
        rest = [p for _, p in named if p.ndim < 2]
        self.adamw = torch.optim.AdamW(
            [{"params": decay, "weight_decay": cfg.weight_decay},
             {"params": rest, "weight_decay": 0.0}],
            lr=cfg.lr, betas=tuple(cfg.betas), eps=cfg.eps)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, step_lr(cfg, steps_per_epoch))
        self.max_norm = cfg.grad_clip_norm

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """One update from the gradients in .grad; -> their global norm."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in self.params],
                                    self.max_norm)
        self.adamw.step()
        self.schedule.step()
        return norm

    def state_dict(self) -> dict:
        """AdamW's moments and step counts and the schedule's count (JAX
        keeps both in the TrainState's opt_state): a restored optimizer
        continues the run's rates and moments."""
        return {"adamw": self.adamw.state_dict(),
                "schedule": self.schedule.state_dict()}

    def load_state_dict(self, state: dict):
        self.adamw.load_state_dict(state["adamw"])
        # AdamW (not capturable) counts its steps on the host; a count
        # restored onto the card would cost a sync per parameter per update
        for s in self.adamw.state.values():
            s["step"] = s["step"].cpu()
        self.schedule.load_state_dict(state["schedule"])


def make_optimizer(model: torch.nn.Module, cfg: OptimConfig,
                   steps_per_epoch: int) -> Optimizer:
    return Optimizer(model.named_parameters(), cfg, steps_per_epoch)
