"""The reference's first train steps, in fp32 with TF32 off.

The step is the port's train step as its documentation states it, written
out over the reference copy: the cascade's priorities drawn uniform from
the step's generator (one per coarse cell), every Dropout drawing from
that generator, the training forward, the losses, the gradient of their
sum, then the optimizer (global-norm clip, AdamW, step LR; occref's
train/state.py). The generator is a CUDA torch.Generator seeded with the
run's seed, drawn from in the same order, so the priorities and dropout
masks are the program's own.

`steps` returns what the comparison reads: each step's loss terms, each
leaf's norm of the first gradient as AdamW holds it after one step
(exp_avg / (1 - beta1)), the norms of each leaf's change after the steps,
and each leaf's first-gradient norm as the rule for leaves the reference
does not move.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import occupancy, weights
from .occref.config import get_config
from .occref.config.tiny import tiny_config
from .occref.models.coocc_ray import Batch, CoOccRay
from .occref.models.losses import compute_losses
from .occref.nn.layers import Dropout
from .occref.train.state import make_optimizer
from .serve import fp32_strict


def adam_first_grads(optimizer, named) -> Dict[str, float]:
    """Each leaf's norm of the gradient AdamW took at its first step,
    worked out from its state: exp_avg / (1 - beta1)."""
    out = {}
    for group in optimizer.adamw.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            st = optimizer.adamw.state.get(p)
            if st and "exp_avg" in st:
                out[id(p)] = float(st["exp_avg"].float().norm()) / (1 - b1)
    return {n: out[id(p)] for n, p in named if id(p) in out}


def steps(config_name: str, seed: int, batches: List[dict], device,
          steps_per_epoch: int, counter_factory=None, prepare=None,
          empty_shift: float = 0.0):
    """The reference's len(batches) steps from the seed's weights, in fp32
    -> (losses [{name: float}], first grads {leaf: norm}, changes {leaf:
    norm}, the digest of the state's names and shapes, the counter
    `counter_factory(model)` installed on the first forward, or None, the
    names of the leaves of two axes or more).
    `prepare(model)`, where given, changes the model once its weights are
    loaded (the control's fp8 rounding); `empty_shift` is weights.draw's.
    The losses of each step also carry the cascade's load (`occupied`,
    `refined`: occupancy.counts)."""
    fp32_strict()
    cfg = tiny_config() if config_name == "tiny" else get_config(config_name)
    with torch.device(device):
        model = CoOccRay(cfg, None)
    weights.load(model.to(device), seed, empty_shift)
    digest = weights.names_digest(model)
    if prepare is not None:
        prepare(model)
    counter = None if counter_factory is None else counter_factory(model)
    model.train()
    opt = make_optimizer(model, cfg.optim, steps_per_epoch)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    start = {n: p.detach().clone() for n, p in named}
    losses, first = [], None
    n_coarse = math.prod(cfg.lss_grid_size)
    for i, b in enumerate(batches):
        batch = Batch(**{k: v.to(device) for k, v in b.items()})
        prio = torch.rand((1, n_coarse), generator=gen, device=device)
        with torch.backends.cudnn.flags(deterministic=True):
            if i == 0 and counter is not None:
                with counter:
                    outs = model(batch, fine_priorities=prio)
            else:
                outs = model(batch, fine_priorities=prio)
            terms = compute_losses(outs, batch, cfg)
            total = sum(v for k, v in terms.items() if k.startswith("loss"))
            opt.zero_grad()
            total.backward()
        load = occupancy.counts(outs, cfg.occ_head.cascade_ratio,
                                cfg.occ_head.empty_idx) if "occ" in outs \
            else {}
        del outs
        losses.append({"loss_total": float(total.detach()),
                       **{k: float(v.detach()) for k, v in terms.items()},
                       **load})
        opt.step()
        if i == 0:
            first = adam_first_grads(opt, named)
    change = {n: float((p.detach() - start[n]).float().norm())
              for n, p in named}
    matrices = {n for n, p in named if p.dim() >= 2}
    del model, opt, start
    return losses, first, change, digest, counter, matrices
