"""Normalization with the reference's parameter names and eps (eval mode).

Counterpart of coocc_tpu/nn/layers.py. Convolutions, Linear and GroupNorm
are torch's own modules (`nn.Conv2d`, `nn.Conv3d`, `nn.Linear`,
`nn.GroupNorm`); their state_dict names already are the reference
checkpoint's. BatchNorm gets one class here because this slice is the eval
forward only: it always normalizes with the running statistics, and it keeps
no `num_batches_tracked` counter (a counter the JAX variables cannot carry,
so `convert.state_dict_from_jax` round-trips exactly).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1 of [N, C, ...] (1d, 2d and 3d alike).

    eps follows the call site, as in the reference: 1e-5 is torch's and the
    JAX BatchNorm's default; SECONDFPN passes 1e-3.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # reference checkpoints carry torch BN's step counter; eval ignores it
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, eps={self.eps}"
