"""Noisy top-k gated mixture-of-experts layer.

Counterpart of coocc_tpu/nn/moe.py (reference utils/moe.py:1-282, noisy
top-k gating after Shazeer et al.): every expert (fc1, ReLU, fc2) runs
densely and the gate mixes their outputs. The gate keeps the logits at or
above the k-th largest (`logits >= kth`, so ties past k stay in, as JAX's
sort-based gate keeps them), a softmax over those. In training the gate's
logits take softplus(w_noise(x)) times a standard normal draw: `noise`
where the caller passes it, else drawn from the module's `generator`
(None: torch's default). No CoOccRay route reaches it, in JAX or here.
The parameters are named after JAX's scopes: w_gate, w_noise, and the
experts' stacked experts.fc1 / experts.fc2 ([E, out, in] weights,
[E, out] biases; `convert.module_state_dict_from_jax`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .layers import Linear, softmax
from .lss_stereo import softplus


class _StackedLinear(nn.Module):
    """E linear layers at once: weight [E, out, in], bias [E, out]."""

    def __init__(self, experts: int, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(experts, cout, cin))
        self.bias = nn.Parameter(torch.zeros(experts, cout))


class MoE(nn.Module):
    def __init__(self, in_features: int, num_experts: int = 4, k: int = 2,
                 hidden: int = 256, out_features: int = 128,
                 noisy_gating: bool = True):
        super().__init__()
        self.k = k
        self.w_gate = Linear(in_features, num_experts, bias=False)
        self.w_noise = Linear(in_features, num_experts, bias=False) \
            if noisy_gating else None
        self.experts = nn.Module()
        self.experts.fc1 = _StackedLinear(num_experts, in_features, hidden)
        self.experts.fc2 = _StackedLinear(num_experts, hidden, out_features)
        self.generator = None

    def forward(self, x: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [..., C] -> [..., out_features]; noise (training): the
        standard normal draw [..., E]."""
        logits = self.w_gate(x)
        if self.w_noise is not None and self.training:
            if noise is None:
                noise = torch.randn(logits.shape, generator=self.generator,
                                    device=logits.device,
                                    dtype=logits.dtype)
            logits = logits + softplus(self.w_noise(x)) * noise
        kth = torch.sort(logits, dim=-1).values[..., -self.k, None]
        gates = softmax(torch.where(logits >= kth, logits,
                                    torch.full_like(logits, -torch.inf)), -1)
        dt = x.dtype
        fc1, fc2 = self.experts.fc1, self.experts.fc2
        h = torch.relu(torch.einsum("...c,ehc->...eh", x, fc1.weight.to(dt))
                       + fc1.bias.to(dt))
        out = torch.einsum("...eh,eoh->...eo", h, fc2.weight.to(dt)) \
            + fc2.bias.to(dt)
        return torch.einsum("...e,...eo->...o", gates, out)
