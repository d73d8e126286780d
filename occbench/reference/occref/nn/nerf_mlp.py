"""NeRF-style MLP heads of the rendering regularizer.

Counterpart of coocc_tpu/nn/nerf_mlp.py (reference utils/nerf_mlp.py:14-105
as COOCC_Ray instantiates it, coocc_ray.py:111-113): `net_depth` hidden
Linear(width 256) + ReLU layers and a Linear output, no skip connections,
with the reference checkpoint's names (hidden_layers.{i}, output_layer).
The layers compute in the input's dtype (nn/layers.py:Linear), as flax's
Dense with the model's dtype does.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from .layers import Linear


class NeRFMLP(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, net_depth: int,
                 net_width: int = 256):
        super().__init__()
        dims = [input_dim] + [net_width] * net_depth
        self.hidden_layers = nn.ModuleList(
            Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.output_layer = Linear(dims[-1], output_dim)

    def forward(self, x):
        for layer in self.hidden_layers:
            x = F.relu(layer(x))
        return self.output_layer(x)
