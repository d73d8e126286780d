"""CustomResNet3D semantic voxel encoder (NCDHW inside).

Counterpart of coocc_tpu/nn/resnet3d.py (reference backbones/resnet3d.py:
106-205): 1x1x1 input projection, 4 stages of BasicBlock3D (depth 18: 2
blocks each) with strides (1, 2, 2, 2), multi-scale outputs. The JAX
package's z-batch layouts compute the same Conv3d; here it is cuDNN's.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm

RESNET3D_LAYERS = {10: (1, 1, 1, 1), 18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


class BasicBlock3D(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv3d(cin, planes, 1, stride, bias=False),
                BatchNorm(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class CustomResNet3D(nn.Module):
    """[B, C, X, Y, Z] -> tuple of per-stage [B, C_i, X/s, Y/s, Z/s]."""

    def __init__(self, cin: int, depth: int = 18,
                 block_inplanes: Sequence[int] = (128, 256, 512, 1024),
                 block_strides: Sequence[int] = (1, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.input_proj = nn.Sequential(
            nn.Conv3d(cin, block_inplanes[0], 1, 1, bias=False),
            BatchNorm(block_inplanes[0]), nn.ReLU())
        self.layers = nn.ModuleList()
        in_planes = block_inplanes[0]
        for i, planes in enumerate(block_inplanes):
            blocks = [BasicBlock3D(in_planes, planes, block_strides[i])]
            blocks += [BasicBlock3D(planes, planes)
                       for _ in range(1, RESNET3D_LAYERS[depth][i])]
            in_planes = planes
            self.layers.append(nn.Sequential(*blocks))

    def forward(self, x):
        x = self.input_proj(x)
        outs = []
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
