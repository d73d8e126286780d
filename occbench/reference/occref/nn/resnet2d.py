"""2D ResNet backbone (torchvision/mmdet 'pytorch' style), NCHW inside.

Counterpart of coocc_tpu/nn/resnet2d.py `ResNet` with the plain 7x7 stem:
depth 10/18 use BasicBlocks, 50/101 Bottlenecks with the stride on the 3x3
conv. Module names are the reference checkpoint's (conv1, bn1,
layer{i}.{j}.{conv1,bn1,...,downsample.0,downsample.1}).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d

RESNET_LAYERS = {10: (1, 1, 1, 1), 18: (2, 2, 2, 2), 34: (3, 4, 6, 3),
                 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _downsample(cin, cout, stride):
    return nn.Sequential(Conv2d(cin, cout, 1, stride, bias=False),
                         BatchNorm(cout))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (_downsample(cin, planes * 4, stride)
                           if stride != 1 or cin != planes * 4 else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class BasicBlock2d(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = (_downsample(cin, planes, stride)
                           if stride != 1 or cin != planes else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """[B, 3, H, W] -> tuple of stage features at strides 4/8/16/32."""

    def __init__(self, depth: int = 50,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        block = Bottleneck if depth >= 50 else BasicBlock2d
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        self.out_channels = []
        for i, n in enumerate(RESNET_LAYERS[depth]):
            planes = 64 * 2 ** i
            blocks = [block(cin, planes, 1 if i == 0 else 2)]
            cin = planes * block.expansion
            blocks += [block(cin, planes) for _ in range(1, n)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            self.out_channels.append(cin)

    def forward(self, x: torch.Tensor, stages: Optional[int] = None):
        """-> the outputs of the stages in out_indices; `stages` runs only
        the first that many stages (the stem included)."""
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for i in range(stages or len(self.out_channels)):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
