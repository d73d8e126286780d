"""FPN3D neck: lateral 1x1x1 convs + trilinear top-down + 3x3x3 fpn convs.

Counterpart of coocc_tpu/nn/fpn3d.py (reference necks/fpn3d.py:14-108).
The top-down upsampling is F.interpolate(mode="trilinear",
align_corners=False), the torch semantics the JAX package's
resize_trilinear_chlast re-implements.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv3d


class ConvModule3d(nn.Module):
    """mmcv ConvModule(conv, bn, relu) with its child names."""

    def __init__(self, cin: int, cout: int, k: int, p: int):
        super().__init__()
        self.conv = Conv3d(cin, cout, k, 1, p, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class FPN3D(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            nn.Sequential(ConvModule3d(c, out_channels, 1, 0))
            for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            nn.Sequential(ConvModule3d(out_channels, out_channels, 3, 1))
            for _ in in_channels)

    def forward(self, inputs):
        laterals = [m(x) for m, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[2:],
                mode="trilinear", align_corners=False)
        return tuple(m(x) for m, x in zip(self.fpn_convs, laterals))
