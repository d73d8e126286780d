"""SECONDFPN image neck: per-stage deblocks (deconv/conv + BN + ReLU), concat.

Counterpart of coocc_tpu/nn/second_fpn.py. deblock rules
(mmdet3d second_fpn.py:45-62): stride >= 1 -> deconv(k=s, s); stride < 1 ->
conv(k=round(1/s), s=round(1/s)). The deblock BN uses eps 1e-3 and
momentum 0.01.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import BatchNorm, Conv2d, ConvTranspose2d


class SECONDFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int],
                 upsample_strides: Sequence[float]):
        super().__init__()
        deblocks = []
        for cin, cout, s in zip(in_channels, out_channels, upsample_strides):
            if s >= 1:
                k = int(round(s))
                up = ConvTranspose2d(cin, cout, k, k, bias=False)
            else:
                k = int(round(1.0 / s))
                up = Conv2d(cin, cout, k, k, bias=False)
            deblocks.append(nn.Sequential(
                up, BatchNorm(cout, eps=1e-3, momentum=0.01), nn.ReLU()))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, feats):
        ups = [d(f) for d, f in zip(self.deblocks, feats)]
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
