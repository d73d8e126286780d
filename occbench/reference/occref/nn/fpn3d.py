"""FPN3D neck: lateral 1x1x1 convs + trilinear top-down + 3x3x3 fpn convs.

Counterpart of coocc_tpu/nn/fpn3d.py (reference necks/fpn3d.py:14-108).
The top-down upsampling is JAX's resize_linear op for op, in the axis
order of its z-batch layout (ops/interpolate.py:resize_trilinear_zxy:
F.interpolate's trilinear semantics, align_corners=False). Where a ratio
is not an integer (the flagship's 13 -> 25) it promotes a bf16 lateral to
fp32, as JAX's does, and the sums below it stay fp32; each fpn conv takes
its input in the laterals' compute dtype, as flax's Conv with `dtype`
casts it. With `with_cp` (the config's
neck_with_cp) each ConvModule3d runs under torch.utils.checkpoint in
training, as JAX wraps it in nn.remat (coocc_ray.py:304): the backward
recomputes it, and the recomputation leaves the BN's running statistics
where the forward moved them.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.interpolate import resize_trilinear_zxy
from .layers import BatchNorm, Conv3d


class ConvModule3d(nn.Module):
    """mmcv ConvModule(conv, bn, relu) with its child names."""

    def __init__(self, cin: int, cout: int, k: int, p: int,
                 with_cp: bool = False):
        super().__init__()
        self.conv = Conv3d(cin, cout, k, 1, p, bias=False)
        self.bn = BatchNorm(cout)
        self.with_cp = with_cp

    def forward(self, x):
        if not (self.with_cp and self.training and torch.is_grad_enabled()):
            return F.relu(self.bn(self.conv(x)))
        runs = []

        def run(x):
            runs.append(None)
            return F.relu(self.bn(self.conv(x), update_stats=len(runs) == 1))
        return checkpoint(run, x, use_reentrant=False)


class FPN3D(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 with_cp: bool = False):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            nn.Sequential(ConvModule3d(c, out_channels, 1, 0, with_cp))
            for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            nn.Sequential(ConvModule3d(out_channels, out_channels, 3, 1,
                                       with_cp))
            for _ in in_channels)

    def forward(self, inputs):
        laterals = [m(x) for m, x in zip(self.lateral_convs, inputs)]
        dtype = laterals[0].dtype
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_trilinear_zxy(
                laterals[i], laterals[i - 1].shape[2:])
        return tuple(m(x.to(dtype)) for m, x in zip(self.fpn_convs, laterals))
