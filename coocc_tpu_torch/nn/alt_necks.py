"""Alternative 2D image necks.

Counterpart of coocc_tpu/nn/alt_necks.py: the reference registers three
image necks no shipped config uses, and no CoOccRay route reaches them,
in JAX or here:

  * SECONDFPN2 (reference coocc/necks/secondfpn.py:12-95): SECONDFPN's
    deblocks returning the per-level list instead of a concat;
  * GeneralizedLSSFPN (generalized_lss.py:13-103): top-down upsample (the
    port's ops/interpolate.py bilinear, align_corners=True, as JAX's
    resize_bilinear_chlast), concat, 1x1 lateral conv, 3x3 fpn conv, each
    conv + BatchNorm + ReLU;
  * FPNRender (fpn_render.py:10-203): mmdet's FPN (1x1 laterals, top-down
    nearest x2 add, 3x3 output convs).

NCHW in and out; the submodules are named after JAX's flax scopes
(`convert.module_state_dict_from_jax`). BatchNorm as JAX's: SECONDFPN's
deblocks eps 1e-3 / momentum 0.01, GeneralizedLSSFPN's the defaults.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interpolate import resize_linear
from .layers import BatchNorm, Conv2d
from .second_fpn import SECONDFPN


class SECONDFPN2(nn.Module):
    """One single-level SECONDFPN per level (deblock{i}), the list back."""

    def __init__(self, in_channels: Sequence[int] = (128, 128, 256),
                 out_channels: Sequence[int] = (256, 256, 256),
                 upsample_strides: Sequence[float] = (1, 2, 4)):
        super().__init__()
        self.upsample_strides = tuple(upsample_strides)
        for i, (ci, oc, s) in enumerate(zip(in_channels, out_channels,
                                            upsample_strides)):
            self.add_module(f"deblock{i}", SECONDFPN([ci], [oc], [s]))

    def forward(self, feats):
        n = len(self.upsample_strides)
        if len(feats) != n:
            raise ValueError(f"{len(feats)} levels, want {n}")
        return tuple(getattr(self, f"deblock{i}")([f])
                     for i, f in enumerate(feats))


class _ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, 1, k // 2, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class GeneralizedLSSFPN(nn.Module):
    """For each level i from the second-coarsest down: level i+1 (as
    updated) resized to level i's size, concatenated, lateral{i} (1x1),
    fpn{i} (3x3); all levels but the coarsest back."""

    def __init__(self, in_channels: Sequence[int] = (192, 384, 768),
                 out_channels: int = 256):
        super().__init__()
        n = len(in_channels) - 1
        for i in range(n - 1, -1, -1):
            above = in_channels[i + 1] if i == n - 1 else out_channels
            self.add_module(f"lateral{i}", _ConvBNReLU(
                in_channels[i] + above, out_channels, 1))
            self.add_module(f"fpn{i}", _ConvBNReLU(out_channels,
                                                   out_channels, 3))
        self.n = n

    def forward(self, feats):
        if len(feats) != self.n + 1:
            raise ValueError(f"{len(feats)} levels, want {self.n + 1}")
        laterals = list(feats)
        for i in range(self.n - 1, -1, -1):
            up = resize_linear(laterals[i + 1], laterals[i].shape[2:],
                               (2, 3), align_corners=True)
            x = torch.cat([laterals[i], up], dim=1)
            x = getattr(self, f"lateral{i}")(x)
            laterals[i] = getattr(self, f"fpn{i}")(x)
        return tuple(laterals[:self.n])


class FPNRender(nn.Module):
    """mmdet FPN with num_outs == the levels (no extra): lateral{i} 1x1,
    the top-down nearest x2 upsample added (cropped to the finer level),
    fpn{i} 3x3, all biased."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv2d(c, out_channels, 1))
            self.add_module(f"fpn{i}", Conv2d(out_channels, out_channels, 3,
                                              1, 1))
        self.n = len(in_channels)

    def forward(self, feats):
        if len(feats) != self.n:
            raise ValueError(f"{len(feats)} levels, want {self.n}")
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats)]
        for i in range(self.n - 1, 0, -1):
            H, W = laterals[i - 1].shape[2:]
            up = laterals[i].repeat_interleave(2, 2).repeat_interleave(2, 3)
            laterals[i - 1] = laterals[i - 1] + up[:, :, :H, :W]
        return tuple(getattr(self, f"fpn{i}")(x)
                     for i, x in enumerate(laterals))
