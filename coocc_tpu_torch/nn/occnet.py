"""OccFormer-style dual-path 3D encoder.

Counterpart of coocc_tpu/nn/occnet.py (reference: coocc/backbones/
occnet.py:13-74 OccupancyEncoder, dualpath_block.py:13-82
DualpathTransformerBlock, modules/aspp.py:132-172 BottleNeckASPP): each
block runs one shared shifted-window attention block (nn/swin.py's
SwinBlock, window 7, mlp_ratio 1) over the BEV-mean plane and every
z-slice batched together, refines the BEV path with a bottleneck ASPP and
merges it back per voxel through a sigmoid coefficient, with a
strided-conv residual.

Channels-first [B, C, X, Y, Z] in and out. No CoOccRay route reaches these
modules, in JAX or here. The submodules are named after JAX's flax scopes
(the reference ships no checkpoint of them);
`convert.module_state_dict_from_jax` maps JAX's variables onto them. Held
against JAX in fp32 (tests/test_torch_alt_modules.py).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .depthnet import ASPP
from .layers import BatchNorm, Conv2d, Conv3d, GroupNorm
from .swin import SwinBlock


def fit_groups(g: int, ch: int) -> int:
    """JAX's group count for `ch` channels: the reference's reduction
    (aspp.py:152-154: ch // 2 where ch <= g), then the largest count
    below that divides ch."""
    g = ch // 2 if ch <= g else g
    while g > 1 and ch % g:
        g -= 1
    return max(g, 1)


class BottleNeckASPP(nn.Module):
    """1x1 reduce (GroupNorm) -> ASPP -> 1x1 expand (GroupNorm) + residual,
    on [B, C, H, W]; the GroupNorms are flax's (fp32)."""

    def __init__(self, inplanes: int, reduction: int = 4,
                 dropout: float = 0.1, num_groups: int = 32):
        super().__init__()
        C = inplanes // reduction
        self.input_conv = Conv2d(inplanes, C, 1, bias=False)
        self.input_gn = GroupNorm(fit_groups(num_groups, C), C)
        self.aspp = ASPP(C, C, dropout)
        self.output_conv = Conv2d(C, inplanes, 1, bias=False)
        self.output_gn = GroupNorm(fit_groups(num_groups, inplanes), inplanes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.input_gn(self.input_conv(x)))
        y = F.relu(self.output_gn(self.output_conv(self.aspp(y))))
        return x + y


class DualpathTransformerBlock(nn.Module):
    """Shared window attention over the BEV mean and the z-slices, the ASPP
    global path, on [B, Cin, X, Y, Z] -> [B, channels, X/s, Y/s, Z/s]."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 shift: bool = False, head_channels: int = 32):
        super().__init__()
        C = channels
        self.stride = stride
        self.input_conv = Conv3d(in_channels, C, 3, stride, 1, bias=False)
        self.input_bn = BatchNorm(C)
        self.bev_encoder = SwinBlock(C, max(1, C // head_channels), 7,
                                     3 if shift else 0, mlp_ratio=1)
        self.aspp = BottleNeckASPP(C)
        self.combine_coeff = Conv3d(C, 1, 1)
        if stride > 1 or in_channels != C:
            self.downsample_conv = Conv3d(in_channels, C, 1, stride,
                                          bias=False)
            self.downsample_bn = BatchNorm(C)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.input_bn(self.input_conv(x)))
        B, C, X, Y, Z = y.shape
        # the BEV mean and the z-slices as one batch of [X, Y, C] maps
        bev = y.mean(4).permute(0, 2, 3, 1)
        slices = y.permute(0, 4, 2, 3, 1).reshape(B * Z, X, Y, C)
        tokens = self.bev_encoder(torch.cat([bev, slices]))
        bev = self.aspp(tokens[:B].permute(0, 3, 1, 2))
        y = tokens[B:].reshape(B, Z, X, Y, C).permute(0, 4, 2, 3, 1)
        y = y + torch.sigmoid(self.combine_coeff(y)) * bev[..., None]
        identity = x
        if hasattr(self, "downsample_conv"):
            identity = self.downsample_bn(self.downsample_conv(x))
        return y + identity


class OccupancyEncoder(nn.Module):
    """Stacked dual-path stages: [B, in_channels, X, Y, Z] -> the outputs of
    the stages in out_indices; every other block shifts its windows."""

    def __init__(self, in_channels: int,
                 block_numbers: Sequence[int] = (2, 2, 2, 2),
                 block_inplanes: Sequence[int] = (64, 128, 256, 512),
                 block_strides: Sequence[int] = (1, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.names = []
        cin, layer = in_channels, 0
        for i, (n, c, s) in enumerate(zip(block_numbers, block_inplanes,
                                          block_strides)):
            stage = []
            for b in range(n):
                self.add_module(f"stage{i}_block{b}", DualpathTransformerBlock(
                    cin, c, s if b == 0 else 1, shift=layer % 2 == 1))
                stage.append(f"stage{i}_block{b}")
                cin, layer = c, layer + 1
            self.names.append(stage)

    def forward(self, x: torch.Tensor):
        outs = []
        for i, stage in enumerate(self.names):
            for name in stage:
                x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
