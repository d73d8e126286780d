"""SECOND3D backbone and SECOND3DFPN neck: the LiDAR-only model's dense
stack after the HD encoder.

Counterpart of coocc_tpu/nn/second3d.py (reference backbones/second3d.py,
necks/second3d_fpn.py, configured by coocc_lidar.py:113-130): Conv3d blocks
with (1, 3, 3) kernels and strides (1, s, s), BatchNorm eps 1e-3 and
momentum 0.01, parallel multi-scale outputs; the FPN's deblocks are a
1x1x1 conv (stride 1) or a (1, s, s) transposed conv, summed in order,
then `extra_num_conv` 3x3x3 conv blocks. Tensors are [B, C, Z, Y, X], the
reference's (D, H, W) conv axes (the model permutes in and out). Plain
large convolutions, which JAX leaves to XLA: cuDNN on the card, in the
input's dtype (nn/layers.py).

Parameter names are the reference checkpoint's: blocks.{i}.{3j} conv and
{3j+1} BN (conv 0 the strided one); deblocks.{i}.{0: conv or deconv,
1: BN}; extra_blocks.{3j} conv and {3j+1} BN.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from .layers import BatchNorm, Conv3d, ConvTranspose3d


def _block(conv: nn.Module, c: int) -> list:
    return [conv, BatchNorm(c, eps=1e-3, momentum=0.01), nn.ReLU()]


class SECOND3D(nn.Module):
    """[B, C, Z, Y, X] -> one map per stage, stage i at Y/s_i x X/s_i."""

    def __init__(self, in_channels: Sequence[int] = (128, 128, 128),
                 out_channels: Sequence[int] = (128, 256, 512),
                 layer_nums: Sequence[int] = (5, 5, 5),
                 layer_strides: Sequence[int] = (1, 2, 4),
                 is_cascade: bool = False):
        super().__init__()
        self.is_cascade = is_cascade
        blocks = []
        for i, (n, s, oc) in enumerate(zip(layer_nums, layer_strides,
                                           out_channels)):
            cin = out_channels[i - 1] if is_cascade and i else in_channels[i]
            layers = _block(Conv3d(cin, oc, (1, 3, 3), (1, s, s), (0, 1, 1),
                                   bias=False), oc)
            for _ in range(n):
                layers += _block(Conv3d(oc, oc, (1, 3, 3), 1, (0, 1, 1),
                                        bias=False), oc)
            blocks.append(nn.Sequential(*layers))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        outs = []
        for block in self.blocks:
            y = block(x)
            outs.append(y)
            if self.is_cascade:
                x = y
        return outs


class SECOND3DFPN(nn.Module):
    """The stages' maps -> [B, out_channels[-1], Z, Y, X] at stage 0's
    grid."""

    def __init__(self, in_channels: Sequence[int] = (128, 256, 512),
                 out_channels: Sequence[int] = (128, 128, 128),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 extra_num_conv: int = 3):
        super().__init__()
        deblocks = []
        for cin, oc, s in zip(in_channels, out_channels, upsample_strides):
            s = int(s)
            if s > 1:
                up = ConvTranspose3d(cin, oc, (1, s, s), (1, s, s),
                                     bias=False)
            else:   # the reference's use_conv_for_no_stride
                up = Conv3d(cin, oc, 1, 1, bias=False)
            deblocks.append(nn.Sequential(*_block(up, oc)))
        self.deblocks = nn.ModuleList(deblocks)
        c = out_channels[-1]
        extra = []
        for _ in range(extra_num_conv):
            extra += _block(Conv3d(c, c, 3, 1, 1, bias=False), c)
        self.extra_blocks = nn.Sequential(*extra)

    def forward(self, feats):
        ups = [d(f) for d, f in zip(self.deblocks, feats)]
        out = ups[0]
        for u in ups[1:]:
            out = out + u
        return self.extra_blocks(out)
