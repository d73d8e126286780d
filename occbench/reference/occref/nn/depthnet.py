"""Camera-aware DepthNet: SE-conditioned depth + context heads with ASPP+DCN.

Counterpart of coocc_tpu/nn/depthnet.py (reference DepthNet,
ViewTransformerLSSBEVDepth.py:382-549) with the reference checkpoint's names:
reduce_conv, context_conv, bn, {depth,context}_mlp, {depth,context}_se and
depth_conv = [BasicBlock x3, ASPP, DCN, 1x1 conv]. NCHW in, NCHW out: the
first D channels are depth logits, the rest the image context features.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dcn import deform_conv2d
from .layers import BatchNorm, Conv2d, Dropout, Linear


class Mlp(nn.Module):
    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.fc1 = Linear(cin, hidden)
        self.fc2 = Linear(hidden, cout)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class SELayer(nn.Module):
    """Gate x [B, C, H, W] by sigmoid(MLP(x_se [B, C])); 1x1 convs as in the
    reference checkpoint."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = Conv2d(channels, channels, 1)
        self.conv_expand = Conv2d(channels, channels, 1)

    def forward(self, x, x_se):
        dt = x_se.dtype
        se = F.relu(F.linear(x_se, self.conv_reduce.weight.flatten(1).to(dt),
                             self.conv_reduce.bias.to(dt)))
        se = F.linear(se, self.conv_expand.weight.flatten(1).to(dt),
                      self.conv_expand.bias.to(dt))
        return x * torch.sigmoid(se)[:, :, None, None]


class _ASPPModule(nn.Module):
    def __init__(self, cin, planes, k, padding, dilation):
        super().__init__()
        self.atrous_conv = Conv2d(cin, planes, k, 1, padding, dilation,
                                  bias=False)
        self.bn = BatchNorm(planes)

    def forward(self, x):
        return F.relu(self.bn(self.atrous_conv(x)))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (dilations 1/6/12/18 + global pool),
    then dropout (p = `dropout`, training only; JAX nn/depthnet.py:92-93:
    0.5 in the depth net, 0.1 in OccNet's BottleNeckASPP). In training the
    pooled branch's BatchNorm takes its statistics over the B*N pooled
    maps, as JAX's gap_bn does."""

    def __init__(self, inplanes: int, mid: int, dropout: float = 0.5):
        super().__init__()
        self.aspp1 = _ASPPModule(inplanes, mid, 1, 0, 1)
        self.aspp2 = _ASPPModule(inplanes, mid, 3, 6, 6)
        self.aspp3 = _ASPPModule(inplanes, mid, 3, 12, 12)
        self.aspp4 = _ASPPModule(inplanes, mid, 3, 18, 18)
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, 1)),
            Conv2d(inplanes, mid, 1, bias=False), BatchNorm(mid),
            nn.ReLU())
        self.conv1 = Conv2d(mid * 5, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        x4 = self.aspp4(x)
        # a 1x1 map upsampled bilinearly (align_corners=True) is a broadcast
        x5 = self.global_avg_pool(x).expand_as(x4)
        y = torch.cat([self.aspp1(x), self.aspp2(x), self.aspp3(x), x4, x5],
                      dim=1)
        return self.dropout(F.relu(self.bn1(self.conv1(y))))


class BasicBlock2D(nn.Module):
    """mmdet BasicBlock (stride 1, same channels) used in depth_conv."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + x)


class DCN(nn.Module):
    """mmcv DeformConv2dPack: conv_offset (3x3, 18 channels) + the
    deformable 3x3 conv with `groups` weight groups, one offset group."""

    def __init__(self, channels: int, groups: int = 4):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(
            torch.zeros(channels, channels // groups, 3, 3))
        self.conv_offset = Conv2d(channels, 18, 3, 1, 1)

    def forward(self, x):
        return deform_conv2d(x, self.conv_offset(x), self.weight, padding=1,
                             groups=self.groups)


class DepthNet(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int,
                 context_channels: int, depth_channels: int,
                 cam_channels: int = 27):
        super().__init__()
        self.reduce_conv = nn.Sequential(
            Conv2d(in_channels, mid_channels, 3, 1, 1),
            BatchNorm(mid_channels), nn.ReLU())
        self.context_conv = Conv2d(mid_channels, context_channels, 1)
        self.bn = BatchNorm(cam_channels)
        self.depth_mlp = Mlp(cam_channels, mid_channels, mid_channels)
        self.depth_se = SELayer(mid_channels)
        self.context_mlp = Mlp(cam_channels, mid_channels, mid_channels)
        self.context_se = SELayer(mid_channels)
        self.depth_conv = nn.Sequential(
            BasicBlock2D(mid_channels), BasicBlock2D(mid_channels),
            BasicBlock2D(mid_channels), ASPP(mid_channels, mid_channels),
            DCN(mid_channels, groups=4),
            Conv2d(mid_channels, depth_channels, 1))

    def forward(self, x, mlp_input):
        """x [BN, Cin, fH, fW] in the compute dtype; mlp_input [BN,
        cam_channels] fp32, normalized in fp32 and rounded to x's dtype (the
        JAX BatchNorm's `dtype=self.dtype`)."""
        mlp_input = self.bn(mlp_input).to(x.dtype)
        x = self.reduce_conv(x)
        context = self.context_se(x, self.context_mlp(mlp_input))
        context = self.context_conv(context)
        depth = self.depth_se(x, self.depth_mlp(mlp_input))
        depth = self.depth_conv(depth)
        return torch.cat([depth, context], dim=1)
