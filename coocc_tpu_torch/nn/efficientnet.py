"""EfficientNet 2D backbone.

Counterpart of coocc_tpu/nn/efficientnet.py (reference: coocc/backbones/
efficientnet.py:275-520, mmcls-style CustomEfficientNet): b0-b8 and
es/em/el by width and depth scaling of one layer table, InvertedResidual
(MBConv with squeeze-excitation) and EdgeResidual (fused-MBConv) blocks,
Swish activations, multi-scale out_indices. NCHW in and out; depthwise
convolutions through `groups`.

The modules carry the reference checkpoint's names, as JAX's
`convert_efficientnet` reads them (coocc_tpu/train/convert_torch.py:329):
layers.{i} for a plain ConvModule stage (the stem, the last 1x1),
layers.{i}.{j}.{expand_conv, depthwise_conv, se.conv1, se.conv2,
linear_conv} (MBConv) or layers.{i}.{j}.{conv1, conv2} (fused-MBConv),
each ConvModule's .conv and .bn; `convert.module_state_dict_from_jax`
is its inverse. No CoOccRay route reaches it, in JAX or here.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from .layers import BatchNorm, Conv2d

# per-stage block rows [kernel, out_ch, se_ratio, stride, expand, type]
# type -1: plain ConvBNSwish, 0: InvertedResidual, 1: EdgeResidual
# (reference efficientnet.py:308-349)
_LAYERS_B = [
    [[3, 32, 0, 2, 0, -1]],
    [[3, 16, 4, 1, 1, 0]],
    [[3, 24, 4, 2, 6, 0], [3, 24, 4, 1, 6, 0]],
    [[5, 40, 4, 2, 6, 0], [5, 40, 4, 1, 6, 0]],
    [[3, 80, 4, 2, 6, 0], [3, 80, 4, 1, 6, 0], [3, 80, 4, 1, 6, 0],
     [5, 112, 4, 1, 6, 0], [5, 112, 4, 1, 6, 0], [5, 112, 4, 1, 6, 0]],
    [[5, 192, 4, 2, 6, 0], [5, 192, 4, 1, 6, 0], [5, 192, 4, 1, 6, 0],
     [5, 192, 4, 1, 6, 0], [3, 320, 4, 1, 6, 0]],
    [[1, 1280, 0, 1, 0, -1]],
]
_LAYERS_E = [
    [[3, 32, 0, 2, 0, -1]],
    [[3, 24, 0, 1, 3, 1]],
    [[3, 32, 0, 2, 8, 1], [3, 32, 0, 1, 8, 1]],
    [[3, 48, 0, 2, 8, 1], [3, 48, 0, 1, 8, 1], [3, 48, 0, 1, 8, 1],
     [3, 48, 0, 1, 8, 1]],
    [[5, 96, 0, 2, 8, 0], [5, 96, 0, 1, 8, 0], [5, 96, 0, 1, 8, 0],
     [5, 96, 0, 1, 8, 0], [5, 96, 0, 1, 8, 0], [5, 144, 0, 1, 8, 0],
     [5, 144, 0, 1, 8, 0], [5, 144, 0, 1, 8, 0], [5, 144, 0, 1, 8, 0]],
    [[5, 192, 0, 2, 8, 0], [5, 192, 0, 1, 8, 0]],
    [[1, 1280, 0, 1, 0, -1]],
]
# width factor, depth factor (reference :354-368)
ARCHS = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2),
         "b3": (1.2, 1.4), "b4": (1.4, 1.8), "b5": (1.6, 2.2),
         "b6": (1.8, 2.6), "b7": (2.0, 3.1), "b8": (2.2, 3.6),
         "es": (1.0, 1.0), "em": (1.0, 1.1), "el": (1.2, 1.4)}


def _make_divisible(v: float, divisor: int = 8) -> int:
    new = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new < 0.9 * v:
        new += divisor
    return new


def scaled_layers(arch: str):
    """Width/depth-scaled per-stage block table for `arch`."""
    wf, df = ARCHS[arch]
    table = _LAYERS_E if arch[0] == "e" else _LAYERS_B
    out = []
    for si, stage in enumerate(table):
        rows = [list(r) for r in stage]
        for r in rows:
            r[1] = _make_divisible(r[1] * wf)
        if 0 < si < len(table) - 1:
            n = int(math.ceil(len(rows) * df))
            rows = rows + [list(rows[-1]) for _ in range(n - len(rows))]
            for r in rows[len(stage):]:
                r[3] = 1  # repeated blocks keep stride 1
        out.append(rows)
    return out


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class _ConvModule(nn.Module):
    """mmcv ConvModule: .conv (k x k, padding k // 2), then .bn and Swish
    where asked (JAX `_ConvBNSwish`; without bn, a biased conv: the SE's)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, bn: bool = True, act: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride, k // 2, groups=groups,
                           bias=not bn)
        self.bn = BatchNorm(cout) if bn else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return _swish(x) if self.act else x


class _SE(nn.Module):
    """Squeeze-excitation with hidden = channels // ratio (mmcls SELayer)."""

    def __init__(self, channels: int, ratio: float):
        super().__init__()
        hidden = max(1, int(channels / ratio))
        self.conv1 = _ConvModule(channels, hidden, 1, bn=False, act=False)
        self.conv2 = _ConvModule(hidden, channels, 1, bn=False, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        return x * torch.sigmoid(self.conv2(_swish(self.conv1(s))))


class InvertedResidual(nn.Module):
    """MBConv: 1x1 expand -> depthwise k -> SE -> 1x1 project (+res)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 expand: int, se_ratio: float):
        super().__init__()
        mid = int(cin * expand)
        if expand != 1:
            self.expand_conv = _ConvModule(cin, mid, 1)
        self.depthwise_conv = _ConvModule(mid, mid, k, stride, groups=mid)
        if se_ratio > 0:
            self.se = _SE(mid, expand * se_ratio)
        self.linear_conv = _ConvModule(mid, cout, 1, act=False)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand_conv(x) if hasattr(self, "expand_conv") else x
        y = self.depthwise_conv(y)
        if hasattr(self, "se"):
            y = self.se(y)
        y = self.linear_conv(y)
        return y + x if self.residual else y


class EdgeResidual(nn.Module):
    """Fused-MBConv: k x k expand conv -> 1x1 project (+res); no SE, as
    JAX's (the E tables have none)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 expand: int):
        super().__init__()
        self.conv1 = _ConvModule(cin, int(cin * expand), k, stride)
        self.conv2 = _ConvModule(int(cin * expand), cout, 1, act=False)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """Multi-scale EfficientNet backbone: [B, 3, H, W] -> the outputs of
    the stages in out_indices (`out_channels` theirs); stages past the
    last of them are not built, as in JAX."""

    def __init__(self, arch: str = "b0",
                 out_indices: Sequence[int] = (2, 3, 4, 5)):
        super().__init__()
        self.arch = arch
        self.out_indices = tuple(out_indices)
        layers, cin, self.out_channels = [], 3, []
        for si, stage in enumerate(scaled_layers(arch)):
            if si > max(self.out_indices):
                break
            blocks = []
            for k, oc, se, s, e, bt in stage:
                if bt == -1:
                    blocks.append(_ConvModule(cin, oc, k, s))
                elif bt == 1:
                    blocks.append(EdgeResidual(cin, oc, k, s, e))
                else:
                    blocks.append(InvertedResidual(cin, oc, k, s, e, se))
                cin = oc
            # a plain ConvModule stage is layers.{i} itself
            layers.append(blocks[0] if stage[0][5] == -1
                          else nn.Sequential(*blocks))
            if si in self.out_indices:
                self.out_channels.append(cin)
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor):
        outs = []
        for si, layer in enumerate(self.layers):
            x = layer(x)
            if si in self.out_indices:
                outs.append(x)
        return tuple(outs)
