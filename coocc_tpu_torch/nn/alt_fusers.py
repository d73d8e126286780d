"""Alternative fusion layers.

Counterpart of coocc_tpu/nn/alt_fusers.py (reference coocc/fuser/
addfuse.py:11-54 AddFuser, attnfuse.py:13-142 AttnFuser): gated additive
fusion, and cross-attention fusion over each (x, y) column's voxels. No
CoOccRay route reaches them, in JAX or here. Channels-first [B, C, X, Y,
Z] in and out; the submodules are named after JAX's flax scopes
(`convert.module_state_dict_from_jax`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv3d, Linear, softmax


class AddFuser(nn.Module):
    """Sigmoid gates (gate_conv, 3x3x3 on the concatenated modalities)
    weigh each modality; out_conv + out_bn + ReLU."""

    def __init__(self, in_channels: int = 128, out_channels: int = 128):
        super().__init__()
        self.gate_conv = Conv3d(2 * in_channels, 2, 3, 1, 1)
        self.out_conv = Conv3d(in_channels, out_channels, 3, 1, 1,
                               bias=False)
        self.out_bn = BatchNorm(out_channels)

    def forward(self, img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.gate_conv(torch.cat([img, pts], dim=1)))
        fused = img * gate[:, 0:1] + pts * gate[:, 1:2]
        return F.relu(self.out_bn(self.out_conv(fused)))


class MultiHeadDotProductAttention(nn.Module):
    """flax.linen.MultiHeadDotProductAttention (qkv_features = out features
    = C, no dropout) as flax computes it: query, key, value projections
    into [..., heads, C / heads], the query divided by sqrt(C / heads),
    the logits' softmax in their dtype (`layers.softmax`), the weighted
    values, the out projection over (heads, C / heads). The projections
    are Linear(C, C) whose outputs are the heads' features, head-major
    (flax's [C, heads, head_dim] kernels flattened)."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Linear(channels, channels)
        self.key = Linear(channels, channels)
        self.value = Linear(channels, channels)
        self.out = Linear(channels, channels)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        """q_in [N, Lq, C], kv_in [N, Lk, C] -> [N, Lq, C]."""
        N, Lq, C = q_in.shape
        nh, hd = self.num_heads, C // self.num_heads

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], nh, hd).transpose(1, 2)
        q = heads(self.query(q_in))
        q = q / float(np.float32(math.sqrt(hd)))
        k, v = heads(self.key(kv_in)), heads(self.value(kv_in))
        w = softmax(q @ k.transpose(-2, -1), -1)
        return self.out((w @ v).transpose(1, 2).reshape(N, Lq, C))


class AttnFuser(nn.Module):
    """Cross-attention over z-column tokens: each (x, y) column's Z voxels
    of one modality attend to the other's (one shared cross_attn, LiDAR
    queries on camera keys and the reverse), residual merges,
    concatenation, out_conv + out_bn + ReLU."""

    def __init__(self, in_channels: int = 128, out_channels: int = 128,
                 num_heads: int = 4):
        super().__init__()
        if in_channels % num_heads:
            raise ValueError(f"{in_channels} channels over {num_heads} heads")
        self.cross_attn = MultiHeadDotProductAttention(in_channels,
                                                       num_heads)
        self.out_conv = Conv3d(2 * in_channels, out_channels, 3, 1, 1,
                               bias=False)
        self.out_bn = BatchNorm(out_channels)

    def forward(self, img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        B, C, X, Y, Z = img.shape

        def tokens(t):  # [B, C, X, Y, Z] -> [B*X*Y, Z, C]
            return t.permute(0, 2, 3, 4, 1).reshape(B * X * Y, Z, C)
        tok_img, tok_pts = tokens(img), tokens(pts)
        pts_enh = tok_pts + self.cross_attn(tok_pts, tok_img)
        img_enh = tok_img + self.cross_attn(tok_img, tok_pts)
        fused = torch.cat([img_enh, pts_enh], dim=-1).reshape(
            B, X, Y, Z, 2 * C).permute(0, 4, 1, 2, 3)
        return F.relu(self.out_bn(self.out_conv(fused)))
