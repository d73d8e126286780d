"""Swin Transformer image backbone.

Counterpart of coocc_tpu/nn/swin.py (reference: coocc/backbones/
swintransformer.py:465-770, mmdet's Swin): patch embed, four stages of
(shifted-)window attention blocks with patch merging between them, and a
LayerNorm on each stage's output. Channels-last tokens [B, H, W, C] inside;
NCHW in and out, as the port's ResNet.

The modules carry the reference checkpoint's names, as JAX's
`convert_swin` reads them (coocc_tpu/train/convert_torch.py:287-326):
patch_embed.{projection, norm}, stages.{i}.blocks.{j}.{norm1,
attn.w_msa.{qkv, proj, relative_position_bias_table,
relative_position_index}, norm2, ffn.layers.0.0, ffn.layers.1},
stages.{i}.downsample.{norm, reduction}, norm{i}. `PatchMerging`
concatenates each 2x2 patch channel-major (the reference's Unfold order,
feature c * 4 + dh * 2 + dw); JAX's concatenates position-major, and
`convert.py` permutes between the two.

Numerics follow JAX call by call, in the input's dtype:
  * attention: q scaled by hd ** -0.5 (rounded to the compute dtype first,
    a weak constant), q @ k^T, the relative position bias and the seam mask
    added in the logits' dtype, the softmax in fp32 (`layers.softmax`) cast
    to v's dtype, then @ v. No fused attention: it rounds elsewhere.
  * LayerNorm: flax's (`layers.LayerNorm`); GELU: the exact erfc form JAX
    writes (`gelu`); Linear casts its fp32 weights to the input's dtype.
  * every stage pads its tokens to window multiples at the forward, as JAX
    does, and the shift's seam mask is computed on the padded grid; pad
    tokens attend freely in unshifted windows (standard Swin).
  * in training the bias table's gather takes its gradient through
    `ops/gather.py:gather_rows` (a fixed-order sum; `table[idx]`'s own
    backward sums with atomics on the card).
No drop-path or dropout: JAX's has none.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.gather import gather_rows
from .layers import Conv2d, LayerNorm, Linear, softmax, weak


def _rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """[N, N] index into the (2wh-1)(2ww-1) relative position bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # [2, N, N]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    return rel[:, :, 0] * (2 * ww - 1) + rel[:, :, 1]


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def _window_reverse(wins: torch.Tensor, ws: int, B: int, H: int,
                    W: int) -> torch.Tensor:
    x = wins.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def _shift_attn_mask(H: int, W: int, ws: int, shift: int,
                     device=None) -> torch.Tensor:
    """[nW, N, N] additive fp32 mask (-100 across shifted-window seams) of
    an H x W grid (window multiples), made on `device`: each cell's region
    is 3 * (its row's band) + (its column's band), the bands [0, n - ws),
    [n - ws, n - shift), [n - shift, n) (JAX's slices), and two cells of a
    window attend where their regions are equal."""
    def band(n):
        i = torch.arange(n, device=device)
        return (i >= n - ws).long() + (i >= n - shift).long()
    img = band(H)[:, None] * 3 + band(W)[None, :]
    wins = img.reshape(H // ws, ws, W // ws, ws).permute(0, 2, 1, 3)
    wins = wins.reshape(-1, ws * ws)
    return (wins[:, :, None] != wins[:, None, :]).float() * -100.0


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=False): 0.5 * x * erfc(-x * sqrt(1/2)), each
    op in x's dtype (the constant rounded to it first)."""
    return 0.5 * x * torch.special.erfc(-x * weak(math.sqrt(0.5), x.dtype))


class WindowMSA(nn.Module):
    """Window multi-head self-attention with relative position bias, on
    [B_, N, C] windows with an optional [nW, N, N] additive mask."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        ws = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) * (2 * ws - 1), num_heads))
        # the reference keeps the index as a buffer of its checkpoint
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_pos_index(ws, ws)))
        self.qkv = Linear(embed_dims, 3 * embed_dims)
        self.proj = Linear(embed_dims, embed_dims)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B_, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        qkv = self.qkv(x).reshape(B_, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * weak(hd ** -0.5, q.dtype)) @ k.transpose(-2, -1)
        bias = gather_rows(self.relative_position_bias_table,
                           self.relative_position_index.reshape(-1))
        attn = attn + bias.reshape(N, N, nh).permute(2, 0, 1)[None].to(
            attn.dtype)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(B_ // nW, nW, nh, N, N) \
                + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(B_, nh, N, N)
        attn = softmax(attn.float(), -1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class ShiftWindowMSA(nn.Module):
    """Pad to window multiples, cyclic shift, window attention (`w_msa`),
    reverse, unshift, crop (JAX SwinBlock's attention path)."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int,
                 shift: int):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.w_msa = WindowMSA(embed_dims, num_heads, window_size)

    def forward(self, y: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """y [B, H, W, C]; mask: the padded grid's seam mask (shifted
        blocks)."""
        B, H, W, C = y.shape
        ws, s = self.window_size, self.shift
        Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
        y = torch.nn.functional.pad(y, (0, 0, 0, Wp - W, 0, Hp - H))
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = _window_reverse(self.w_msa(_window_partition(y, ws),
                                       mask if s else None), ws, B, Hp, Wp)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        return y[:, :H, :W]


class _FFN(nn.Module):
    """mmcv's FFN names: layers.0.0 (fc1), layers.1 (fc2)."""

    def __init__(self, dims: int, hidden: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([Linear(dims, hidden)]),
                                     Linear(hidden, dims)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers[1](gelu(self.layers[0][0](x)))


class SwinBlock(nn.Module):
    """LN -> (S)W-MSA -> +res -> LN -> MLP -> +res, on [B, H, W, C]. The
    shift is the reference's on every odd block, whatever the input's
    size (the seam mask blocks the wrapped-in attention)."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int,
                 shift: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(embed_dims, eps=1e-5)
        self.attn = ShiftWindowMSA(embed_dims, num_heads, window_size,
                                   shift)
        self.norm2 = LayerNorm(embed_dims, eps=1e-5)
        self.ffn = _FFN(embed_dims, embed_dims * mlp_ratio)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask: `seam_mask` of x's grid where the block shifts (None
        computes it)."""
        if mask is None and self.attn.shift:
            mask = seam_mask(x, self.attn.window_size, self.attn.shift)
        x = x + self.attn(self.norm1(x), mask)
        return x + self.ffn(self.norm2(x))


def seam_mask(x: torch.Tensor, ws: int, shift: int) -> torch.Tensor:
    """The shift's [nW, N, N] seam mask on x's grid [B, H, W, C] padded to
    window multiples, made on x's device (no copy from the host)."""
    H, W = x.shape[1:3]
    return _shift_attn_mask(-(-H // ws) * ws, -(-W // ws) * ws, ws, shift,
                            x.device)


class PatchMerging(nn.Module):
    """2x2 patch concat (channel-major, the reference's Unfold order) + LN
    + linear 4C -> 2C, on [B, H, W, C]; odd sizes zero-padded to even."""

    def __init__(self, in_dims: int, out_dims: int):
        super().__init__()
        self.norm = LayerNorm(4 * in_dims, eps=1e-5)
        self.reduction = Linear(4 * in_dims, out_dims, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = torch.nn.functional.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        H, W = x.shape[1:3]
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2,
                                                  4 * C)))


class _PatchEmbed(nn.Module):
    def __init__(self, embed_dims: int, patch_size: int, patch_norm: bool):
        super().__init__()
        self.projection = Conv2d(3, embed_dims, patch_size, patch_size)
        self.norm = LayerNorm(embed_dims, eps=1e-5) if patch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] -> [B, H/p, W/p, C]."""
        x = self.projection(x).permute(0, 2, 3, 1)
        return self.norm(x) if self.norm is not None else x


class _Stage(nn.Module):
    def __init__(self, dims: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: int, downsample: bool):
        super().__init__()
        self.window_size = window_size
        self.blocks = nn.ModuleList([
            SwinBlock(dims, num_heads, window_size,
                      0 if b % 2 == 0 else window_size // 2, mlp_ratio)
            for b in range(depth)])
        self.downsample = PatchMerging(dims, 2 * dims) if downsample \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # every shifted block of a stage reads one mask of its grid
        shifts = {b.attn.shift for b in self.blocks if b.attn.shift}
        masks = {s: seam_mask(x, self.window_size, s) for s in shifts}
        for b in self.blocks:
            x = b(x, masks.get(b.attn.shift))
        return x


class SwinTransformer(nn.Module):
    """Multi-scale Swin backbone: [B, 3, H, W] -> tuple of [B, C*2^i,
    H/4/2^i, W/4/2^i] for i in out_indices (`out_channels` theirs).

    Defaults = Swin-T (reference swintransformer.py:522-535): embed 96,
    depths (2,2,6,2), heads (3,6,12,24), window 7, patch 4."""

    def __init__(self, embed_dims: int = 96, patch_size: int = 4,
                 window_size: int = 7, mlp_ratio: int = 4,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 patch_norm: bool = True):
        super().__init__()
        self.patch_size = patch_size
        self.out_indices = tuple(out_indices)
        self.patch_embed = _PatchEmbed(embed_dims, patch_size, patch_norm)
        dims = [embed_dims * 2 ** i for i in range(len(depths))]
        self.stages = nn.ModuleList([
            _Stage(dims[i], d, num_heads[i], window_size, mlp_ratio,
                   i < len(depths) - 1) for i, d in enumerate(depths)])
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm(dims[i], eps=1e-5))
        self.out_channels = [dims[i] for i in self.out_indices]

    def forward(self, x: torch.Tensor):
        p = self.patch_size
        if x.shape[2] % p or x.shape[3] % p:
            raise ValueError(f"input {tuple(x.shape[2:])} is not a multiple "
                             f"of the patch size {p}")
        x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return tuple(outs)
