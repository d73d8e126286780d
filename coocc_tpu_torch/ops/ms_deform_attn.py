"""Multi-scale 3D deformable attention (capability-envelope op).

Counterpart of coocc_tpu/ops/ms_deform_attn.py (the reference's
MultiScaleDeformableAttention3D, coocc/necks/multi_scale_deform_attn_3d.py):
each query samples num_points trilinear taps per head per pyramid level at
predicted offsets around its reference point and mixes them with softmax
attention weights.

JAX writes the sampler as XLA gathers (8 corner `take`s + lerp); here it is
a gather of each head's rows and a weighted sum, in plain torch ops. A
level's values [B, X, Y, Z, H, D] are one table of B*X*Y*Z*H rows of D
channels, so a tap reads only its head's channels. Out-of-range taps read
zeros: the index is clipped into the volume for the gather and the row
multiplied by the in-bounds mask, as JAX does. Locations follow
grid_sample's align_corners=False convention on (x, y, z) over the (X, Y,
Z) axes, normalized to [0, 1]. The rows come through
`grid_sample._corner_rows`: with a gradient to take, one fixed-order gather
of all corners (ops/gather.py), so a backward repeats bit for bit.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..nn.layers import Linear, flax_apply, softmax
from .constants import device_constant
from .grid_sample import _corner_rows


def corner_taps(coords: Sequence[torch.Tensor], sizes: Sequence[int]):
    """Linear-interpolation corners of points with cell-space coordinates
    `coords` (one [...] tensor an axis, the first axis slowest) on a grid
    of `sizes`: [(row [...] int64 clipped into the grid, weight [...] in
    the coordinates' dtype, zero outside the grid)], the 2^n corners with
    the last axis fastest."""
    lo = [torch.floor(c) for c in coords]
    frac = [c - c0 for c, c0 in zip(coords, lo)]
    lo = [c0.long() for c0 in lo]
    taps = []
    for d in itertools.product((0, 1), repeat=len(sizes)):
        row, w, inb = 0, 1.0, True
        for a, n in enumerate(sizes):
            i = lo[a] + d[a]
            row = row * n + i.clamp(0, n - 1)
            w = w * (frac[a] if d[a] else 1 - frac[a])
            inb = inb & (i >= 0) & (i < n)
        taps.append((row, w * inb.to(w.dtype)))
    return taps


def deform_sample(tables: Sequence[torch.Tensor],
                  sizes: Sequence[Sequence[int]], coords,
                  weights: torch.Tensor) -> torch.Tensor:
    """The multi-scale deformable sampler of both JAX modules, in fp32:
    tables[l] [B * prod(sizes[l]) * H, D] (one level's head-split values,
    rows (b, cell, h)); coords(l) the cell-space coordinates of level l,
    one [B, Q, H, P] tensor an axis of sizes[l]; weights [B, Q, H, L, P].
    Returns sum over levels (in order) and points of weight x the
    interpolated row: [B, Q, H, D] fp32."""
    B, Q, H, L, P = weights.shape
    D = tables[0].shape[-1]
    dev = weights.device
    out = torch.zeros(B, Q, H, D, dtype=torch.float32, device=dev)
    bh = (torch.arange(B, device=dev)[:, None, None, None] * H,
          torch.arange(H, device=dev)[None, None, :, None])
    for lvl, (table, size) in enumerate(zip(tables, sizes)):
        taps = corner_taps(coords(lvl), size)
        n = math.prod(size)
        rows = _corner_rows(table, ((bh[0] * n + row * H) + bh[1]
                                    for row, _ in taps))
        w_l = weights[:, :, :, lvl]
        for v, (_, w) in zip(rows, taps):
            out = out + ((w * w_l)[..., None] * v.float()).sum(3)
    return out


def ms_deform_attn_3d(values: Sequence[torch.Tensor],
                      sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor) -> torch.Tensor:
    """The sampling/mixing core, as JAX's `ms_deform_attn_3d`.

    values: per-level [B, X_l, Y_l, Z_l, H, D] head-split features;
    sampling_locations [B, Q, H, L, P, 3] in [0, 1] (x, y, z);
    attention_weights [B, Q, H, L, P]. Returns [B, Q, H*D] fp32: each
    level's weighted taps summed in fp32, level after level."""
    B, Q, H, L, P, _ = sampling_locations.shape
    D = values[0].shape[-1]
    sizes = [tuple(v.shape[1:4]) for v in values]

    def coords(lvl):
        loc = sampling_locations[:, :, :, lvl]
        # align_corners=False unnormalize: x * X - 0.5
        return [loc[..., a] * n - 0.5 for a, n in enumerate(sizes[lvl])]
    out = deform_sample([v.reshape(-1, D) for v in values], sizes, coords,
                        attention_weights.float())
    return out.reshape(B, Q, H * D)


def ring_bias(H: int, L: int, P: int) -> np.ndarray:
    """`sampling_offsets`' initial bias (JAX's `ring_bias`): head h points
    along angle 2*pi*h/H in x and y and their mean in z, scaled to unit max,
    the radius growing with the point's index."""
    thetas = np.arange(H, dtype=np.float32) * (2 * math.pi / H)
    grid = np.stack([np.cos(thetas), np.sin(thetas),
                     (np.sin(thetas) + np.cos(thetas)) / 2], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None], (1, L, P, 1))
    for i in range(P):
        grid[:, :, i] *= i + 1
    return grid.reshape(-1)


def offset_heads(C_in: int, n: int, bias: np.ndarray):
    """`sampling_offsets` (bias.size outputs) and `attention_weights` (n)
    with flax's init: zero kernels, the offsets' bias `bias`, the weights'
    zero."""
    off, att = Linear(C_in, bias.size), Linear(C_in, n)
    with torch.no_grad():
        for m in (off, att):
            m.weight.zero_()
            m.bias.zero_()
        off.bias.copy_(torch.from_numpy(bias))
    return off, att


class MSDeformAttn3D(nn.Module):
    """query -> offsets / weights -> sample -> output proj -> residual, as
    JAX's `MSDeformAttn3D` (flax scopes as the attribute names). One
    `value_proj` for every level (the reference projects the flattened
    multi-level sequence once); offsets divided by each level's (X, Y, Z);
    softmax over levels x points in fp32. The offset and weight kernels
    start at zero and the offsets' bias on the ring, as flax's init."""

    def __init__(self, embed_dims: int = 128, num_heads: int = 4,
                 num_levels: int = 3, num_points: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        C, H, L, P = embed_dims, num_heads, num_levels, num_points
        self.embed_dims, self.num_heads = C, H
        self.num_levels, self.num_points, self.dtype = L, P, dtype
        self.sampling_offsets, self.attention_weights = offset_heads(
            C, H * L * P, ring_bias(H, L, P))
        self.value_proj = Linear(C, C)
        self.output_proj = Linear(C, C)

    def forward(self, query: torch.Tensor, value_levels, reference_points):
        """query [B, Q, C]; value_levels: per-level channels-first
        [B, C, X, Y, Z]; reference_points [B, Q, 3] in [0, 1]. Returns
        [B, Q, C]."""
        C, H, L, P = (self.embed_dims, self.num_heads, self.num_levels,
                      self.num_points)
        assert len(value_levels) == L
        B, Q, _ = query.shape
        offsets = flax_apply(self.sampling_offsets, query, self.dtype).reshape(
            B, Q, H, L, P, 3).float()
        weights = softmax(flax_apply(self.attention_weights, query, self.dtype)
                          .reshape(B, Q, H, L * P).float(), -1).reshape(
                              B, Q, H, L, P)
        vals, shapes = [], []
        for v in value_levels:
            X, Y, Z = v.shape[2:]
            shapes.append((X, Y, Z))
            v = flax_apply(self.value_proj, v.movedim(1, -1), self.dtype)
            vals.append(v.reshape(B, X, Y, Z, H, C // H))
        norms = device_constant(np.asarray(shapes, np.float32),
                                query.device)
        loc = reference_points[:, :, None, None, None, :] \
            + offsets / norms[None, None, None, :, None, :]
        out = ms_deform_attn_3d(vals, loc, weights)
        out = flax_apply(self.output_proj, out.to(query.dtype), self.dtype)
        return query + out
