"""BEVDet4D-style temporal BEV alignment.

Counterpart of coocc_tpu/models/temporal.py (reference coocc/detectors/
bevdepth.py:180-296, BEVDet4D): the previous frame's voxel features are
warped into the current ego frame by the planar motion between the two
frames' camera-0 extrinsics (shift_feature, :195-249), then concatenated
with the current frame's channels (:292; the previous frame without a
gradient by default, :286-288).

The ego-motion chain is computed in fp32 on [B] batched 4x4 / 3x3
matrices; the warp is one bilinear sample of the (X, Y) plane for all
z-slices and channels at once, its four corners gathered (clamped, zeros
off the grid, the reference's grid_sample zero padding) through
`ops/gather.py:gather_rows`, whose gradient is a fixed-order sum. No
CoOccRay route reaches these, in JAX or here. Channels-first [B, C, X, Y,
Z] / [B, K, X, Y].
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.gather import gather_rows


def ego_motion_bev_matrix(rots_curr, trans_curr, rots_adj, trans_adj):
    """[B, 3, 3] rotations and [B, 3] translations (camera -> ego) of the
    current and the adjacent frame -> [B, 3, 3] planar transform l0 -> l1,
    the z row and column dropped (reference :206-230), fp32."""
    B = rots_curr.shape[0]

    def hom(r, t):
        m = torch.zeros(B, 4, 4, dtype=torch.float32, device=r.device)
        m[:, :3, :3] = r.float()
        m[:, :3, 3] = t.float()
        m[:, 3, 3] = 1.0
        return m

    l02l1 = hom(rots_curr, trans_curr) @ torch.linalg.inv(
        hom(rots_adj, trans_adj))
    keep = torch.tensor([0, 1, 3], device=l02l1.device)
    return l02l1[:, keep][:, :, keep]


def shift_bev_feature(feat: torch.Tensor, l02l1_xy: torch.Tensor, dx,
                      bx) -> torch.Tensor:
    """feat [B, K, X, Y] sampled bilinearly at the ego-motion-transformed
    cell coordinates (l02l1_xy [B, 3, 3]; dx, bx the BEV cell size and
    first centre (x, y) in metres), zeros where a corner falls off the
    grid; in feat's dtype."""
    B, K, X, Y = feat.shape
    dev = feat.device
    f2b = torch.tensor([[dx[0], 0.0, bx[0] - dx[0] / 2.0],
                        [0.0, dx[1], bx[1] - dx[1] / 2.0],
                        [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
    tf = torch.linalg.inv(f2b) @ l02l1_xy.float() @ f2b
    ix, iy = torch.meshgrid(torch.arange(X, dtype=torch.float32, device=dev),
                            torch.arange(Y, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([ix, iy, torch.ones_like(ix)], -1)    # [X, Y, 3]
    src = torch.einsum("bij,xyj->bxyi", tf, grid)[..., :2]
    sx, sy = src[..., 0], src[..., 1]
    x0, y0 = sx.floor().long(), sy.floor().long()
    wx, wy = sx - x0, sy - y0
    # the rows of every sample's (x, y) cell, K values each
    rows = feat.permute(0, 2, 3, 1).reshape(B * X * Y, K)
    base = torch.arange(B, device=dev)[:, None, None] * (X * Y)

    def corner(xi, yi):
        inb = (xi >= 0) & (xi < X) & (yi >= 0) & (yi < Y)
        idx = base + xi.clamp(0, X - 1) * Y + yi.clamp(0, Y - 1)
        return gather_rows(rows, idx) * inb[..., None]

    wx, wy = wx[..., None], wy[..., None]
    out = (corner(x0, y0) * (1 - wx) * (1 - wy)
           + corner(x0, y0 + 1) * (1 - wx) * wy
           + corner(x0 + 1, y0) * wx * (1 - wy)
           + corner(x0 + 1, y0 + 1) * wx * wy)
    return out.permute(0, 3, 1, 2).to(feat.dtype)


class TemporalBEVConcat(nn.Module):
    """The previous frame's voxel features (without a gradient where
    `detach`), aligned to the current frame where `align` and the poses
    are given, concatenated after the current frame's channels:
    curr, prev [B, C, X, Y, Z] -> [B, 2C, X, Y, Z]."""

    def __init__(self, align: bool = True, detach: bool = True):
        super().__init__()
        self.align = align
        self.detach = detach

    def forward(self, curr, prev, rots_curr=None, trans_curr=None,
                rots_adj=None, trans_adj=None, dx=None, bx=None):
        B, C, X, Y, Z = curr.shape
        if self.detach:
            prev = prev.detach()
        if self.align and rots_curr is not None:
            m = ego_motion_bev_matrix(rots_curr[:, 0], trans_curr[:, 0],
                                      rots_adj[:, 0], trans_adj[:, 0])
            flat = prev.permute(0, 1, 4, 2, 3).reshape(B, C * Z, X, Y)
            prev = shift_bev_feature(flat, m, dx, bx).reshape(
                B, C, Z, X, Y).permute(0, 1, 3, 4, 2)
        return torch.cat([curr, prev], dim=1)
