"""Frustum volume renderer: per-camera alpha compositing over fused voxels.

Counterpart of coocc_tpu/models/renderer.py (reference coocc_ray.py:358-433,
the camera branch of the training renderer): the LSS frustum's ego points
look up the fused voxel features on the render grid (its own bounds,
RenderConfig.render_{x,y,z}bound), the sigma and rgb heads run on every
sample, and the samples are alpha-composited along each ray's D depths,
then upsampled x16 bilinearly (align_corners=False) by JAX's op sequence
(ops/interpolate.py).

The reference's quirks are kept: rgb is zeroed outside the grid BEFORE the
sigmoid (0.5 after it), the distances between samples are measured on the
truncated integer voxel coordinates, the last distance is 1e10, and a
lookup past the voxel table (a render grid larger than the feature grid)
reads its last row, as JAX's gather clamps, and passes no gradient back,
as the transpose of JAX's gather drops it. Compositing is fp32: the heads'
outputs are in the compute dtype and promote against the fp32 distances.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config.base import RenderConfig
from ..ops.gather import gather_rows
from ..ops.interpolate import resize_bilinear_chlast


def composite(rgb: torch.Tensor, sigma: torch.Tensor, pts: torch.Tensor):
    """Alpha compositing along the last depth axis. rgb [..., D, 3]
    (sigmoided), sigma [..., D] (ReLU'd), pts [..., D, 3] float voxel
    coordinates -> (rgb_map [..., 3], depth_map [...] in units of
    z_vals = linspace(0, D, D))."""
    D = sigma.shape[-1]
    dists = torch.linalg.norm(pts[..., 1:, :] - pts[..., :-1, :], dim=-1)
    dists = torch.cat([dists, dists.new_full(dists.shape[:-1] + (1,),
                                             1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-F.relu(sigma * dists))
    ones = alpha.new_ones(alpha.shape[:-1] + (1,))
    t = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1),
                      dim=-1)[..., :-1]
    weights = alpha * t
    rgb_map = (weights[..., None] * rgb).sum(dim=-2)
    z_vals = torch.linspace(0.0, float(D), D, device=weights.device)
    depth_map = (weights * z_vals).sum(dim=-1)
    return rgb_map, depth_map


def render_grid(cfg: RenderConfig):
    """(dx, bx fp32 [3], nx [3] ints) of the render grid."""
    bounds = (cfg.render_xbound, cfg.render_ybound, cfg.render_zbound)
    dx = np.array([b[2] for b in bounds], np.float32)
    bx = np.array([b[0] + b[2] / 2.0 for b in bounds], np.float32)
    nx = [int(round((b[1] - b[0]) / b[2])) for b in bounds]
    return dx, bx, nx


def gather_frustum(voxel_feats: torch.Tensor, geom: torch.Tensor, dx, bx,
                   nx):
    """voxel_feats [X, Y, Z, C]; geom [N, D, H, W, 3] ->
    (feat [N, H, W, D, C], mask [N, H, W, D], pts [N, H, W, D, 3] int32)."""
    X, Y, Z, C = voxel_feats.shape
    dx = torch.as_tensor(dx, device=geom.device)
    bx = torch.as_tensor(bx, device=geom.device)
    coords = (geom - (bx - dx / 2.0)) / dx
    hi = torch.as_tensor(nx, dtype=coords.dtype, device=geom.device)
    inside = ((coords >= 0) & (coords < hi)).all(dim=-1)
    coords = coords * inside[..., None]
    pts = coords.to(torch.int32).permute(0, 2, 3, 1, 4)
    mask = inside.permute(0, 2, 3, 1)
    lid = (pts[..., 0] * Y + pts[..., 1]) * Z + pts[..., 2]
    lid = lid.reshape(-1).long()
    inb = lid < X * Y * Z
    # every sample outside the grid reads row 0: ops/gather.py
    rows = gather_rows(voxel_feats.reshape(-1, C),
                       lid.clamp(max=X * Y * Z - 1))
    feat = torch.where(inb[:, None], rows, rows.detach())
    return feat.reshape(pts.shape[:-1] + (C,)), mask, pts


def render(sigma_head, rgb_head, cfg: RenderConfig, voxel_feats, geom,
           scale: int = 16) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """voxel_feats [B, X, Y, Z, C] (channels-last, the fused features);
    geom [B, N, D, H, W, 3]. rgb_head None renders depth only. Returns
    (rgbs [B, N, H*s, W*s, 3] or None, depths [B, N, H*s, W*s]), fp32."""
    dx, bx, nx = render_grid(cfg)
    parts = [gather_frustum(v, g, dx, bx, nx)
             for v, g in zip(voxel_feats, geom)]
    feat = torch.stack([f for f, _, _ in parts])      # [B, N, H, W, D, C]
    mask = torch.stack([m for _, m, _ in parts])
    pts = torch.stack([p for _, _, p in parts])
    sigma = F.relu(sigma_head(feat)[..., 0])
    if rgb_head is not None:
        rgb = torch.sigmoid(rgb_head(feat) * mask[..., None].to(feat.dtype))
    else:
        rgb = feat.new_zeros(feat.shape[:-1] + (3,))
    rgb_map, depth_map = composite(rgb, sigma, pts.float())
    B, N, H, W = depth_map.shape

    def up(x):  # [B, N, H, W, c] -> [B, N, H*s, W*s, c]
        return resize_bilinear_chlast(x, (H * scale, W * scale))
    depth_up = up(depth_map[..., None])[..., 0]
    return (up(rgb_map) if rgb_head is not None else None), depth_up
