"""Occupancy voxelization of a padded LiDAR cloud.

Counterpart of `linearize` and `voxelize_mask` in coocc_tpu/ops/voxelize.py.
The dense LiDAR encoder reads only voxel occupancy (its stem GroupNorm erases
the voxel features), so the eval path needs the kept-voxel mask and no
per-voxel means.
"""
from __future__ import annotations

from typing import Tuple

import torch


def linearize(coords: torch.Tensor, grid_size) -> torch.Tensor:
    """[..., 3] integer xyz -> linear id, x-major then y then z."""
    _, ny, nz = [int(g) for g in grid_size]
    return (coords[..., 0] * ny + coords[..., 1]) * nz + coords[..., 2]


def voxelize_mask(points: torch.Tensor, points_mask: torch.Tensor,
                  point_cloud_range, voxel_size,
                  grid_size: Tuple[int, int, int],
                  max_voxels: int | None = None) -> torch.Tensor:
    """[P, >=3] points + [P] bool mask -> [nx, ny, nz] bool occupancy.

    The cap keeps the `max_voxels` smallest occupied linear ids: the
    reference's id-order rule (coocc_tpu/ops/voxelize.py:213-243).
    """
    nx, ny, nz = [int(g) for g in grid_size]
    num_cells = nx * ny * nz
    pcr = torch.as_tensor(point_cloud_range, dtype=points.dtype,
                          device=points.device)
    vs = torch.as_tensor(voxel_size, dtype=points.dtype, device=points.device)
    coords = torch.floor((points[:, :3] - pcr[:3]) / vs).to(torch.int64)
    hi = torch.tensor([nx, ny, nz], device=points.device)
    valid = ((coords >= 0) & (coords < hi)).all(dim=-1) & points_mask
    ids = torch.where(valid, linearize(coords, grid_size), num_cells)
    occ = torch.zeros(num_cells + 1, dtype=torch.bool, device=points.device)
    occ[ids] = True
    occ = occ[:num_cells]
    if max_voxels is not None and max_voxels < num_cells:
        occ = occ & (torch.cumsum(occ, 0, dtype=torch.int32) <= max_voxels)
    return occ.reshape(nx, ny, nz)
