"""LiDAR voxelization of a padded point cloud.

Counterpart of coocc_tpu/ops/voxelize.py: `linearize`, `delinearize`,
`voxelize_mask` (occupancy only, for the SparseLiDAREnc8x encoders, whose
stem GroupNorm erases the voxel features) and `voxelize`, the hard
voxelizer with per-voxel means that the HD encoder of the LiDAR-only model
reads (coocc_lidar).

`voxelize` is JAX's sorted segment-mean: the points are sorted by linear
voxel id (stably, so each voxel keeps its points in their order), at most
`max_points_per_voxel` of each voxel's first points enter its mean, and
when more than `max_voxels` voxels are occupied the largest ids are
dropped (the fast path) or, with `exact_overflow`, the voxels that arrive
last in the cloud. The sums are by segment over the sorted points
(`torch.segment_reduce`, as the lift-splat sums, ops/lift_splat.py), never
by atomics: each voxel sums its points in the same order on every run and
every device, the order JAX's sorted segment_sum takes.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .constants import device_constant

# the most points a segment of voxelize's unread remainder holds
_PIECE = 1024


class VoxelizedPoints(NamedTuple):
    """A fixed-capacity voxelized cloud: ids [V] int64 linear voxel ids,
    ascending, num_cells in the padding slots; features [V, F] the mean
    point features (0 in the padding); mask [V] bool."""
    ids: torch.Tensor
    features: torch.Tensor
    mask: torch.Tensor


def linearize(coords: torch.Tensor, grid_size) -> torch.Tensor:
    """[..., 3] integer xyz -> linear id, x-major then y then z."""
    _, ny, nz = [int(g) for g in grid_size]
    return (coords[..., 0] * ny + coords[..., 1]) * nz + coords[..., 2]


def delinearize(ids: torch.Tensor, grid_size) -> torch.Tensor:
    """Linear ids -> [..., 3] integer xyz."""
    _, ny, nz = [int(g) for g in grid_size]
    return torch.stack([ids // (nz * ny), (ids // nz) % ny, ids % nz], -1)


def _voxel_ids(points, points_mask, point_cloud_range, voxel_size,
               grid_size):
    """Each point's linear voxel id, num_cells where it is padding or
    outside the range, as JAX computes it (fp32 floor of the offset over
    the voxel size)."""
    nx, ny, nz = [int(g) for g in grid_size]
    dt = points.dtype
    pcr = device_constant(np.asarray(point_cloud_range[:3], np.float32),
                          points.device).to(dt)
    vs = device_constant(np.asarray(voxel_size, np.float32),
                         points.device).to(dt)
    hi = device_constant(np.array([nx, ny, nz], np.int64), points.device)
    coords = torch.floor((points[:, :3] - pcr) / vs).to(torch.int64)
    valid = ((coords >= 0) & (coords < hi)).all(dim=-1) & points_mask
    return torch.where(valid, linearize(coords, grid_size), nx * ny * nz), \
        valid


def voxelize(points: torch.Tensor, points_mask: torch.Tensor,
             point_cloud_range, voxel_size, grid_size: Tuple[int, int, int],
             max_voxels: int, max_points_per_voxel: int = 10,
             num_features: int | None = None,
             exact_overflow: bool = False) -> VoxelizedPoints:
    """points [P, F] padded (x, y, z, ...), points_mask [P] bool -> at
    most `max_voxels` occupied voxels in id order with the mean of their
    first `num_features` columns over at most `max_points_per_voxel`
    points each. Past `max_voxels` occupied voxels the fast path (the
    default) drops the largest ids; `exact_overflow` drops the latest to
    arrive (the voxels whose first point comes last in the cloud), the
    reference's rule, at the cost of two more sorts (JAX
    coocc_tpu/ops/voxelize.py:124-178). The two agree where nothing
    overflows."""
    P, F = points.shape
    nf = F if num_features is None else num_features
    num_cells = int(np.prod([int(g) for g in grid_size]))
    dev = points.device
    ids, valid = _voxel_ids(points, points_mask, point_cloud_range,
                            voxel_size, grid_size)
    order = torch.argsort(ids, stable=True)
    ids_s, valid_s = ids[order], valid[order]
    feats_s = points[order, :nf]
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          ids_s[1:] != ids_s[:-1]]) & valid_s
    pos = torch.arange(P, device=dev)
    run = torch.cumsum(is_first, 0) - 1            # the sorted-run index
    # each point's run starts at the last head at or before it (the valid
    # points sort first, the padding after them)
    start = torch.cummax(torch.where(is_first, pos, 0), 0).values
    # the runs summed: the first max_voxels (the fast path keeps those), or
    # every run, which the exact rule then picks from by arrival
    n_runs = P if exact_overflow else max_voxels
    kept = valid_s & (run < n_runs)
    take = kept & (pos - start < max_points_per_voxel)
    # slots ascend along the sorted points: run r's points are the rows
    # ends[r]:ends[r + 1]; the dropped ones go to the overflow slot
    slot = torch.where(kept, run, n_runs)
    ends = torch.searchsorted(slot, torch.arange(n_runs + 1, device=dev))
    # the points past the kept runs (the padding, the dropped voxels') are
    # summed in pieces of at most _PIECE, whose sums are not read:
    # segment_reduce walks a segment in one thread per channel, and one
    # segment of 230,000 such points took 10 ms on an H100
    rest = P - ends[n_runs]
    pieces = (rest - _PIECE * torch.arange(-(-P // _PIECE), device=dev)
              ).clamp(0, _PIECE)
    lengths = torch.cat([ends.diff(), pieces])

    def segment_sum(v):
        # the lengths sum to P by construction: unsafe skips the check,
        # which would wait for the card
        return torch.segment_reduce(v, "sum", lengths=lengths,
                                    unsafe=True)[:n_runs]
    feat_sum = segment_sum(torch.where(take[:, None], feats_s, 0.0))
    count = segment_sum(take.to(points.dtype))
    run_ids = ids_s[ends[:n_runs].clamp(max=P - 1)]
    n_voxels = is_first.sum()
    mean = feat_sum / torch.clamp(count[:, None], min=1.0)
    if exact_overflow:
        # rank the runs by their head's place in the cloud; keep the first
        # max_voxels to arrive, in id (run) order
        r = torch.arange(P, device=dev)
        head = torch.where(r < n_voxels, order[ends[:P].clamp(max=P - 1)],
                           P)
        rank = torch.argsort(torch.argsort(head, stable=True), stable=True)
        keep = (r < n_voxels) & (rank < max_voxels)
        dest = torch.where(keep, torch.cumsum(keep, 0) - 1, max_voxels)
        out_ids = torch.full((max_voxels + 1,), num_cells, dtype=ids.dtype,
                             device=dev).index_copy(0, dest, run_ids)
        mean = mean.new_zeros((max_voxels + 1, nf)).index_copy(0, dest, mean)
        seg_valid = torch.arange(max_voxels, device=dev) < keep.sum()
        return VoxelizedPoints(
            torch.where(seg_valid, out_ids[:max_voxels], num_cells),
            torch.where(seg_valid[:, None], mean[:max_voxels], 0.0),
            seg_valid)
    seg_valid = torch.arange(max_voxels, device=dev) < torch.clamp(
        n_voxels, max=max_voxels)
    mean = torch.where(seg_valid[:, None], mean, 0.0)
    out_ids = torch.where(seg_valid, run_ids, num_cells)
    return VoxelizedPoints(out_ids, mean, seg_valid)


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
    ids, _ = _voxel_ids(points, points_mask, point_cloud_range, voxel_size,
                        grid_size)
    occ = torch.zeros(num_cells + 1, dtype=torch.bool, device=points.device)
    occ[ids] = True
    occ = occ[:num_cells]
    if max_voxels is not None and max_voxels < num_cells:
        occ = occ & (torch.cumsum(occ, 0, dtype=torch.int32) <= max_voxels)
    return occ.reshape(nx, ny, nz)
