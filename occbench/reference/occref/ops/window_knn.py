"""Grid-space windowed 2-nearest-active-cell search (BiFuserN's KNN).

Counterpart of coocc_tpu/ops/window_knn.py. For every cell of an [X, Y, Z]
grid, the linear ids of the two nearest ACTIVE cells of a key mask, where
"nearest" scans the window offsets in `make_offsets` order (sorted by L2
norm, stable, clipped at dist_thresh); -1 where fewer than two actives fall
in the window. Cells outside the grid are never active.

`window_knn` is the plain search (`window_knn_plain`) on every device:
the frozen reference copy of the port's module, without its kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import device_constant


def make_offsets(rx: int, ry: int, rz: int,
                 dist_thresh: float) -> np.ndarray:
    """Window offsets [O, 3] int32 sorted by L2 norm (stable), clipped at
    dist_thresh."""
    dx, dy, dz = np.meshgrid(np.arange(-rx, rx + 1), np.arange(-ry, ry + 1),
                             np.arange(-rz, rz + 1), indexing="ij")
    offs = np.stack([dx, dy, dz], -1).reshape(-1, 3)
    d = np.linalg.norm(offs, axis=-1)
    keep = d < dist_thresh
    offs, d = offs[keep], d[keep]
    order = np.argsort(d, kind="stable")
    return offs[order].astype(np.int32)


def _radii(offsets: np.ndarray):
    return [int(np.abs(offsets[:, i]).max()) for i in range(3)]


def best2_ranks_plain(key_mask: torch.Tensor, offsets: np.ndarray):
    """(best1, best2) [X*Y*Z] int32 distance-ranks of the two nearest active
    cells, O where none: the plane reduction of coocc_tpu/ops/window_knn.py
    with i16 ranks."""
    X, Y, Z = key_mask.shape
    O = offsets.shape[0]
    rx, ry, rz = _radii(offsets)
    padded = torch.nn.functional.pad(key_mask, (rz, rz, ry, ry, rx, rx))
    zs = torch.stack([padded[:, :, dz:dz + Z] for dz in range(2 * rz + 1)])
    ys = torch.stack([zs[:, :, dy:dy + Y] for dy in range(2 * ry + 1)])
    xs = torch.stack([ys[:, :, dx:dx + X] for dx in range(2 * rx + 1)])
    n_planes = (2 * rx + 1) * (2 * ry + 1) * (2 * rz + 1)
    planes = xs.reshape(n_planes, X * Y * Z)
    big = np.iinfo(np.int16).max
    if n_planes >= big:
        raise ValueError(f"rank table overflows int16: {n_planes} planes")
    raster = ((offsets[:, 0] + rx) * (2 * ry + 1)
              + (offsets[:, 1] + ry)) * (2 * rz + 1) + (offsets[:, 2] + rz)
    rank_of_raster = np.full(n_planes, big, np.int16)
    rank_of_raster[raster] = np.arange(O, dtype=np.int16)
    ranks = torch.from_numpy(rank_of_raster).to(key_mask.device)[:, None]
    vals = torch.where(planes, ranks, big)
    best1 = vals.min(dim=0).values
    best2 = torch.where(vals == best1[None], big, vals).min(dim=0).values
    return (best1.to(torch.int32).clamp(max=O),
            best2.to(torch.int32).clamp(max=O))


def ranks_to_ids(best1, best2, offsets: np.ndarray, shape):
    """Distance-ranks [n] int32 (O = none) -> neighbour ids [X, Y, Z, 2]."""
    X, Y, Z = shape
    O = offsets.shape[0]
    delta = torch.from_numpy(np.concatenate([
        (offsets[:, 0] * Y + offsets[:, 1]) * Z + offsets[:, 2],
        [0]]).astype(np.int32)).to(best1.device)
    cell = torch.arange(X * Y * Z, dtype=torch.int32, device=best1.device)
    ids = [torch.where(b < O, cell + delta[b.long()], -1)
           for b in (best1, best2)]
    return torch.stack(ids, dim=-1).reshape(X, Y, Z, 2)


def window_knn_plain(key_mask: torch.Tensor, offsets: np.ndarray,
                     k: int = 2) -> torch.Tensor:
    """Plain PyTorch version of `window_knn` (any device)."""
    if k != 2:
        raise ValueError("window_knn is specialized for k=2")
    b1, b2 = best2_ranks_plain(key_mask, offsets)
    return ranks_to_ids(b1, b2, offsets, key_mask.shape)


def window_knn(key_mask: torch.Tensor, offsets: np.ndarray,
               k: int = 2) -> torch.Tensor:
    """`window_knn_plain` on any device."""
    return window_knn_plain(key_mask, offsets, k)
