"""Grid-space windowed 2-nearest-active-cell search (BiFuserN's KNN).

Counterpart of coocc_tpu/ops/window_knn.py. For every cell of an [X, Y, Z]
grid, the linear ids of the two nearest ACTIVE cells of a key mask, where
"nearest" scans the window offsets in `make_offsets` order (sorted by L2
norm, stable, clipped at dist_thresh); -1 where fewer than two actives fall
in the window. Cells outside the grid are never active.

`window_knn` runs the hand-written CUDA kernel `csrc/window_knn.cu` for a
CUDA tensor and `window_knn_plain` (the JAX package's plane reduction, in
torch) for a CPU tensor; there is no other route.

The kernel replaces the TPU kernel coocc_tpu/ops/pallas/window_knn.py
(`_kernel`, called from `_best2_ranks` through `window_knn_best2`). That
kernel streamed (2rx+1)(2ry+1) pre-shifted int8 copies of the mask from HBM
and carried best-2 ranks through a sequential grid. On the card the whole
mask is 80 KB at the flagship 100x100x8 grid, so bytes are no bound (about
0.7 MB moved in all, well under a microsecond at 3.35 TB/s); the work is the
probe count, up to 2 per cell if the nearest offsets are active and O per
cell (1,215 or 2,535) where the window is empty. The design: one block per
4x8x8 tile of cells, which loads its tile plus the (rx, ry, rz) halo into
shared memory as bytes (zero outside the grid) and the offset list as
shared-memory deltas in rank order; each thread owns a cell, walks the
offsets and stops at its second hit, then writes both ids.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import load_kernel_library
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


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = load_kernel_library("window_knn").window_knn_best2
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def window_knn(key_mask: torch.Tensor, offsets: np.ndarray,
               k: int = 2) -> torch.Tensor:
    """key_mask [X, Y, Z] bool; offsets [O, 3] int (make_offsets); k == 2.
    Returns [X, Y, Z, 2] int32 neighbour linear ids, -1 for none.

    A CPU tensor takes `window_knn_plain`; a CUDA tensor launches the
    kernel (and counts the launch in `window_knn.launches`)."""
    if k != 2:
        raise ValueError("window_knn is specialized for k=2")
    if key_mask.device.type == "cpu":
        return window_knn_plain(key_mask, offsets, k)
    if key_mask.device.type != "cuda":
        raise ValueError(f"window_knn: unsupported device {key_mask.device}")
    if key_mask.dtype != torch.bool or key_mask.dim() != 3:
        raise ValueError("window_knn: key_mask must be a [X, Y, Z] bool "
                         f"tensor, got {key_mask.dtype} "
                         f"{tuple(key_mask.shape)}")
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    if offsets.ndim != 2 or offsets.shape[1] != 3 or len(offsets) == 0:
        raise ValueError(f"window_knn: offsets must be [O, 3], got "
                         f"{offsets.shape}")
    key_mask = key_mask.contiguous()
    X, Y, Z = key_mask.shape
    rx, ry, rz = _radii(offsets)
    offs = device_constant(offsets, key_mask.device)
    out = torch.empty((X, Y, Z, 2), dtype=torch.int32,
                      device=key_mask.device)
    err = _launcher()(key_mask.data_ptr(), offs.data_ptr(), len(offsets),
                      X, Y, Z, rx, ry, rz, out.data_ptr(),
                      torch.cuda.current_stream(key_mask.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_knn kernel launch failed: CUDA error "
                           f"{err}")
    window_knn.launches += 1
    return out


window_knn.launches = 0
