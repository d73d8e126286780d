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
mask is 80 KB at the flagship 100x100x8 grid, so bytes are no bound; the
work is the search. The kernel packs each (x, y) column of the mask into a
32-bit word (bit z = cell z active, so Z <= 32) and walks the window's
(dx, dy) columns in the order of `column_tables`: per column, bit
operations find the two nearest active dz above and below the cell, the
table gives their ranks, and the walk stops before the first chunk of
WALK_CHUNK columns whose smallest rank cannot beat the second rank found
(ranks only grow along the list, so this is exact). The ids are
cell + delta(offset[rank]), as in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


MAX_Z = 32      # one 32-bit word per (x, y) column of the grid
WALK_CHUNK = 4  # columns the kernel loads per step (csrc CHUNK)


class ColumnTables(NamedTuple):
    """The kernel's walk over the window's (dx, dy) columns, NC of them,
    sorted by `min_rank`. `ranks[c, dz + rz]` is the rank of offset
    (dx, dy, dz) in the list, O where the list lacks it (clipped at
    dist_thresh); `allow[c]` has bit dz + 32 set where it has it."""
    dxdy: np.ndarray      # [NC, 2] int32
    min_rank: np.ndarray  # [NC] int32, increasing
    ranks: np.ndarray     # [NC, 2 rz + 1] int32
    allow: np.ndarray     # [NC] uint64

    def packed(self) -> np.ndarray:
        """int32 [NC * 4 + NC * (2 rz + 1)] as the kernel reads it: a row
        (dx << 16 | dy & 0xffff, min rank, allow low word, allow high word)
        per column, then the rank rows."""
        dx, dy = self.dxdy[:, 0].astype(np.int64), self.dxdy[:, 1]
        head = np.stack([(dx << 16) | (dy & 0xFFFF),
                         self.min_rank.astype(np.int64)], axis=1)
        allow = self.allow.view(np.uint32).reshape(-1, 2).astype(np.int64)
        head = np.concatenate([head, allow], axis=1)
        flat = np.concatenate([head.reshape(-1), self.ranks.reshape(-1)])
        return (flat & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def column_tables(offsets: np.ndarray) -> ColumnTables:
    """K1's walk tables for an offset list (make_offsets order)."""
    offsets = np.asarray(offsets, dtype=np.int32)
    O = len(offsets)
    rx, ry, rz = _radii(offsets)
    if rz >= MAX_Z:
        raise ValueError(f"window_knn: rz {rz} >= {MAX_Z}")
    col = (offsets[:, 0] + rx) * (2 * ry + 1) + offsets[:, 1] + ry
    ranks = np.full(((2 * rx + 1) * (2 * ry + 1), 2 * rz + 1), O, np.int32)
    ranks[col, offsets[:, 2] + rz] = np.arange(O, dtype=np.int32)
    min_rank = ranks.min(axis=1)
    cols = np.flatnonzero(min_rank < O)
    cols = cols[np.argsort(min_rank[cols], kind="stable")]
    bits = np.uint64(1) << (np.arange(-rz, rz + 1) + 32).astype(np.uint64)
    allow = np.bitwise_or.reduce(
        np.where(ranks[cols] < O, bits, np.uint64(0)), axis=1)
    dxdy = np.stack([cols // (2 * ry + 1) - rx, cols % (2 * ry + 1) - ry], 1)
    return ColumnTables(dxdy.astype(np.int32), min_rank[cols], ranks[cols],
                        allow.astype(np.uint64))


@functools.lru_cache(maxsize=8)
def _packed_tables(raw: bytes) -> np.ndarray:
    return column_tables(np.frombuffer(raw, np.int32).reshape(-1, 3)).packed()


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = load_kernel_library("window_knn").window_knn_best2
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
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
    X, Y, Z = key_mask.shape
    if Z > MAX_Z:
        raise ValueError(f"window_knn: the kernel packs a column of Z <= "
                         f"{MAX_Z} cells into one word, got Z={Z}")
    key_mask = key_mask.contiguous()
    rx, ry, rz = _radii(offsets)
    table = _packed_tables(offsets.tobytes())
    offs = device_constant(offsets, key_mask.device)
    dtable = device_constant(table, key_mask.device)
    out = torch.empty((X, Y, Z, 2), dtype=torch.int32,
                      device=key_mask.device)
    NC = len(table) // (4 + 2 * rz + 1)
    err = _launcher()(key_mask.data_ptr(), dtable.data_ptr(), NC,
                      2 * rz + 1, offs.data_ptr(), len(offsets), X, Y, Z,
                      rx, ry, out.data_ptr(),
                      torch.cuda.current_stream(key_mask.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_knn kernel launch failed: CUDA error "
                           f"{err}")
    window_knn.launches += 1
    return out


window_knn.launches = 0
