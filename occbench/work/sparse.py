"""Rulebook counts of a sparse LiDAR encoder, from a frame's points.

The active voxels of level 0 are the occupied ones (each point's voxel by
the floor of its offset over the voxel size, the configuration's cap
keeping the smallest linear ids). A submanifold 3x3x3 convolution keeps its
input's active set and pairs each active output with each active input in
its 3x3x3 neighbourhood; a strided convolution (3x3x3, stride 2) makes
active every output whose window holds an active input and pairs it with
each of them; a 1x1x1 convolution pairs each active cell with itself. Each
pair costs 2 * Ci * Co FLOP; the bytes are each active input row read
once, each output row written once and the weights once. Dense sites of a
packed grid are never counted.

The encoder's layers are listed in the configuration's file
(`sparse.convs`): kind ("subm", "down" or "point"), input and output
channels, the strided ones' padding, and whether K2 computes it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import peaks

OFFSETS = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)


@dataclass
class ConvWork:
    name: str
    kind: str
    k2: bool
    pairs: int
    flop: int
    bytes: int


def active_voxels(points: torch.Tensor, mask: torch.Tensor, pc_range,
                  voxel_size, grid, cap: int) -> torch.Tensor:
    """[A, 3] int64 coordinates of the occupied voxels of one cloud, the
    `cap` smallest linear ids, ascending."""
    pcr = torch.tensor(pc_range[:3], dtype=torch.float32,
                       device=points.device)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    hi = torch.tensor(grid, dtype=torch.int64, device=points.device)
    c = torch.floor((points[:, :3].float() - pcr) / vs).to(torch.int64)
    ok = ((c >= 0) & (c < hi)).all(-1) & mask
    c = c[ok]
    lin = torch.unique((c[:, 0] * grid[1] + c[:, 1]) * grid[2] + c[:, 2])
    lin = lin[:cap]
    return torch.stack([lin // (grid[1] * grid[2]),
                        (lin // grid[2]) % grid[1], lin % grid[2]], -1)


def _lin(c: torch.Tensor, grid) -> torch.Tensor:
    return (c[:, 0] * grid[1] + c[:, 1]) * grid[2] + c[:, 2]


def _inside(c: torch.Tensor, grid) -> torch.Tensor:
    hi = torch.tensor(grid, dtype=torch.int64, device=c.device)
    return ((c >= 0) & (c < hi)).all(-1)


def subm_pairs(coords: torch.Tensor, grid) -> int:
    """Pairs of a submanifold 3x3x3 conv over the active set `coords`."""
    keys = _lin(coords, grid)        # ascending
    offs = torch.from_numpy(OFFSETS).to(coords.device)
    n = 0
    for o in offs:
        c = coords + o
        inside = _inside(c, grid)
        q = _lin(c[inside], grid)
        pos = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
        n += int((keys[pos] == q).sum())
    return n


def down(coords: torch.Tensor, grid, pad):
    """A strided 3x3x3 conv (stride 2, padding `pad`) of the active set:
    -> (output coords ascending, output grid, pairs)."""
    out_grid = tuple((g + 2 * p - 3) // 2 + 1 for g, p in zip(grid, pad))
    padt = torch.tensor(pad, dtype=torch.int64, device=coords.device)
    offs = torch.from_numpy(OFFSETS + 1).to(coords.device)    # k in 0..2
    outs = []
    for k in offs:
        t = coords + padt - k                  # 2 * o
        even = ((t % 2) == 0).all(-1)
        o = torch.div(t[even], 2, rounding_mode="floor")
        outs.append(o[_inside(o, out_grid)])
    allo = torch.cat(outs)
    lin = torch.unique(_lin(allo, out_grid))
    oc = torch.stack([lin // (out_grid[1] * out_grid[2]),
                      (lin // out_grid[2]) % out_grid[1],
                      lin % out_grid[2]], -1)
    return oc, out_grid, int(allo.shape[0])


def k2_least_s(work: List[ConvWork]) -> float:
    """The least time the card could take for the convs K2 computes: each
    the larger of its FLOP over the bf16 peak and its bytes over HBM's
    rate (peaks.py)."""
    return sum(max(w.flop / peaks.BF16_FLOP_PER_S,
                   w.bytes / peaks.HBM_BYTES_PER_S) for w in work if w.k2)


def encoder_work(convs: List[dict], coords: torch.Tensor, grid,
                 esz: int) -> List[ConvWork]:
    """The work of each layer of `convs` (the configuration's
    `sparse.convs`) on the level-0 active set `coords` of grid `grid`;
    esz the activations' element size in bytes."""
    out = []
    for i, cv in enumerate(convs):
        ci, co, kind = cv["ci"], cv["co"], cv["kind"]
        n_in = coords.shape[0]
        if kind == "subm":
            pairs, taps = subm_pairs(coords, grid), 27
        elif kind == "point":
            pairs, taps = n_in, 1
        elif kind == "down":
            coords, grid, pairs = down(coords, grid, cv["pad"])
            taps = 27
        else:
            raise ValueError(f"unknown sparse conv kind {kind}")
        n_out = coords.shape[0]
        nbytes = (n_in * ci + n_out * co + taps * ci * co) * esz
        out.append(ConvWork(cv.get("name", f"conv{i}"), kind,
                            bool(cv.get("k2", False)), pairs,
                            2 * ci * co * pairs, nbytes))
    return out
