"""The gather-GEMM sparse 3D convolution engine, with static shapes.

Counterpart of coocc_tpu/ops/sparse_conv.py (JAX's stand-in for the
reference's spconv):

  * a sparse tensor is a fixed-capacity list of sorted linear voxel ids, a
    [A, C] feature matrix and a validity mask (`SparseTensor`; batched
    [B, A] in the encoders, one sample here);
  * a rulebook [A_out, K3] maps each (output site, kernel tap) to an input
    row, or to a row whose features are zero: the missing neighbours read
    row A (a zero row appended to the features), the invalid queries row
    `lut[n_cells]` of a LUT, as JAX's scatter leaves it (the last padding
    row, also zero). Rulebooks equal JAX's bit for bit: a dense cell-id ->
    row LUT on grids of at most `_LUT_MAX_CELLS` cells, a binary search
    over the sorted ids above (both find the same rows);
  * a conv is one gather of [A_out, K3, Cin] rows (`ops/gather.py:
    gather_rows`, whose backward sums in a fixed order) and one matmul of
    [A_out, K3*Cin] by [K3*Cin, Cout] in fp32 (`apply_conv`).

A strided conv's output sites (`downsample_sites`) are the sorted unique
covered sites under a static capacity, with no host sync: a sort,
first-of-run flags, their cumsum and a segment-min into out_capacity + 1
slots; overflow drops the largest ids, as JAX's does.

Ids are int64 here (int32 in JAX; the values are the same). Weights are
[K3, Cin, Cout] with the taps x-major (kx, ky, kz), offset = index - centre
(`nn/sparse_enc.py:taps` makes them from the reference's spconv layout).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .constants import device_constant
from .gather import gather_rows
from .voxelize import delinearize, linearize

# grids with more cells than this look rows up by binary search, not by a
# dense LUT (JAX's threshold: the rulebooks are the same either way)
_LUT_MAX_CELLS = 4_000_000


class SparseTensor(NamedTuple):
    """A fixed-capacity sparse voxel tensor: ids [B, A] sorted linear
    voxel ids (num_cells in the padding), features [B, A, C], mask [B, A]
    bool. The engine's functions take one sample ([A], [A, C], [A])."""
    ids: object
    features: object
    mask: object


def num_cells(grid_size) -> int:
    nx, ny, nz = [int(g) for g in grid_size]
    return nx * ny * nz


def _as3(v) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(int(x) for x in v)


def conv_output_shape(grid_size, kernel, stride,
                      padding) -> Tuple[int, int, int]:
    """The output grid of a conv with these kernel, stride and padding."""
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    return tuple((int(g) + 2 * p[i] - k[i]) // s[i] + 1
                 for i, g in enumerate(grid_size))


def _kernel_offsets(kernel_size: int, device="cpu") -> torch.Tensor:
    """[K^3, 3] xyz offsets, x-major enumeration, offset = idx - centre."""
    r = kernel_size // 2
    offs = list(itertools.product(range(-r, r + 1), repeat=3))
    return device_constant(np.array(offs, np.int64), device)


def _kernel_taps(kernel, device="cpu") -> torch.Tensor:
    """[K3, 3] raw tap indices (0..k-1 per axis), x-major enumeration."""
    k = _as3(kernel)
    taps = list(itertools.product(range(k[0]), range(k[1]), range(k[2])))
    return device_constant(np.array(taps, np.int64), device)


def _in_grid(coords: torch.Tensor, grid_size) -> torch.Tensor:
    """[..., 3] -> [...] bool: inside the grid on every axis."""
    ok = coords >= 0
    for ax, g in enumerate(grid_size):
        ok[..., ax] &= coords[..., ax] < int(g)
    return ok.all(dim=-1)


def make_lut(ids: torch.Tensor, mask: torch.Tensor,
             n_cells: int) -> torch.Tensor:
    """Dense cell-id -> row table ([n_cells + 1] int64, a missing cell ->
    A). JAX's scatter writes the padding rows' index into slot n_cells,
    the last one winning: that slot holds the largest padding row, or A
    where every row is valid."""
    A = ids.shape[0]
    dev = ids.device
    rows = torch.arange(A, device=dev)
    # the padding rows go to a sink past the table, then slot n_cells gets
    # what JAX's in-order scatter leaves there
    lut = torch.full((n_cells + 2,), A, dtype=torch.int64, device=dev)
    lut.scatter_(0, torch.where(mask, ids, n_cells + 1), rows)
    last_pad = torch.where(mask, -1, rows).amax()
    lut[n_cells] = torch.where(last_pad >= 0, last_pad, A)
    return lut[:n_cells + 1]


def lookup(ids: torch.Tensor, queries: torch.Tensor,
           queries_valid: torch.Tensor, n_cells: Optional[int] = None,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each query id's row among `ids`; a missing or invalid query -> A.
    With n_cells (and the rows' mask): one gather from `make_lut`'s table,
    where an invalid query reads `lut[n_cells]`; else a binary search over
    the sorted ids."""
    A = ids.shape[0]
    if n_cells is not None:
        lut = make_lut(ids, mask, n_cells)
        q = torch.where(queries_valid, queries, n_cells)
        return lut[q.clamp(0, n_cells)]
    pos = torch.searchsorted(ids.contiguous(), queries.contiguous(),
                             side="left")
    pos_c = pos.clamp(max=A - 1)
    found = (ids[pos_c] == queries) & queries_valid & (pos < A)
    return torch.where(found, pos_c, A)


def _rulebook(in_ids, in_mask, query_ids, valid, grid_size):
    nc = num_cells(grid_size)
    q = torch.where(valid, query_ids, nc)
    if nc <= _LUT_MAX_CELLS:
        return lookup(in_ids, q, valid, n_cells=nc, mask=in_mask)
    return lookup(in_ids, q, valid)


def build_subm_rulebook(ids: torch.Tensor, mask: torch.Tensor, grid_size,
                        kernel_size: int = 3) -> torch.Tensor:
    """[A, K^3] rulebook of a submanifold conv (the output sites are the
    input's)."""
    offs = _kernel_offsets(kernel_size, ids.device)
    ncoords = delinearize(ids, grid_size)[:, None, :] + offs[None]
    valid = _in_grid(ncoords, grid_size) & mask[:, None]
    return _rulebook(ids, mask, linearize(ncoords, grid_size), valid,
                     grid_size)


def downsample_sites(ids: torch.Tensor, mask: torch.Tensor, grid_size,
                     out_grid_size, out_capacity: int, kernel=3, stride=2,
                     padding=1) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The active output sites of a strided sparse conv (per-axis kernel,
    stride and padding): output j reads inputs j*s + tap - p, so an active
    input i covers the outputs j in [ceil((i + p - k + 1) / s),
    (i + p) // s]. -> (the sorted unique output ids under the static
    capacity [out_capacity], their mask, the number of unique sites before
    the cap, a 0-d tensor). Overflow drops the largest ids."""
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    ncand = [-(-k[i] // s[i]) for i in range(3)]     # ceil(k/s) per axis
    dev = ids.device
    coords = delinearize(ids, grid_size)
    per_axis = []
    for ax in range(3):
        i = coords[:, ax]
        j_lo = -((-(i + p[ax] - k[ax] + 1)) // s[ax])
        j_hi = (i + p[ax]) // s[ax]
        cand = j_lo[:, None] + torch.arange(ncand[ax], device=dev)
        ok = (cand <= j_hi[:, None]) & (cand >= 0) \
            & (cand < int(out_grid_size[ax]))
        per_axis.append((cand, ok))
    (cx, okx), (cy, oky), (cz, okz) = per_axis
    A = coords.shape[0]
    n0, n1, n2 = ncand
    shape = (A, n0, n1, n2)
    ccoords = torch.stack([cx[:, :, None, None].expand(shape),
                           cy[:, None, :, None].expand(shape),
                           cz[:, None, None, :].expand(shape)], -1)
    ok = (okx[:, :, None, None] & oky[:, None, :, None]
          & okz[:, None, None, :]).reshape(-1)
    valid = ok & mask.repeat_interleave(n0 * n1 * n2)
    sentinel = num_cells(out_grid_size)
    cids = torch.where(valid, linearize(ccoords.clamp(min=0).reshape(-1, 3),
                                        out_grid_size), sentinel)
    cids_sorted = torch.sort(cids).values
    real = cids_sorted < sentinel
    is_first = torch.ones_like(real)
    is_first[1:] = cids_sorted[1:] != cids_sorted[:-1]
    is_first &= real
    seg = torch.cumsum(is_first, 0) - 1
    # past the capacity (and the padding) -> slot out_capacity, cut below
    seg = torch.where(real, seg, out_capacity).clamp(max=out_capacity)
    out_ids = torch.full((out_capacity + 1,), sentinel, dtype=torch.int64,
                         device=dev).scatter_reduce(
        0, seg, torch.where(is_first, cids_sorted, sentinel), "amin")
    n_unique = is_first.sum()
    out_mask = torch.arange(out_capacity, device=dev) < n_unique
    out_ids = torch.where(out_mask, out_ids[:out_capacity], sentinel)
    return out_ids, out_mask, n_unique


def build_strided_rulebook(in_ids: torch.Tensor, in_mask: torch.Tensor,
                           out_ids: torch.Tensor, out_mask: torch.Tensor,
                           grid_size, out_grid_size, kernel=3, stride=2,
                           padding=1) -> torch.Tensor:
    """[A_out, prod(k)] rulebook: the input coord = out * s + tap - p per
    axis."""
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    dev = out_ids.device
    sv = device_constant(np.array(s, np.int64), dev)
    pv = device_constant(np.array(p, np.int64), dev)
    icoords = delinearize(out_ids, out_grid_size)[:, None, :] * sv \
        + _kernel_taps(k, dev)[None] - pv
    valid = _in_grid(icoords, grid_size) & out_mask[:, None]
    return _rulebook(in_ids, in_mask,
                     linearize(icoords.clamp(min=0), grid_size), valid,
                     grid_size)


def apply_conv(features: torch.Tensor, mask: torch.Tensor,
               rulebook: torch.Tensor, weight: torch.Tensor,
               out_mask: torch.Tensor) -> torch.Tensor:
    """The gather-GEMM: features [A_in, Cin], rulebook [A_out, K3] (A_in:
    the zero row), weight [K3, Cin, Cout] -> [A_out, Cout] in fp32, times
    out_mask. The gather's backward sums each row's cotangents in a fixed
    order (`gather_rows`): `x[idx]`'s own is an atomic scatter-add."""
    A_in, Cin = features.shape
    K3 = rulebook.shape[1]
    feats_pad = torch.cat([features * mask[:, None],
                           features.new_zeros((1, Cin))])
    gathered = gather_rows(feats_pad, rulebook)       # [A_out, K3, Cin]
    out = torch.matmul(gathered.reshape(-1, K3 * Cin).float(),
                       weight.reshape(K3 * Cin, -1).float())
    return out * out_mask[:, None]


def subm_conv(ids: torch.Tensor, features: torch.Tensor, mask: torch.Tensor,
              rulebook: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A submanifold conv's output features [A, Cout] in the input's
    dtype."""
    return apply_conv(features, mask, rulebook, weight, mask).to(
        features.dtype)


def to_dense(ids: torch.Tensor, features: torch.Tensor, mask: torch.Tensor,
             grid_size) -> torch.Tensor:
    """-> [nx, ny, nz, C] (channels-last, xyz order); each valid id is
    written once, the padding adds zeros to a sink row."""
    nx, ny, nz = [int(g) for g in grid_size]
    C = features.shape[-1]
    flat = features.new_zeros((nx * ny * nz + 1, C)).index_add(
        0, torch.where(mask, ids, nx * ny * nz), features * mask[:, None])
    return flat[:-1].reshape(nx, ny, nz, C)


def from_dense(x: torch.Tensor, capacity: int) -> SparseTensor:
    """Dense [nx, ny, nz, C] -> (ids, features, mask) of its nonzero sites
    (any channel != 0), ranked by linear id; overflow beyond capacity drops
    the largest ids."""
    nx, ny, nz, C = x.shape
    flat = x.reshape(-1, C)
    sentinel = nx * ny * nz
    keyed = torch.where((flat != 0).any(dim=-1),
                        torch.arange(sentinel, device=x.device), sentinel)
    top = torch.sort(keyed).values[:capacity]
    mask = top < sentinel
    feats = flat[top.clamp(max=sentinel - 1)] * mask[:, None]
    return SparseTensor(top, feats, mask)
