"""Bilinear and trilinear samplers, with the JAX package's roundings.

Counterpart of coocc_tpu/ops/grid_sample.py: `grid_sample_2d` and
`grid_sample_3d` with torch's F.grid_sample conventions (both
align_corners settings, zeros or border padding; the plane-sweep warp of
the stereo depth net takes align_corners=True and zeros), and the cascade's
`cascade_sample_3d` and `multicam_bilinear_gemm` (align_corners=True). The
cascade's JAX functions take a compute dtype: they form the interpolation
weights, round them to it, sum weight x table products in fp32 and round
the result to it once. The JAX versions do that as one-hot GEMMs, which the
TPU runs fast; here each is a gather of the corners' rows and a weighted
sum, the same products summed in another order (fp32 rounding apart).
"""
from __future__ import annotations

import itertools

import torch

from .gather import gather_rows


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _pixel_coords(grid, sizes, align_corners, padding_mode):
    """grid [..., n] in [-1, 1], its last axis (x, y[, z]) over the sizes
    (W, H[, D]) -> the unnormalized coordinates, clipped into the map under
    border padding (JAX's order of operations)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode {padding_mode!r}: zeros or border")
    out = []
    for a, n in enumerate(sizes):
        c = _unnormalize(grid[..., a], n, align_corners)
        if padding_mode == "border":
            # jnp.clip's min(max(.)): a coordinate on the edge passes half
            # its gradient, as JAX's does
            c = torch.minimum(torch.maximum(c, c.new_zeros(())),
                              c.new_full((), n - 1))
        out.append(c)
    return out


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor, *,
                   align_corners: bool = True,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear samples of channels-last maps, as JAX's `grid_sample_2d`
    computes them (torch's F.grid_sample conventions), one map per leading
    index: img [B, H, W, C]; grid [B, ..., 2] (x, y) in [-1, 1] ->
    [B, ..., C]. Each corner's row is gathered in img's dtype and, under
    zeros padding, zeroed outside the map, then weighted by (1 - wx or wx)
    and (1 - wy or wy) in the grid's dtype, and the four products summed
    in JAX's order: a bf16 map under an fp32 grid gives fp32 samples. The
    rows come through `_corner_rows`: where the map takes a gradient, one
    fixed-order gather of all four corners (ops/gather.py); the grid's
    gradient flows through the weights."""
    B, H, W, C = img.shape
    lead = grid.shape[1:-1]
    ix, iy = _pixel_coords(grid, (W, H), align_corners, padding_mode)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx, wy = (ix - x0)[..., None], (iy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    table = img.reshape(B * H * W, C)
    base = (torch.arange(B, device=img.device) * (H * W)).reshape(
        (B,) + (1,) * len(lead))
    both = [(x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)]
    rows = _corner_rows(table, (
        base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        for xi, yi in both))
    c00, c01, c10, c11 = (
        v * ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))[..., None].to(
            v.dtype) if padding_mode == "zeros" else v
        for v, (xi, yi) in zip(rows, both))
    return (c00 * (1 - wx) * (1 - wy) + c01 * wx * (1 - wy)
            + c10 * (1 - wx) * wy + c11 * wx * wy)


def grid_sample_3d(vol: torch.Tensor, grid: torch.Tensor, *,
                   align_corners: bool = False,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Trilinear samples of channels-last volumes, as JAX's
    `grid_sample_3d` computes them: vol [B, D, H, W, C]; grid [B, ..., 3]
    (x, y, z) in [-1, 1], x indexing W (innermost), y H, z D, torch's 5-D
    convention -> [B, ..., C]. The eight corners summed in JAX's order (z,
    then y, then x slowest to fastest), each row times wx * wy * wz in
    that order; zeros padding zeroes a row outside the volume, border
    padding clips the coordinates first. Rows through `_corner_rows`."""
    B, D, H, W, C = vol.shape
    lead = grid.shape[1:-1]
    ix, iy, iz = _pixel_coords(grid, (W, H, D), align_corners, padding_mode)
    x0, y0, z0 = (torch.floor(c) for c in (ix, iy, iz))
    wx, wy, wz = ((c - c0)[..., None] for c, c0 in ((ix, x0), (iy, y0),
                                                       (iz, z0)))
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    table = vol.reshape(B * D * H * W, C)
    base = (torch.arange(B, device=vol.device) * (D * H * W)).reshape(
        (B,) + (1,) * len(lead))
    taps = [((z0 + dz, wz_), (y0 + dy, wy_), (x0 + dx, wx_))
            for dz, wz_ in ((0, 1 - wz), (1, wz))
            for dy, wy_ in ((0, 1 - wy), (1, wy))
            for dx, wx_ in ((0, 1 - wx), (1, wx))]
    rows = _corner_rows(table, (
        base + (zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W
        + xi.clamp(0, W - 1) for (zi, _), (yi, _), (xi, _) in taps))
    out = 0.0
    for v, ((zi, w_z), (yi, w_y), (xi, w_x)) in zip(rows, taps):
        if padding_mode == "zeros":
            inb = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (zi >= 0)
                   & (zi < D))
            v = v * inb[..., None].to(v.dtype)
        out = out + v * w_x * w_y * w_z
    return out


def _corner_rows(table: torch.Tensor, idxs):
    """Each corner's rows of `table` at the indices `idxs` yields, in
    order. Where the table takes a gradient, one gather_rows of every
    corner: its backward sums each row's cotangents in one fixed-order
    pass (ops/gather.py), and a call costs some 20 small kernels. Without
    one, each corner's indices and gather as the caller reaches them, so
    that no two are held at once (all 8 took 2.8 GB at OpenOccupancy's
    cascade)."""
    if torch.is_grad_enabled() and table.requires_grad:
        return gather_rows(table, torch.stack(tuple(idxs)))
    return (table[i] for i in idxs)


def _axis_corners(fine: torch.Tensor, S: int, V: int):
    """Trilinear corners of fine coords [P] along one axis of a V-cell grid
    sampled as an S-cell one (grid_sample, align_corners=False, zeros
    padding): ((index [P] clamped into the grid, weight [P] fp32, zero
    outside the grid)) for the low and the high corner."""
    normf = (fine.float() / (S - 1) - 0.5) * 2
    ix = ((normf + 1.0) * V - 1.0) / 2.0
    x0 = torch.floor(ix)
    f = ix - x0
    x0 = x0.long()
    out = []
    for xi, w in ((x0, 1 - f), (x0 + 1, f)):
        ok = (xi >= 0) & (xi < V)
        out.append((xi.clamp(0, V - 1), w * ok))
    return out


def cascade_sample_3d(vol: torch.Tensor, fine: torch.Tensor,
                      final_size) -> torch.Tensor:
    """vol [X, Y, Z, C] in the compute dtype; fine [P, 3] integer coords of
    the final_size grid. Returns the trilinear samples [P, C] in vol's dtype:
    each corner's weight wx*wy*wz formed in fp32 and rounded to vol's dtype,
    the products summed in fp32, the sum rounded once."""
    X, Y, Z, C = vol.shape
    table = vol.reshape(X * Y * Z, C)
    corners = [_axis_corners(fine[:, a], int(final_size[a]), n)
               for a, n in enumerate((X, Y, Z))]
    out = torch.zeros(fine.shape[0], C, dtype=torch.float32,
                      device=vol.device)
    both = list(itertools.product(*corners))
    rows = _corner_rows(table, ((xi * Y + yi) * Z + zi for (
        xi, _), (yi, _), (zi, _) in both))
    for v, ((_, wx), (_, wy), (_, wz)) in zip(rows, both):
        w = (wx * wy * wz).to(vol.dtype).float()
        out += w[:, None] * v.float()
    return out.to(vol.dtype)


def multicam_bilinear(imgs: torch.Tensor, uv: torch.Tensor,
                      mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The masked camera-sum of bilinear samples (align_corners=True, zeros
    padding): imgs [N, H, W, C]; uv [N, P, 2] (x, y) in [-1, 1]; mask
    [N, P] -> [P, C] in `dtype`. As JAX computes it: the table is rounded to
    dtype, the fractional offsets too, each corner's weight
    (1 - wy or wy) * mask * (1 - wx or wx) is formed in dtype, and the
    products are summed in fp32 and rounded once."""
    N, H, W, C = imgs.shape
    table = imgs.reshape(N * H * W, C).to(dtype)
    ix = (uv[..., 0] + 1.0) / 2.0 * (W - 1)
    iy = (uv[..., 1] + 1.0) / 2.0 * (H - 1)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx, wy = (ix - x0).to(dtype), (iy - y0).to(dtype)
    x0, y0 = x0.long(), y0.long()
    md = mask.to(dtype)
    cam = torch.arange(N, device=imgs.device)[:, None] * (H * W)
    out = torch.zeros(uv.shape[1], C, dtype=torch.float32,
                      device=imgs.device)
    both = [(yi, w_y, xi, w_x) for yi, w_y in ((y0, 1 - wy), (y0 + 1, wy))
            for xi, w_x in ((x0, 1 - wx), (x0 + 1, wx))]
    rows = _corner_rows(table, (
        cam + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        for yi, _, xi, _ in both))                           # [N, P, C] each
    for v, (yi, w_y, xi, w_x) in zip(rows, both):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        w = (w_y * md * inb.to(dtype)) * w_x                 # [N, P]
        out += (w.float()[..., None] * v.float()).sum(0)
    return out.to(dtype)
