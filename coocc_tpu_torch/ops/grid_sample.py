"""Bilinear and trilinear samplers, with the JAX package's roundings.

Counterpart of coocc_tpu/ops/grid_sample.py `grid_sample_2d` (with
align_corners=True and zeros padding: the plane-sweep warp of the stereo
depth net) and the cascade's
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


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of channels-last maps, as JAX's `grid_sample_2d`
    computes them with align_corners=True and zeros padding (torch's
    F.grid_sample conventions), one map per leading index: img [B, H, W,
    C]; grid [B, ..., 2] (x, y) in [-1, 1] -> [B, ..., C]. Each corner's
    row is gathered in img's dtype and zeroed outside the map, then
    weighted by (1 - wx or wx) and (1 - wy or wy) in the grid's dtype, and
    the four products summed in JAX's order: a bf16 map under an fp32 grid
    gives fp32 samples. The gather is `img[idx]`: this is for maps that
    take no gradient (the stereo sweep's features are under stop-gradient);
    the grid's does flow, through the weights."""
    B, H, W, C = img.shape
    lead = grid.shape[1:-1]
    ix = (grid[..., 0] + 1.0) / 2.0 * (W - 1)
    iy = (grid[..., 1] + 1.0) / 2.0 * (H - 1)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx, wy = (ix - x0)[..., None], (iy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    table = img.reshape(B * H * W, C)
    base = (torch.arange(B, device=img.device) * (H * W)).reshape(
        (B,) + (1,) * len(lead))

    def corner(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = table[base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        return v * inb[..., None].to(v.dtype)

    return (corner(x0, y0) * (1 - wx) * (1 - wy)
            + corner(x0 + 1, y0) * wx * (1 - wy)
            + corner(x0, y0 + 1) * (1 - wx) * wy
            + corner(x0 + 1, y0 + 1) * wx * wy)


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
    for (xi, wx), (yi, wy), (zi, wz) in itertools.product(*corners):
        w = (wx * wy * wz).to(vol.dtype).float()
        out += w[:, None] * gather_rows(table, (xi * Y + yi) * Z + zi).float()
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
    for yi, w_y in ((y0, 1 - wy), (y0 + 1, wy)):
        for xi, w_x in ((x0, 1 - wx), (x0 + 1, wx)):
            inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            w = (w_y * md * inb.to(dtype)) * w_x             # [N, P]
            rows = cam + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
            v = gather_rows(table, rows.reshape(-1)).reshape(N, -1, C)
            out += (w.float()[..., None] * v.float()).sum(0)
    return out.to(dtype)
