"""Stand-alone NeRF-style ray library (stratified + importance sampling).

Counterpart of coocc_tpu/models/render_ray.py (the reference's
projects/mmdet3d_plugin/utils/render_ray.py: IBRNet-style ray batches,
`sample_along_camera_ray`, `raw2outputs` alpha compositing, `sample_pdf`
importance resampling; utils/projection.py's Projector). The live path
renders the LSS frustum inline (models/renderer.py); this is the general
ray API for arbitrary ray batches, on the rays' device.

Where JAX takes a PRNG key, the port takes a `torch.Generator` on the
rays' device: with one, the stratified pass jitters within each bin and the
importance pass draws its u; without, bin centres and evenly spaced u
(deterministic, as JAX's without a key).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.grid_sample import grid_sample_2d


class RaySamples(NamedTuple):
    pts: torch.Tensor      # [R, S, 3] sample positions
    z_vals: torch.Tensor   # [R, S] depths along the ray


def sample_along_camera_ray(ray_o: torch.Tensor, ray_d: torch.Tensor,
                            near: float, far: float, n_samples: int,
                            generator: Optional[torch.Generator] = None
                            ) -> RaySamples:
    """Stratified depths in n_samples equal bins of [near, far]: with a
    generator a uniform draw within each bin (training), else the bins'
    centres (eval). ray_o, ray_d [R, 3]."""
    R = ray_o.shape[0]
    dev = ray_o.device
    t = torch.linspace(0.0, 1.0, n_samples + 1, device=dev)
    edges = near * (1 - t) + far * t                   # [S+1]
    lo, hi = edges[:-1], edges[1:]
    if generator is not None:
        u = torch.rand((R, n_samples), generator=generator, device=dev)
    else:
        u = torch.full((R, n_samples), 0.5, device=dev)
    z_vals = lo[None] + (hi - lo)[None] * u
    pts = ray_o[:, None, :] + ray_d[:, None, :] * z_vals[..., None]
    return RaySamples(pts=pts, z_vals=z_vals)


def raw2outputs(rgb: torch.Tensor, sigma: torch.Tensor,
                z_vals: torch.Tensor, white_bkgd: bool = False):
    """Alpha compositing: rgb [R, S, 3], sigma [R, S], z_vals [R, S] ->
    (rgb_map [R, 3], depth_map [R], weights [R, S])."""
    dists = torch.diff(z_vals, dim=-1)
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - weights.sum(-1)[..., None])
    return rgb_map, depth_map, weights


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               generator: Optional[torch.Generator] = None,
               det: bool = False) -> torch.Tensor:
    """Importance resampling by the piecewise-constant pdf over `bins`:
    bins [R, B+1], weights [R, B] -> [R, n_importance] depths. u evenly
    spaced in [0, 1] when det or no generator, else drawn; each u's bin is
    found as JAX's searchsorted(side="right") finds it."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    R = bins.shape[0]
    dev = bins.device
    if det or generator is None:
        u = torch.linspace(0.0, 1.0, n_importance, device=dev).expand(
            R, n_importance).contiguous()
    else:
        u = torch.rand((R, n_importance), generator=generator, device=dev)
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (idx - 1).clamp(0, cdf.shape[-1] - 1)
    above = idx.clamp(0, cdf.shape[-1] - 1)
    cdf_lo = torch.gather(cdf, -1, below)
    cdf_hi = torch.gather(cdf, -1, above)
    nb = bins.shape[-1]
    bin_lo = torch.gather(bins, -1, below.clamp(0, nb - 1))
    bin_hi = torch.gather(bins, -1, above.clamp(0, nb - 1))
    denom = torch.where(cdf_hi - cdf_lo < 1e-5, torch.ones_like(cdf_hi),
                        cdf_hi - cdf_lo)
    t = (u - cdf_lo) / denom
    return bin_lo + t * (bin_hi - bin_lo)


def render_rays(ray_o, ray_d, feature_fn, rgb_sigma_fn, near, far,
                n_samples: int, n_importance: int = 0,
                generator: Optional[torch.Generator] = None,
                white_bkgd: bool = False):
    """A stratified pass and, with n_importance > 0, an importance pass
    over the coarse weights (JAX's control flow, static shapes).
    feature_fn(pts [R, S, 3]) -> features; rgb_sigma_fn(features) ->
    (rgb [R, S, 3], sigma [R, S]). Deterministic without a generator."""
    coarse = sample_along_camera_ray(ray_o, ray_d, near, far, n_samples,
                                     generator)
    rgb, sigma = rgb_sigma_fn(feature_fn(coarse.pts))
    rgb_map, depth_map, weights = raw2outputs(rgb, sigma, coarse.z_vals,
                                              white_bkgd)
    out = {"rgb": rgb_map, "depth": depth_map, "weights": weights,
           "z_vals": coarse.z_vals}
    if n_importance > 0:
        z = coarse.z_vals
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        edges = torch.cat([z[..., :1], mids, z[..., -1:]], -1)
        z_fine = sample_pdf(edges, weights, n_importance, generator,
                            det=generator is None)
        z_all = torch.sort(torch.cat([z, z_fine], -1), dim=-1).values
        pts = ray_o[:, None, :] + ray_d[:, None, :] * z_all[..., None]
        rgb2, sigma2 = rgb_sigma_fn(feature_fn(pts))
        rgb_map2, depth_map2, w2 = raw2outputs(rgb2, sigma2, z_all,
                                               white_bkgd)
        out.update({"rgb_fine": rgb_map2, "depth_fine": depth_map2,
                    "weights_fine": w2, "z_vals_fine": z_all})
    return out


class Projector:
    """World point -> multi-view image-feature sampler (the reference's
    utils/projection.py Projector: projections and the in-bounds mask).
    The matrices lie on the points' device. The rotations are inverted
    once, where they are given (`inv_ex`, which does not sync on a card),
    so a projection adds no host sync."""

    def __init__(self, intrins, rots, trans, img_hw):
        self.intrins = intrins                          # [N, 3, 3]
        self.inv_rots = torch.linalg.inv_ex(rots).inverse   # ego -> cam
        self.trans = trans                              # [N, 3]
        self.img_hw = img_hw

    def project(self, pts: torch.Tensor):
        """pts [P, 3] ego-frame -> (uv [N, P, 2] pixel coords, mask
        [N, P]: in front of the camera and inside the image)."""
        H, W = self.img_hw
        rel = pts[None, :, :] - self.trans[:, None, :]  # [N, P, 3]
        p = torch.einsum("nij,npj->npi", self.inv_rots, rel)
        p = torch.einsum("nij,npj->npi", self.intrins, p)
        d = p[..., 2:3]
        uv = p[..., :2] / d.clamp(min=1e-5)
        mask = ((d[..., 0] > 1e-5) & (uv[..., 0] >= 0) & (uv[..., 0] < W)
                & (uv[..., 1] >= 0) & (uv[..., 1] < H))
        return uv, mask

    def sample(self, feats: torch.Tensor, pts: torch.Tensor, *,
               align_corners: bool = True):
        """feats [N, C, fH, fW]; pts [P, 3] -> (samples [N, P, C] zeroed
        where the mask is False, mask [N, P])."""
        H, W = self.img_hw
        uv, mask = self.project(pts)
        if align_corners:
            grid = torch.stack([(uv[..., 0] / (W - 1) - 0.5) * 2,
                                (uv[..., 1] / (H - 1) - 0.5) * 2], -1)
        else:
            # pixel centres at (i + 0.5) / W in [0, 1]
            grid = torch.stack([((uv[..., 0] + 0.5) / W - 0.5) * 2,
                                ((uv[..., 1] + 0.5) / H - 0.5) * 2], -1)
        s = grid_sample_2d(feats.movedim(1, -1), grid,
                           align_corners=align_corners, padding_mode="zeros")
        return s * mask[..., None], mask
