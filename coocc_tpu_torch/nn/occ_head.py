"""Occupancy head: multi-scale blend -> class logits + cascade refinement.

Counterpart of coocc_tpu/nn/occ_head.py `OccHead` at eval (reference
dense_heads/occ_head.py:16-237). The coarse half: per-level conv+BN+ReLU,
softmax-weighted blend of all levels at the finest one, 1x1x1 prediction
stack. The cascade re-classifies the ratio^3 children of the occupied
coarse cells: the first `max_coarse_occupied` occupied cells in index order
(a static capacity, exactly as the JAX package caps it), their children's
trilinear samples of the blended features (F.grid_sample 3D,
align_corners=False) and the masked camera-sum of bilinear samples of the
image features (F.grid_sample 2D, align_corners=True), then the fine MLP.
The fc layers run after the sampling, as in the reference; the JAX package
folds them into the sampled tables, which is the same linear map.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config.base import OccHeadConfig
from .layers import BatchNorm


def select_occupied(coarse_mask: torch.Tensor, capacity: int):
    """[X, Y, Z] bool -> ([capacity, 3] int32 coords, [capacity] bool valid):
    the first `capacity` occupied cells in index order; unused slots hold
    cell (0, 0, 0) with valid False."""
    X, Y, Z = coarse_mask.shape
    occupied = coarse_mask.reshape(-1).nonzero()[:capacity, 0]
    idx = torch.zeros(capacity, dtype=torch.int64, device=coarse_mask.device)
    idx[:occupied.shape[0]] = occupied
    valid = torch.arange(capacity, device=coarse_mask.device) \
        < occupied.shape[0]
    coords = torch.stack([idx // (Y * Z), (idx // Z) % Y, idx % Z], dim=-1)
    return coords.to(torch.int32), valid


def fine_coordinates(coarse_coords: torch.Tensor, ratio: int) -> torch.Tensor:
    """[K, 3] coarse -> [K * ratio^3, 3] fine children (child-minor)."""
    r = torch.arange(ratio, device=coarse_coords.device)
    cell = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1)
    fine = coarse_coords[:, None, :] * ratio + cell.reshape(1, -1, 3)
    return fine.reshape(-1, 3).to(torch.int32)


def project_points_on_img(points, rots, trans, intrins, post_rots, post_trans,
                          bda, pts_range, img_hw, occ_whd):
    """Fine voxel coords -> normalized image uv per camera + validity mask
    (reference utils/coordinate_transform.py:25-66, 'nus' branch).

    points [P, 3] float; rots/intrins/post_rots [N, 3, 3]; trans/post_trans
    [N, 3]; bda [3, 3]. Returns uv [N, P, 2] and mask [N, P].
    """
    W_occ, H_occ, D_occ = occ_whd
    H_img, W_img = img_hw
    pr = torch.as_tensor(pts_range, dtype=torch.float32, device=points.device)
    voxel_size = (pr[3:] - pr[:3]) / torch.tensor(
        [W_occ - 1, H_occ - 1, D_occ - 1], dtype=torch.float32,
        device=points.device)
    pts = points * voxel_size[None] + pr[:3][None]
    pts = pts @ torch.linalg.inv(bda).T
    p = pts[None] - trans[:, None, :]
    p = torch.einsum("nij,npj->npi", torch.linalg.inv(rots), p)
    p = torch.einsum("nij,npj->npi", intrins, p)
    d = p[..., 2:3]
    uv = p[..., :2] / (d + 1e-5)
    uv = torch.einsum("nij,npj->npi", post_rots[:, :2, :2], uv) \
        + post_trans[:, None, :2]
    u = (uv[..., 0] / (W_img - 1) - 0.5) * 2
    v = (uv[..., 1] / (H_img - 1) - 0.5) * 2
    mask = (d[..., 0] > 1e-5) & (u > -1) & (u < 1) & (v > -1) & (v < 1)
    return torch.stack([u, v], dim=-1), mask


def _conv_bn_relu(cin, cout, k, p):
    return nn.Sequential(nn.Conv3d(cin, cout, k, 1, p, bias=False),
                         BatchNorm(cout), nn.ReLU())


class OccHead(nn.Module):
    def __init__(self, cfg: OccHeadConfig, img_channels: int = 512):
        super().__init__()
        self.cfg = cfg
        self.occ_convs = nn.ModuleList(
            _conv_bn_relu(c, c // 2, 3, 1) for c in cfg.in_channels)
        mid = cfg.in_channels[0] // 2
        pred = _conv_bn_relu(mid, mid // 2, 1, 0)
        pred.append(nn.Conv3d(mid // 2, cfg.out_channel, 1, bias=False))
        self.occ_pred_conv = pred
        if cfg.soft_weights:
            soft = _conv_bn_relu(mid, mid // 2, 1, 0)
            soft.append(nn.Conv3d(mid // 2, cfg.num_level, 1, bias=False))
            self.voxel_soft_weights = soft
        self.cascade = cfg.cascade_ratio != 1 and (
            cfg.sample_from_voxel or cfg.sample_from_img)
        if not self.cascade:
            return
        # the reference's hardcoded cascade widths (occ_head.py:66-82)
        vox_dim = mid if cfg.sample_from_voxel else 0
        img_dim = 64 if cfg.sample_from_img else 0
        if cfg.sample_from_img:
            self.img_mlp_0 = nn.Sequential(
                nn.Conv2d(img_channels, 128, 1), nn.GroupNorm(16, 128),
                nn.ReLU())
            self.img_mlp = nn.Sequential(
                nn.Linear(128, 64), nn.GroupNorm(16, 64), nn.ReLU())
        self.fine_mlp = nn.Sequential(
            nn.Linear(vox_dim + img_dim, 64), nn.GroupNorm(16, 64), nn.ReLU(),
            nn.Linear(64, cfg.out_channel))

    def coarse(self, voxel_feats):
        """list of [B, C_i, X_i, Y_i, Z_i] -> (blended [B, mid, X, Y, Z],
        logits [B, out, X, Y, Z]) at the finest level."""
        cfg = self.cfg
        outs = [conv(f) for conv, f in zip(self.occ_convs, voxel_feats)]
        if cfg.soft_weights:
            w = self.voxel_soft_weights(outs[0]).softmax(dim=1)
        else:
            w = outs[0].new_full(
                (outs[0].shape[0], cfg.num_level, *outs[0].shape[2:]),
                1.0 / cfg.num_level)
        size = outs[0].shape[2:]
        blended = 0
        for i, f in enumerate(outs):
            if f.shape[2:] != size:
                f = F.interpolate(f, size=size, mode="trilinear",
                                  align_corners=False)
            blended = blended + f * w[:, i:i + 1]
        return blended, self.occ_pred_conv(blended)

    def _fine(self, blended, imf, tr, coarse_mask):
        """One sample: blended [C, X, Y, Z]; imf [N, 128, fH, fW] or None;
        tr its six calibration tensors -> (logits, coords, valid)."""
        cfg = self.cfg
        ratio = cfg.cascade_ratio
        coords, valid = select_occupied(coarse_mask, cfg.max_coarse_occupied)
        fine = fine_coordinates(coords, ratio)
        fvalid = valid.repeat_interleave(ratio ** 3)
        fc = fine.float()
        W_occ, H_occ, D_occ = cfg.final_occ_size
        feats = []
        if cfg.sample_from_voxel:
            scale = torch.tensor([W_occ - 1, H_occ - 1, D_occ - 1],
                                 dtype=torch.float32, device=fc.device)
            grid = ((fc / scale - 0.5) * 2).reshape(1, -1, 1, 1, 3)
            # grid (x, y, z) indexes the volume's (W, H, D) = (X, Y, Z) axes
            vol = blended.permute(0, 3, 2, 1)[None]  # [1, C, Z, Y, X]
            s = F.grid_sample(vol, grid, mode="bilinear",
                              padding_mode="zeros", align_corners=False)
            feats.append(s[0, :, :, 0, 0].T)
        if imf is not None:
            uv, m = project_points_on_img(
                fc, *tr, pts_range=cfg.point_cloud_range,
                img_hw=cfg.input_size, occ_whd=cfg.final_occ_size)
            s = F.grid_sample(imf, uv[:, :, None], mode="bilinear",
                              padding_mode="zeros", align_corners=True)
            s = (s[..., 0] * m[:, None]).sum(dim=0)  # [128, P]
            feats.append(self.img_mlp(s.T))
        return self.fine_mlp(torch.cat(feats, dim=1)), fine, fvalid

    def forward(self, voxel_feats, img_feats=None, transform=None,
                coarse_only: bool = False):
        """voxel_feats: list of [B, C_i, X_i, Y_i, Z_i]; img_feats:
        [B, N, C2, fH, fW]; transform: (rots, trans, intrins, post_rots,
        post_trans, bda), batched.

        Returns {'occ': [B, X, Y, Z, out]} and, with the cascade,
        'fine_logits' [B, K*r^3, out], 'fine_coords' [B, K*r^3, 3],
        'fine_valid' [B, K*r^3] and 'fine_overflow' [B] (occupied cells past
        the capacity, which the cascade drops)."""
        cfg = self.cfg
        blended, logits = self.coarse(voxel_feats)
        out = {"occ": logits.permute(0, 2, 3, 4, 1)}
        if coarse_only or not self.cascade:
            return out
        imf = None
        if cfg.sample_from_img and img_feats is not None:
            B, N = img_feats.shape[:2]
            imf = self.img_mlp_0(img_feats.flatten(0, 1))
            imf = imf.reshape(B, N, *imf.shape[1:])
        occ_mask = logits.argmax(dim=1) != cfg.empty_idx  # [B, X, Y, Z]
        per = [self._fine(blended[b], None if imf is None else imf[b],
                          None if imf is None
                          else tuple(t[b] for t in transform), occ_mask[b])
               for b in range(logits.shape[0])]
        out["fine_logits"] = torch.stack([p[0] for p in per])
        out["fine_coords"] = torch.stack([p[1] for p in per])
        out["fine_valid"] = torch.stack([p[2] for p in per])
        n_occ = occ_mask.flatten(1).sum(dim=1)
        out["fine_overflow"] = (n_occ - cfg.max_coarse_occupied).clamp(min=0)
        return out
