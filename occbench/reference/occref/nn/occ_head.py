"""Occupancy head: multi-scale blend -> class logits + cascade refinement.

Counterpart of coocc_tpu/nn/occ_head.py `OccHead` (reference
dense_heads/occ_head.py:16-237). The coarse half: per-level conv+BN+ReLU,
softmax-weighted blend of all levels at the finest one, 1x1x1 prediction
stack, in the compute dtype. The cascade re-classifies the ratio^3 children
of the occupied coarse cells: the first `max_coarse_occupied` occupied cells
in index order (a static capacity, exactly as the JAX package caps it),
their children's trilinear samples of the blended features
(align_corners=False) and the masked camera-sum of bilinear samples of the
image features (align_corners=True), then the fine MLP. It follows the JAX
package's order, which sets its roundings in bf16: the fc weights are
folded into the sampled tables first (the same linear map), the samplers
round their weights to the compute dtype and sum in fp32
(ops/grid_sample.py), the accumulator, the GroupNorms and the last fc are
fp32. In training the cascade takes `fine_topk` cells instead, a random
subset of the occupied ones: the occupied cells in descending order of
their priorities (uniform draws, one per coarse cell, given by the caller)
by a stable sort, as JAX's `select_occupied` with an rng (JAX
occ_head.py:103-121, 271).

`project_points_on_img` follows the head's `data_type`: 'nus' (the
nuScenes layout) and 'kitti' (SemanticKITTI's 3x4 intrinsics and the
rotation block of the inverse BDA), as JAX's does.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config.base import OccHeadConfig
from ..ops.grid_sample import cascade_sample_3d, multicam_bilinear
from ..ops.interpolate import resize_trilinear_zxy
from .layers import BatchNorm, Conv3d, softmax


def select_occupied(coarse_mask: torch.Tensor, capacity: int,
                    priorities: torch.Tensor = None):
    """[X, Y, Z] bool -> ([capacity, 3] int32 coords, [capacity] bool valid).

    Eval (no priorities): the first `capacity` occupied cells in index
    order; unused slots hold cell (0, 0, 0) with valid False. Training
    (priorities [X*Y*Z] uniform in [0, 1)): the cells in descending order
    of priority, unoccupied ones at -inf, by a stable sort (JAX's
    argsort(-score)), the first `capacity` kept."""
    X, Y, Z = coarse_mask.shape
    flat = coarse_mask.reshape(-1)
    if priorities is not None:
        score = torch.where(flat, priorities, float("-inf"))
        idx = torch.sort(-score, stable=True).indices[:capacity]
        valid = flat[idx]
    else:
        occupied = flat.nonzero()[:capacity, 0]
        idx = torch.zeros(capacity, dtype=torch.int64,
                          device=coarse_mask.device)
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
                          bda, pts_range, img_hw, occ_whd, data_type="nus"):
    """Fine voxel coords -> normalized image uv per camera + validity mask
    (reference utils/coordinate_transform.py:25-66; JAX occ_head.py:149-195).

    'nus' applies the whole inverse BDA; 'kitti', or any 4x4 BDA, only the
    rotation block of its inverse (the translation is dropped, as the
    reference's kitti branch drops it). [N, 3, 4] intrinsics project the
    homogeneous camera points.

    points [P, 3] float; rots/post_rots [N, 3, 3]; intrins [N, 3, 3] or
    [N, 3, 4]; trans/post_trans [N, 3]; bda [3, 3] or [4, 4]. Returns uv
    [N, P, 2] and mask [N, P].
    """
    W_occ, H_occ, D_occ = occ_whd
    H_img, W_img = img_hw
    pr = torch.as_tensor(pts_range, dtype=torch.float32, device=points.device)
    voxel_size = (pr[3:] - pr[:3]) / torch.tensor(
        [W_occ - 1, H_occ - 1, D_occ - 1], dtype=torch.float32,
        device=points.device)
    pts = points * voxel_size[None] + pr[:3][None]
    inv_bda = torch.linalg.inv(bda)
    if data_type == "kitti" or inv_bda.shape[-1] == 4:
        inv_bda = inv_bda[:3, :3]
    pts = pts @ inv_bda.T
    p = pts[None] - trans[:, None, :]
    p = torch.einsum("nij,npj->npi", torch.linalg.inv(rots), p)
    if intrins.shape[-1] == 4:
        p = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
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
    return nn.Sequential(Conv3d(cin, cout, k, 1, p, bias=False),
                         BatchNorm(cout), nn.ReLU())


class OccHead(nn.Module):
    def __init__(self, cfg: OccHeadConfig, img_channels: int = 512):
        super().__init__()
        self.cfg = cfg
        self.occ_convs = nn.ModuleList(
            _conv_bn_relu(c, c // 2, 3, 1) for c in cfg.in_channels)
        mid = cfg.in_channels[0] // 2
        pred = _conv_bn_relu(mid, mid // 2, 1, 0)
        pred.append(Conv3d(mid // 2, cfg.out_channel, 1, bias=False))
        self.occ_pred_conv = pred
        if cfg.soft_weights:
            soft = _conv_bn_relu(mid, mid // 2, 1, 0)
            soft.append(Conv3d(mid // 2, cfg.num_level, 1, bias=False))
            self.voxel_soft_weights = soft
        self.cascade = cfg.cascade_ratio != 1 and (
            cfg.sample_from_voxel or cfg.sample_from_img)
        if not self.cascade:
            return
        # the reference's hardcoded cascade widths (occ_head.py:66-82); the
        # cascade reads these modules' parameters (see _fine)
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
        logits [B, out, X, Y, Z]) at the finest level: the logits in the
        features' dtype (the blend weights too, JAX occ_head.py:223), the
        blend in fp32 where a level's resize (ops/interpolate.py) promoted
        it, as JAX's does."""
        cfg = self.cfg
        outs = [conv(f) for conv, f in zip(self.occ_convs, voxel_feats)]
        if cfg.soft_weights:
            w = softmax(self.voxel_soft_weights(outs[0]), dim=1)
        else:
            w = outs[0].new_full(
                (outs[0].shape[0], cfg.num_level, *outs[0].shape[2:]),
                1.0 / cfg.num_level)
        size = outs[0].shape[2:]
        blended = 0
        for i, f in enumerate(outs):
            if f.shape[2:] != size:
                f = resize_trilinear_zxy(f, size)
            blended = blended + f * w[:, i:i + 1]
        return blended, self.occ_pred_conv(blended.to(outs[0].dtype))

    def _fine(self, vox_t, img_t, tr, coarse_mask, cd, cap, priorities):
        """One sample: vox_t [X, Y, Z, 64] (cd) the blended features times
        fc1's voxel rows, img_t [N, fH, fW, 64] (fp32) the image features
        times img_mlp's fc, or None each; tr its six calibration tensors;
        cap cells chosen by `select_occupied` -> (logits, coords, valid)."""
        cfg = self.cfg
        ratio = cfg.cascade_ratio
        coords, valid = select_occupied(coarse_mask, cap, priorities)
        fine = fine_coordinates(coords, ratio)
        fvalid = valid.repeat_interleave(ratio ** 3)
        fc1, gn, fc2 = self.fine_mlp[0], self.fine_mlp[1], self.fine_mlp[3]
        # fp32 accumulator seeded with fc1's bias (JAX occ_head.py:317-319)
        acc = fc1.bias.float().expand(fine.shape[0], -1)
        if vox_t is not None:
            acc = acc + cascade_sample_3d(vox_t, fine,
                                          cfg.final_occ_size).float()
        if img_t is not None:
            uv, m = project_points_on_img(
                fine.float(), *tr, pts_range=cfg.point_cloud_range,
                img_hw=cfg.input_size, occ_whd=cfg.final_occ_size,
                data_type=cfg.data_type)
            fci, gni = self.img_mlp[0], self.img_mlp[1]
            s = multicam_bilinear(img_t, uv, m, cd) + fci.bias.to(cd)
            s = F.relu(F.group_norm(s.float(), gni.num_groups, gni.weight,
                                    gni.bias, gni.eps)).to(cd)
            k1_img = fc1.weight[:, fc1.in_features - s.shape[1]:]
            acc = acc + (s @ k1_img.T.to(cd)).float()
        x = F.relu(F.group_norm(acc, gn.num_groups, gn.weight, gn.bias,
                                gn.eps))
        return F.linear(x, fc2.weight, fc2.bias), fine, fvalid

    def forward(self, voxel_feats, img_feats=None, transform=None,
                coarse_only: bool = False, fine_priorities=None):
        """voxel_feats: list of [B, C_i, X_i, Y_i, Z_i]; img_feats:
        [B, N, C2, fH, fW]; transform: (rots, trans, intrins, post_rots,
        post_trans, bda), batched; fine_priorities [B, X*Y*Z] the training
        cascade's (see select_occupied), required in training.

        Returns {'occ': [B, X, Y, Z, out]} and, with the cascade,
        'fine_logits' [B, K*r^3, out], 'fine_coords' [B, K*r^3, 3],
        'fine_valid' [B, K*r^3] and 'fine_overflow' [B] (occupied cells past
        the capacity, which the cascade drops)."""
        cfg = self.cfg
        blended, logits = self.coarse(voxel_feats)
        out = {"occ": logits.permute(0, 2, 3, 4, 1)}
        if coarse_only or not self.cascade:
            return out
        # the fc weights are folded into the sampled tables (JAX
        # occ_head.py:300-304): sample(T) @ W == sample(T @ W)
        # blended is fp32 where a level's resize promoted it (JAX too): the
        # product with the fc's cd-rounded rows is then fp32, and the
        # sampler rounds its table to cd (JAX occ_head.py:303, grid_sample
        # .py:cascade_sample_3d)
        cd = logits.dtype
        fc1 = self.fine_mlp[0]
        vox_t = img_t = None
        if cfg.sample_from_voxel:
            vox_t = (blended.permute(0, 2, 3, 4, 1) @ fc1.weight[
                :, :blended.shape[1]].T.to(cd).to(blended.dtype)
            ).to(cd)                                        # [B, X, Y, Z, 64]
        if cfg.sample_from_img and img_feats is not None:
            # flax's default dtype: img_mlp_0 runs in fp32, and its product
            # with the fc (rounded to cd) too
            B, N = img_feats.shape[:2]
            imf = self.img_mlp_0(img_feats.flatten(0, 1).float())
            img_t = imf.permute(0, 2, 3, 1) @ self.img_mlp[0].weight.T.to(
                cd).float()
            img_t = img_t.reshape(B, N, *img_t.shape[1:])  # [B, N, fH, fW, 64]
        occ_mask = logits.argmax(dim=1) != cfg.empty_idx  # [B, X, Y, Z]
        cap = cfg.fine_topk if self.training else cfg.max_coarse_occupied
        if self.training and fine_priorities is None:
            raise ValueError("the training cascade needs fine_priorities")
        per = [self._fine(None if vox_t is None else vox_t[b],
                          None if img_t is None else img_t[b],
                          None if img_t is None
                          else tuple(t[b] for t in transform), occ_mask[b],
                          cd, cap, None if not self.training
                          else fine_priorities[b])
               for b in range(logits.shape[0])]
        out["fine_logits"] = torch.stack([p[0] for p in per])
        out["fine_coords"] = torch.stack([p[1] for p in per])
        out["fine_valid"] = torch.stack([p[2] for p in per])
        n_occ = occ_mask.flatten(1).sum(dim=1)
        out["fine_overflow"] = (n_occ - cap).clamp(min=0).to(torch.int32)
        return out


def forward_lidarseg(voxel_logits, points, points_mask,
                     pc_range) -> torch.Tensor:
    """Per-point class logits sampled from the voxel prediction
    (JAX occ_head.py:forward_lidarseg; reference OccHead.forward_lidarseg,
    occ_head.py:339-379): each point's (x, y, z) normalized into [-1, 1]
    over the pc range, the logits sampled trilinearly in fp32 (border
    padding, align_corners=True), masked.

    voxel_logits [B, X, Y, Z, C]; points [B, Q, >=3]; points_mask [B, Q]
    -> [B, Q, C] fp32."""
    pr = torch.as_tensor(pc_range, dtype=torch.float32, device=points.device)
    lo, extent = pr[:3], pr[3:] - pr[:3]
    norm = (points[..., :3].float() - lo) / extent * 2.0 - 1.0
    # torch's 5-D grid (x, y, z) indexes (W, H, D): the volume is
    # [B, C, Z, Y, X], as JAX transposes it to [Z, Y, X, C]
    vol = voxel_logits.float().permute(0, 4, 3, 2, 1)
    out = F.grid_sample(vol, norm[:, None, None], mode="bilinear",
                        padding_mode="border",
                        align_corners=True)    # [B, C, 1, 1, Q]
    return out[:, :, 0, 0].transpose(1, 2) * points_mask[..., None]
