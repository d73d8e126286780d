"""DepthNet supervision: min-pooled one-hot ground truth + masked BCE (and
the Gaussian-target KL variant).

Counterpart of coocc_tpu/losses/depth.py (reference
ViewTransformerLSSVoxel.py:31-100, utils/gaussian.py:92-135): ground-truth
depth maps are min-pooled to the frustum stride (0 = missing), binned into
D bins, and the per-pixel BCE against the predicted softmax is summed over
the foreground pixels and divided by their count. The prediction keeps its
dtype (bf16 in bf16) through the clip and the log, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def downsample_gt_depth(gt_depths, downsample: int, dbound, D: int):
    """[B, N, H, W] -> one-hot [B*N*h*w, D] fp32 (all zero: background)."""
    B, N, H, W = gt_depths.shape
    h, w = H // downsample, W // downsample
    x = gt_depths.reshape(B * N, h, downsample, w, downsample)
    x = x.permute(0, 1, 3, 2, 4).reshape(-1, downsample * downsample)
    x = torch.where(x == 0.0, 1e5, x)
    x = x.min(-1).values
    x = (x - (dbound[0] - dbound[2] / 2.0)) / dbound[2]
    x = torch.where((x < D + 1) & (x >= 0.0), x, 0.0)
    idx = x.to(torch.int32)
    bins = torch.arange(1, D + 1, device=x.device)
    return (idx[:, None] == bins[None, :]).float()


def bce_depth_loss(depth_prob, gt_depths, downsample: int, dbound):
    """depth_prob [B, N, fH, fW, D] softmax; gt_depths [B, N, H, W]."""
    D = depth_prob.shape[-1]
    labels = downsample_gt_depth(gt_depths, downsample, dbound, D)
    preds = depth_prob.reshape(-1, D)
    fg = labels.amax(1) > 0.0
    p = preds.clamp(1e-12, 1.0 - 1e-12)
    bce = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    bce = bce * fg[:, None]
    return bce.sum() / fg.sum().float().clamp(min=1.0)


def gaussian_depth_target(gt_depths, downsample: int, dbound, D: int,
                          constant_std: float = 0.5):
    """The reference's constant-std Gaussian depth target, with its quirk
    (bin-normalized Gaussians evaluated at the raw depth edges) ->
    (depth_dist [B*N, h, w, D], min_depth [B*N, h, w])."""
    B, N, H, W = gt_depths.shape
    h, w = H // downsample, W // downsample
    x = gt_depths.reshape(B * N, h, downsample, w, downsample)
    x = x.permute(0, 1, 3, 2, 4).reshape(B * N, h, w,
                                         downsample * downsample)
    xv = torch.where(x != 0.0, x, 1e10)
    min_depth = xv.min(-1).values
    min_depth = torch.where(min_depth == 1e10, 0.0, min_depth)
    edges = np.arange(dbound[0] - dbound[2] / 2.0, dbound[1], dbound[2],
                      dtype=np.float32)
    assert edges.shape[0] == D + 1, (edges.shape, D)
    inv_scale = dbound[2] / constant_std
    z = (torch.from_numpy(edges).to(x.device)
         - (min_depth / dbound[2])[..., None]) * inv_scale
    cdfs = torch.special.ndtr(z)
    return cdfs[..., 1:] - cdfs[..., :-1], min_depth


def kld_depth_loss(depth_prob, gt_depths, downsample: int, dbound,
                   constant_std: float = 0.5):
    """KL(target || pred) over the foreground pixels, 'batchmean'."""
    D = depth_prob.shape[-1]
    labels, min_depth = gaussian_depth_target(
        gt_depths, downsample, dbound, D, constant_std)
    v = min_depth.reshape(-1)
    fg = (v >= dbound[0]) & (v <= dbound[1] - dbound[2])
    labels = labels.reshape(-1, D)
    logp = torch.log(depth_prob.reshape(-1, D).float() + 1e-4)
    kl = torch.where(labels > 0, labels * (
        torch.log(labels.clamp(min=1e-38)) - logp), 0.0)
    kl = kl * fg[:, None]
    return kl.sum() / fg.sum().clamp(min=1)
