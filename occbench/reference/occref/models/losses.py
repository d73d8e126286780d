"""Training loss assembly for CoOccRay.

Counterpart of coocc_tpu/models/losses.py (reference coocc_ray.py:339-433,
occ_head.py:267-312):
  * depth BCE (or KL) on the DepthNet distribution;
  * the coarse voxel losses CE + sem_scal + geo_scal + lovasz on the
    mode-pooled ground truth (tag c_0), and the same at the cascade's
    sampled fine cells (tag fine; invalid slots ignored);
  * the normalization loss / detach(loss) (loss_norm), applied BEFORE the
    rendering losses are added, as the reference does;
  * the rendering losses: depth MSE against the binned ground-truth depth
    and rgb MSE against the input images.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config.base import CoOccConfig
from ..config.nuscenes import class_weights as nusc_class_weights
from ..nn.layers import softmax
from ..losses.depth import bce_depth_loss, kld_depth_loss
from ..losses.gt_pool import mode_pool_gt
from ..losses.lovasz import lovasz_softmax
from ..losses.ssc import ce_ssc_loss, geo_scal_loss, sem_scal_loss


def _ssc_losses(logits, target, weights, h, tag: str) -> Dict:
    return {
        f"loss_voxel_ce_{tag}": h.loss_voxel_ce_weight * ce_ssc_loss(
            logits, target, weights, ignore_index=255),
        f"loss_voxel_sem_scal_{tag}": h.loss_voxel_sem_scal_weight
        * sem_scal_loss(logits, target, ignore_index=255),
        f"loss_voxel_geo_scal_{tag}": h.loss_voxel_geo_scal_weight
        * geo_scal_loss(logits, target, ignore_index=255,
                        non_empty_idx=h.empty_idx),
        f"loss_voxel_lovasz_{tag}": h.loss_voxel_lovasz_weight
        * lovasz_softmax(softmax(logits, -1), target, ignore_index=255),
    }


def voxel_losses(logits, target, cfg: CoOccConfig, tag: str) -> Dict:
    """CE (class-balanced) + sem_scal + geo_scal + lovasz at the logits'
    resolution; logits [B, X, Y, Z, C], target [B, X, Y, Z]."""
    h = cfg.occ_head
    weights = nusc_class_weights(h.out_channel) if h.balance_cls_weight \
        else np.full((h.out_channel,), 1.0 / h.out_channel, np.float32)
    return _ssc_losses(logits, target, weights, h, tag)


def point_losses(fine_logits, fine_coords, fine_valid, target,
                 cfg: CoOccConfig, tag: str = "fine") -> Dict:
    """The same losses at the cascade's fine cells (unweighted CE): each
    row's target is the ground truth at its coordinates, 255 where the
    slot is invalid."""
    gt = torch.stack([t[c[:, 0].long(), c[:, 1].long(), c[:, 2].long()]
                      for t, c in zip(target, fine_coords)])
    gt = torch.where(fine_valid, gt, 255)
    return _ssc_losses(fine_logits, gt, None, cfg.occ_head, tag)


def render_losses(outs, batch, cfg: CoOccConfig) -> Dict:
    D = cfg.grid.num_depth_bins
    dbound = cfg.grid.dbound
    gt_bins = (batch.gt_depths - (dbound[0] - dbound[2] / 2.0)) / dbound[2]
    gt_bins = gt_bins.clamp(0, D)
    fg = gt_bins > 0
    err = ((outs["render_depth"] / D) - (gt_bins / D)) ** 2 * fg
    losses = {"loss_depth_render": err.sum() / fg.sum().float().clamp(
        min=1.0)}
    if outs.get("render_rgb") is not None and batch.imgs is not None:
        losses["loss_rgb"] = ((outs["render_rgb"] - batch.imgs) ** 2).mean()
    return losses


def compute_losses(outs, batch, cfg: CoOccConfig) -> Dict[str, torch.Tensor]:
    """outs: the training forward's; batch: its Batch (with gt_occ and,
    for the depth and render losses, gt_depths) -> {name: scalar}."""
    losses: Dict[str, torch.Tensor] = {}
    if outs.get("depth_prob") is not None and batch.gt_depths is not None:
        depth_fn = {"bce": bce_depth_loss, "kld": kld_depth_loss}[
            cfg.lss.loss_depth_type]
        losses["loss_depth"] = cfg.lss.loss_depth_weight * depth_fn(
            outs["depth_prob"], batch.gt_depths, cfg.lss.downsample,
            cfg.grid.dbound)
    logits = outs["occ"]
    if batch.gt_occ_2 is not None \
            and batch.gt_occ_2.shape[1] == logits.shape[1]:
        target_c = batch.gt_occ_2
    else:
        ratio = batch.gt_occ.shape[1] // logits.shape[1]
        target_c = mode_pool_gt(batch.gt_occ, ratio,
                                cfg.occ_head.out_channel)
    losses.update(voxel_losses(logits, target_c, cfg, tag="c_0"))
    if "fine_logits" in outs:
        losses.update(point_losses(outs["fine_logits"], outs["fine_coords"],
                                   outs["fine_valid"], batch.gt_occ, cfg))
    if cfg.loss_norm:
        losses = {k: v / (v.detach() + 1e-9) if k.startswith("loss") else v
                  for k, v in losses.items()}
    if "render_depth" in outs:
        losses.update(render_losses(outs, batch, cfg))
    return losses
