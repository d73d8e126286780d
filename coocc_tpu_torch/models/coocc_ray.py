"""CoOccRay: the multi-modal occupancy model, eval forward.

Counterpart of coocc_tpu/models/coocc_ray.py `CoOccRay.__call__(batch,
train=False)` (reference detectors/coocc_ray.py:31-723):

  image branch   ResNet -> SECONDFPN -> DepthNet/LSS splat -> img_voxel
  lidar branch   occupancy voxelize -> DenseLiDAREnc8x -> pts_voxel
  fusion         BiFuserN grid-space window-KNN fusion
  semantics      CustomResNet3D -> FPN3D -> OccHead (+ cascade)

Submodule names are the reference checkpoint's top-level prefixes
(img_backbone, img_neck, img_view_transformer.depth_net, pts_middle_encoder,
occ_fuser, semantic_encoder, semantic_neck, pts_bbox_head), so a Co-Occ
state_dict loads straight in (the renderer's sigma_head / rgb_head are off at
eval and not part of this model). Inputs and outputs are channels-last like
the JAX package's; inside, tensors are NCHW / NCDHW. B > 1 runs the
per-sample steps (voxelize, KNN, cascade) in a loop.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from ..config.base import CoOccConfig
from ..geometry.frustum import get_mlp_input
from ..nn.bifuser import BiFuserN
from ..nn.fpn3d import FPN3D
from ..nn.lss import LSSViewTransformerVoxel
from ..nn.occ_head import OccHead
from ..nn.resnet2d import ResNet
from ..nn.resnet3d import CustomResNet3D
from ..nn.second_fpn import SECONDFPN
from ..nn.sparse_enc_dense import DenseLiDAREnc8x
from ..ops.voxelize import voxelize_mask

STAGES = ("img", "pts", "fuse", "sem", "coarse")


class Batch(NamedTuple):
    """One batch, fixed shapes; unused fields may be None (the reference's
    `img_inputs` tuple as named fields; `points` is the padded cloud)."""
    imgs: Optional[object] = None          # [B, N, H, W, 3] in [0, 1]
    rots: Optional[object] = None          # [B, N, 3, 3]
    trans: Optional[object] = None         # [B, N, 3]
    intrins: Optional[object] = None       # [B, N, 3, 3]
    post_rots: Optional[object] = None     # [B, N, 3, 3]
    post_trans: Optional[object] = None    # [B, N, 3]
    bda: Optional[object] = None           # [B, 3, 3]
    gt_depths: Optional[object] = None     # [B, N, H, W]
    points: Optional[object] = None        # [B, P, 5]
    points_mask: Optional[object] = None   # [B, P]
    gt_occ: Optional[object] = None        # [B, X, Y, Z] int
    points_occ: Optional[object] = None    # [B, Q, 4+] lidarseg points
    points_occ_mask: Optional[object] = None
    visible_mask: Optional[object] = None  # [B, X, Y, Z] uint8 (openocc)
    gt_occ_2: Optional[object] = None      # [B, X/2, Y/2, Z/2] (kitti 1_2)
    imgs_prev: Optional[object] = None     # [B, N, H, W, 3]
    k2s_rots: Optional[object] = None      # [B, N, 3, 3]
    k2s_trans: Optional[object] = None     # [B, N, 3]

    def to(self, device) -> "Batch":
        """numpy arrays or tensors -> tensors on `device` (None stays)."""
        def move(a):
            if a is None:
                return None
            t = torch.from_numpy(np.asarray(a)) if isinstance(
                a, np.ndarray) else a
            return t.to(device)
        return Batch(*(move(a) for a in self))


class CoOccRay(nn.Module):
    def __init__(self, cfg: CoOccConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.use_camera:
            if cfg.img_backbone.type != "ResNet":
                raise NotImplementedError(
                    f"image backbone {cfg.img_backbone.type} is not ported")
            if cfg.lss.stereo:
                raise NotImplementedError("stereo LSS is not ported")
            self.img_backbone = ResNet(cfg.img_backbone.depth,
                                       cfg.img_backbone.out_indices)
            self.img_neck = SECONDFPN(self.img_backbone.out_channels,
                                      cfg.img_neck.out_channels,
                                      cfg.img_neck.upsample_strides)
            self.img_view_transformer = LSSViewTransformerVoxel(cfg)
        if cfg.use_lidar:
            if cfg.pts.encoder != "SparseLiDAREnc8x":
                raise NotImplementedError(
                    f"LiDAR encoder {cfg.pts.encoder} is not ported")
            self.pts_middle_encoder = DenseLiDAREnc8x(
                cfg.pts.input_channel, cfg.pts.base_channel,
                cfg.pts.out_channel)
        fz = cfg.fuser
        if fz is not None:
            self.occ_fuser = BiFuserN(
                fz.in_channels, fz.out_channels, fz.knum, fz.dist_thresh,
                (fz.window_rx, fz.window_ry, fz.window_rz),
                (fz.window_img_rx if fz.window_img_rx is not None
                 else fz.window_rx,
                 fz.window_img_ry if fz.window_img_ry is not None
                 else fz.window_ry,
                 fz.window_img_rz if fz.window_img_rz is not None
                 else fz.window_rz))
        sem = cfg.semantic
        self.semantic_encoder = CustomResNet3D(
            fz.out_channels if fz is not None else cfg.pts.out_channel,
            sem.depth, sem.block_inplanes, sem.block_strides, sem.out_indices)
        self.semantic_neck = FPN3D(sem.block_inplanes, sem.neck_out_channels)
        self.pts_bbox_head = OccHead(
            cfg.occ_head, img_channels=sum(cfg.img_neck.out_channels)
            if cfg.use_camera else 0)

    def _image_voxels(self, batch: Batch):
        B, N, H, W, _ = batch.imgs.shape
        x = batch.imgs.reshape(B * N, H, W, 3).permute(0, 3, 1, 2)
        x = self.img_neck(self.img_backbone(x))
        img_feats = x.reshape(B, N, *x.shape[1:])  # [B, N, C, fH, fW]
        mlp_input = get_mlp_input(batch.rots, batch.trans, batch.intrins,
                                  batch.post_rots, batch.post_trans,
                                  batch.bda)
        bev, _, _ = self.img_view_transformer(
            img_feats, batch.rots, batch.trans, batch.intrins,
            batch.post_rots, batch.post_trans, batch.bda, mlp_input)
        return bev.permute(0, 4, 1, 2, 3), img_feats

    def _pts_voxels(self, batch: Batch):
        cfg = self.cfg
        occupancy = torch.stack([
            voxelize_mask(p, m, cfg.point_cloud_range, cfg.pts.voxel_size,
                          cfg.pts.sparse_shape_xyz,
                          max_voxels=cfg.pts.max_voxels_test)
            for p, m in zip(batch.points, batch.points_mask)])
        return self.pts_middle_encoder(occupancy)

    @torch.no_grad()
    def forward(self, batch: Batch, stop_at: Optional[str] = None):
        """Eval forward. stop_at in STAGES truncates after that stage and
        returns its outputs, as the JAX model's stop_at does:
        'img' -> img_voxel, 'pts' -> + pts_voxel ([B, X, Y, Z, C]),
        'fuse' -> voxel_feats, 'sem' -> semantic (list), 'coarse' -> occ.
        The full forward returns occ, fine_logits, fine_coords, fine_valid
        and fine_overflow."""
        if stop_at is not None and stop_at not in STAGES:
            raise ValueError(f"stop_at must be one of {STAGES}")
        cfg = self.cfg

        def cl(t):  # NCDHW -> channels-last
            return None if t is None else t.permute(0, 2, 3, 4, 1)

        img_voxel = img_feats = None
        if cfg.use_camera and batch.imgs is not None:
            img_voxel, img_feats = self._image_voxels(batch)
        if stop_at == "img":
            return {"img_voxel": cl(img_voxel)}
        pts_voxel = None
        if cfg.use_lidar and batch.points is not None:
            pts_voxel = self._pts_voxels(batch)
        if stop_at == "pts":
            return {"img_voxel": cl(img_voxel), "pts_voxel": cl(pts_voxel)}
        if cfg.fuser is not None and img_voxel is not None \
                and pts_voxel is not None:
            voxel_feats = self.occ_fuser(img_voxel, pts_voxel)
        else:
            voxel_feats = img_voxel if pts_voxel is None else pts_voxel
        if stop_at == "fuse":
            return {"voxel_feats": cl(voxel_feats)}
        semantic = self.semantic_neck(self.semantic_encoder(voxel_feats))
        if stop_at == "sem":
            return {"semantic": [cl(s) for s in semantic]}
        transform = None
        if batch.rots is not None:
            transform = (batch.rots, batch.trans, batch.intrins,
                         batch.post_rots, batch.post_trans, batch.bda)
        return self.pts_bbox_head(list(semantic), img_feats=img_feats,
                                  transform=transform,
                                  coarse_only=(stop_at == "coarse"))
