"""CoOccRay: the multi-modal occupancy model.

Counterpart of coocc_tpu/models/coocc_ray.py `CoOccRay.__call__`
(reference detectors/coocc_ray.py:31-723):

  image branch   ResNet -> SECONDFPN -> DepthNet/LSS splat -> img_voxel
  lidar branch   occupancy voxelize -> PackedLiDAREnc8x -> pts_voxel; for
                 SparseEncoderHD (the LiDAR-only coocc_lidar) voxel means
                 -> PackedEncoderHD -> SECOND3D -> SECOND3DFPN
  fusion         BiFuserN grid-space window-KNN fusion (a config without
                 the fuser feeds pts_voxel, or img_voxel, on)
  semantics      CustomResNet3D -> FPN3D -> OccHead (+ cascade)
  regularizer    frustum volume renderer (training, and eval with
                 render.test_rendering)

Submodule names are the reference checkpoint's top-level prefixes
(img_backbone, img_neck, img_view_transformer.depth_net, pts_middle_encoder,
pts_backbone, pts_neck, occ_fuser, semantic_encoder, semantic_neck,
pts_bbox_head, and the renderer's sigma_head / rgb_head), so a Co-Occ
state_dict loads straight in. Inputs and outputs are channels-last like
the JAX package's; inside, tensors are NCHW / NCDHW. B > 1 runs the
per-sample steps (voxelize, KNN, cascade, the renderer's lookup) in a
loop.

`model.eval()` runs JAX's `train=False` forward under no_grad; `.train()`
runs its `train=True` one: BatchNorm on batch statistics, ASPP's dropout,
the LiDAR voxel cap `pts.max_voxels`, the cascade on `fine_topk` random
cells (priorities passed in), and the extra outputs the losses read
(depth_prob, voxel_feats, geom, and the renderer's render_depth and
render_rgb; a model without the camera branch renders depth only, on a
stride-16 frustum of the batch's camera poses, as JAX's does). With
`render.use_rendering and render.test_rendering` the eval forward renders
too and returns render_depth and render_rgb beside the occupancy outputs
(JAX coocc_ray.py:332-352).

The copy holds what the benchmark's two configurations run: the port's
Swin backbone, its stereo LSS and its gather, dense and rulebook LiDAR
encoders are left out. A config whose LiDAR grid (pts.sparse_shape_xyz
/ 8) is not the fuser's (lss_grid_size) builds and runs its img and pts
prefixes, and a forward past them raises ValueError: JAX's fuser fails
there too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from ..config.base import CoOccConfig
from ..geometry.frustum import create_frustum, get_geometry, get_mlp_input
from ..nn.bifuser import BiFuserN
from ..nn.fpn3d import FPN3D
from ..nn.lss import LSSViewTransformerVoxel
from ..nn.nerf_mlp import NeRFMLP
from ..nn.occ_head import OccHead
from ..nn.resnet2d import ResNet
from ..nn.resnet3d import CustomResNet3D
from ..nn.second3d import SECOND3D, SECOND3DFPN
from ..nn.second_fpn import SECONDFPN
from ..nn.sparse_enc_packed import PackedLiDAREnc8x
from ..nn.sparse_enc_packed_hd import PackedEncoderHD
from ..ops.sparse_tensor import SparseTensor
from ..ops.voxelize import voxelize, voxelize_mask
from .renderer import render

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


def _lidar_encoder(pts, compute_dtype: torch.dtype) -> nn.Module:
    """The encoder `pts.impl` 'auto' resolves to, as the JAX model resolves
    it (coocc_tpu/models/coocc_ray.py:130-250): PackedLiDAREnc8x for
    SparseLiDAREnc8x, PackedEncoderHD for SparseEncoderHD. `pts.ztap_levels`
    names a layout of the packed encoder's blocks on the TPU (JAX
    `_ZTapBasicBlock`): the same function, which the port computes
    through K2 whatever the levels."""
    if pts.impl not in ("auto", "packed") or pts.encoder not in (
            "SparseLiDAREnc8x", "SparseEncoderHD"):
        raise NotImplementedError(
            f"{pts.encoder} with pts.impl={pts.impl!r} is not in the copy")
    if pts.encoder == "SparseEncoderHD":
        return PackedEncoderHD(pts.input_channel, pts.base_channel,
                               pts.out_channel, pts.sparse_shape_xyz,
                               compute_dtype=compute_dtype)
    return PackedLiDAREnc8x(pts.input_channel, pts.base_channel,
                            pts.out_channel, compute_dtype)


def _image_backbone(cfg: CoOccConfig) -> nn.Module:
    """The ResNet `img_backbone` names (JAX coocc_ray.py:75-87)."""
    bb = cfg.img_backbone
    if bb.type != "ResNet" or cfg.lss.stereo:
        raise NotImplementedError(f"image backbone {bb.type} (stereo "
                                  f"{cfg.lss.stereo}) is not in the copy")
    return ResNet(bb.depth, bb.out_indices)


class CoOccRay(nn.Module):
    """dtype is the JAX model's: None computes in fp32, torch.bfloat16 in
    bf16 (coocc_tpu/models/coocc_ray.py:69). The parameters and BN
    statistics stay fp32 either way and are cast where they are used; the
    model casts its inputs (the images, the LiDAR occupancy) to the compute
    dtype and each layer follows its input's dtype (nn/layers.py)."""

    def __init__(self, cfg: CoOccConfig, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype or torch.float32
        if cfg.use_camera:
            self.img_backbone = _image_backbone(cfg)
            self.img_neck = SECONDFPN(self.img_backbone.out_channels,
                                      cfg.img_neck.out_channels,
                                      cfg.img_neck.upsample_strides)
            self.img_view_transformer = LSSViewTransformerVoxel(cfg)
        pts_ch = None
        self.pts_grid = None    # the 8x encoders' output grid
        if cfg.use_lidar:
            self.pts_middle_encoder = _lidar_encoder(cfg.pts, self.dtype)
            pts_ch = cfg.pts.out_channel
            if not isinstance(self.pts_middle_encoder, PackedEncoderHD):
                self.pts_grid = tuple(s // 8 for s in
                                      cfg.pts.sparse_shape_xyz)
            elif cfg.second3d is not None:
                # JAX coocc_ray.py:210-237: only after the HD encoder
                s3 = cfg.second3d
                self.pts_backbone = SECOND3D(
                    s3.in_channels, s3.out_channels, s3.layer_nums,
                    s3.layer_strides, s3.is_cascade)
                self.pts_neck = SECOND3DFPN(
                    s3.out_channels, s3.fpn_out_channels,
                    s3.fpn_upsample_strides,
                    extra_num_conv=s3.fpn_extra_num_conv)
                pts_ch = s3.fpn_out_channels[-1]
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
            feat_ch = fz.out_channels
        else:
            # without the fuser the semantic stack reads pts_voxel, or
            # img_voxel without LiDAR (JAX coocc_ray.py:287-288), and takes
            # its width from it
            feat_ch = pts_ch if cfg.use_lidar else cfg.lss.numC_Trans
        sem = cfg.semantic
        self.semantic_encoder = CustomResNet3D(
            feat_ch, sem.depth, sem.block_inplanes,
            sem.block_strides, sem.out_indices)
        self.semantic_neck = FPN3D(sem.block_inplanes, sem.neck_out_channels,
                                   with_cp=sem.neck_with_cp)
        self.pts_bbox_head = OccHead(
            cfg.occ_head, img_channels=sum(cfg.img_neck.out_channels)
            if cfg.use_camera else 0)
        if cfg.render.use_rendering:
            # the renderer's heads (JAX models/renderer.py:97-103), on the
            # semantic stack's input (the fused features)
            self.sigma_head = NeRFMLP(feat_ch, 1, 1)
            if cfg.use_camera:
                self.rgb_head = NeRFMLP(feat_ch, 3, 3)
            else:
                # without the LSS the renderer's rays come from a stride-16
                # frustum of its own (JAX coocc_ray.py:339-345)
                self.register_buffer("render_frustum", torch.from_numpy(
                    create_frustum(cfg.data.input_size, 16,
                                   (2.0, 58.0, 0.5))), persistent=False)

    def _images(self, imgs):
        """[B, N, H, W, 3] -> [B*N, 3, H, W] in the compute dtype (the
        images enter it at the first conv, as flax's)."""
        B, N, H, W, _ = imgs.shape
        return imgs.reshape(B * N, H, W, 3).permute(0, 3, 1, 2).to(
            self.dtype)

    def _image_voxels(self, batch: Batch):
        B, N = batch.imgs.shape[:2]
        feats = self.img_backbone(self._images(batch.imgs))
        x = self.img_neck(feats)
        img_feats = x.reshape(B, N, *x.shape[1:])  # [B, N, C, fH, fW]
        mlp_input = get_mlp_input(batch.rots, batch.trans, batch.intrins,
                                  batch.post_rots, batch.post_trans,
                                  batch.bda)
        bev, depth_prob, geom = self.img_view_transformer(
            img_feats, batch.rots, batch.trans, batch.intrins,
            batch.post_rots, batch.post_trans, batch.bda, mlp_input)
        return bev.permute(0, 4, 1, 2, 3), img_feats, depth_prob, geom

    def _pts_voxels(self, batch: Batch):
        cfg = self.cfg
        cap = cfg.pts.max_voxels if self.training else cfg.pts.max_voxels_test
        enc = self.pts_middle_encoder
        if isinstance(enc, PackedEncoderHD):
            return self._pts_voxels_hd(batch, cap)
        occupancy = torch.stack([
            voxelize_mask(p, m, cfg.point_cloud_range, cfg.pts.voxel_size,
                          cfg.pts.sparse_shape_xyz, max_voxels=cap)
            for p, m in zip(batch.points, batch.points_mask)])
        # the encoders return fp32 (JAX coocc_ray.py:178 casts back)
        return self.pts_middle_encoder(occupancy).to(self.dtype)

    def _voxel_means(self, batch: Batch, cap: int) -> SparseTensor:
        """Each sample's voxel means (`voxelize`: at most
        pts.max_num_points a voxel, pts.input_channel features, `cap`
        voxels), stacked into a SparseTensor."""
        pts = self.cfg.pts
        vox = [voxelize(p, m, self.cfg.point_cloud_range, pts.voxel_size,
                        pts.sparse_shape_xyz, max_voxels=cap,
                        max_points_per_voxel=pts.max_num_points,
                        num_features=pts.input_channel)
               for p, m in zip(batch.points, batch.points_mask)]
        return SparseTensor(*(torch.stack(t) for t in zip(*vox)))

    def _pts_voxels_hd(self, batch: Batch, cap: int):
        """The HD path (JAX coocc_ray.py:180-237): the voxel means of each
        sample, the HD encoder, then SECOND3D and its FPN on the (Z, Y, X)
        conv axes, in the compute dtype."""
        dense = self.pts_middle_encoder(self._voxel_means(batch, cap))
        if hasattr(self, "pts_backbone"):
            # [B, C, X, Y, Z] -> [B, C, Z, Y, X] and back
            zyx = dense.to(self.dtype).permute(0, 1, 4, 3, 2)
            dense = self.pts_neck(self.pts_backbone(zyx)).permute(
                0, 1, 4, 3, 2)
        return dense.to(self.dtype)

    def forward(self, batch: Batch, stop_at: Optional[str] = None,
                fine_priorities=None):
        """The forward, under no_grad in eval. stop_at in STAGES truncates
        after that stage and returns its outputs, as the JAX model's stop_at
        does: 'img' -> img_voxel, 'pts' -> + pts_voxel ([B, X, Y, Z, C]),
        'fuse' -> voxel_feats, 'sem' -> semantic (list), 'coarse' -> occ.
        The full forward returns occ, fine_logits, fine_coords, fine_valid
        and fine_overflow, and in training depth_prob [B, N, fH, fW, D],
        voxel_feats, geom and, with rendering on, render_depth [B, N, H, W]
        and render_rgb [B, N, H, W, 3] (in eval too with
        render.test_rendering). Every feature output is in the
        compute dtype but fine_logits, which the cascade's last fc makes in
        fp32, as JAX's prefixes return them. fine_priorities [B, n coarse
        cells]: the training cascade's (nn/occ_head.py:select_occupied)."""
        if stop_at is not None and stop_at not in STAGES:
            raise ValueError(f"stop_at must be one of {STAGES}")
        if stop_at not in ("img", "pts"):
            self._check_fuser_grid(batch)
        with torch.set_grad_enabled(self.training
                                    and torch.is_grad_enabled()):
            return self._forward(batch, stop_at, fine_priorities)

    def _check_fuser_grid(self, batch: Batch):
        """Raises ValueError where the fuser would read two grids that
        differ: the LiDAR branch's and the image branch's (lss_grid_size).
        Checked from the config, before the forward runs."""
        cfg = self.cfg
        if cfg.fuser is None or self.pts_grid is None or not cfg.use_camera \
                or batch.imgs is None or batch.points is None:
            return
        if self.pts_grid != tuple(cfg.lss_grid_size):
            raise ValueError(
                f"{cfg.name}: the LiDAR branch's grid {list(self.pts_grid)} "
                f"(pts.sparse_shape_xyz {list(cfg.pts.sparse_shape_xyz)} / 8)"
                f" is not the fuser's {list(cfg.lss_grid_size)} "
                "(lss_grid_size): the fuser cannot pair them, and JAX's "
                "fails there too (coocc_tpu/nn/bifuser.py:64); the img and "
                "pts prefixes run (stop_at='pts')")

    def _forward(self, batch: Batch, stop_at, fine_priorities):
        cfg = self.cfg

        def cl(t):  # NCDHW -> channels-last
            return None if t is None else t.permute(0, 2, 3, 4, 1)

        img_voxel = img_feats = depth_prob = geom = None
        if cfg.use_camera and batch.imgs is not None:
            img_voxel, img_feats, depth_prob, geom = self._image_voxels(batch)
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
        outs = self.pts_bbox_head(list(semantic), img_feats=img_feats,
                                  transform=transform,
                                  coarse_only=(stop_at == "coarse"),
                                  fine_priorities=fine_priorities)
        if stop_at == "coarse":
            return outs
        if self.training:
            # the losses' inputs (JAX coocc_ray.py:324-330)
            outs.update(depth_prob=depth_prob, voxel_feats=cl(voxel_feats),
                        geom=geom)
        elif not cfg.render.test_rendering:
            return outs
        if geom is None and batch.rots is not None \
                and hasattr(self, "render_frustum"):
            # the LiDAR-only model renders depth from the cameras' poses
            geom = get_geometry(self.render_frustum, batch.rots, batch.trans,
                                batch.intrins, batch.post_rots,
                                batch.post_trans, batch.bda)
        if cfg.render.use_rendering and geom is not None:
            # on the FUSED voxel features, before the semantic stack
            rgbs, depths = render(self.sigma_head,
                                  getattr(self, "rgb_head", None),
                                  cfg.render, cl(voxel_feats), geom)
            if rgbs is not None:
                outs["render_rgb"] = rgbs
            outs["render_depth"] = depths
        return outs
