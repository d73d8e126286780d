"""BiFuserN: bidirectional grid-space KNN fusion of camera & LiDAR voxels.

Counterpart of coocc_tpu/nn/bifuser.py (reference GSFusion fuser,
bifuser_n.py:14-174): for every cell, gather the features of its knum
nearest active image voxels, encode them with a shared Linear+ReLU and
multiply with the local LiDAR features at LiDAR-active cells; the same the
other way round; concat [img, pts, fused_img, fused_pts] and mix with two
Conv3d+BN+ReLU. Invalid neighbours (none in the window) contribute zeros.
The con_enc BatchNorms keep torch's default eps 1e-5.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.gather import gather_rows
from ..ops.window_knn import make_offsets, window_knn
from .layers import BatchNorm, Conv3d, Linear


class BiFuserN(nn.Module):
    def __init__(self, in_channels: int = 128, out_channels: int = 128,
                 knum: int = 2, dist_thresh: float = 13.3,
                 window: tuple = (6, 6, 7), window_img: tuple = (4, 4, 7)):
        super().__init__()
        if knum != 2:
            raise ValueError("the window-KNN search is specialized for knum=2")
        self.knum = knum
        self.offsets = make_offsets(*window, dist_thresh)
        self.offsets_img = make_offsets(*window_img, dist_thresh)
        c = out_channels
        self.knn_enc = nn.Sequential(Linear(in_channels * knum, c),
                                     nn.ReLU())
        self.con_enc = nn.Sequential(
            Conv3d(in_channels * 4, c * 2, 3, padding=1, bias=False),
            BatchNorm(c * 2), nn.ReLU(),
            Conv3d(c * 2, c, 3, padding=1, bias=False),
            BatchNorm(c), nn.ReLU())

    @staticmethod
    def _gather(feats, ids):
        """feats [X, Y, Z, C]; ids [X, Y, Z, k] -> [X, Y, Z, k*C]."""
        C = feats.shape[-1]
        g = gather_rows(feats.reshape(-1, C), ids.clamp(min=0).long())
        return (g * (ids >= 0)[..., None]).flatten(-2)

    def forward(self, img, pts):
        """img, pts: [B, C, X, Y, Z] -> [B, out_channels, X, Y, Z]."""
        img_cl = img.permute(0, 2, 3, 4, 1)
        pts_cl = pts.permute(0, 2, 3, 4, 1)
        fused_img, fused_pts = [], []
        for iv, pv in zip(img_cl, pts_cl):
            img_active = iv.abs().sum(-1) != 0
            pts_active = pv.abs().sum(-1) != 0
            nn_img = window_knn(img_active, self.offsets_img, self.knum)
            nn_pts = window_knn(pts_active, self.offsets, self.knum)
            fused_img.append(self.knn_enc(self._gather(iv, nn_img)) * pv
                             * pts_active[..., None])
            fused_pts.append(self.knn_enc(self._gather(pv, nn_pts)) * iv
                             * img_active[..., None])
        x = torch.cat([img_cl, pts_cl, torch.stack(fused_img),
                       torch.stack(fused_pts)], dim=-1)
        return self.con_enc(x.permute(0, 4, 1, 2, 3))
