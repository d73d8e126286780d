"""LSS view transformer (voxel variant): DepthNet -> lift -> splat.

Counterpart of coocc_tpu/nn/lss.py `LSSViewTransformerVoxel` with the
mono DepthNet (the port's stereo depth net is not in the copy).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..config.base import CoOccConfig
from ..geometry.frustum import create_frustum, gen_dx_bx, get_geometry
from ..ops.lift_splat import lift_splat
from .depthnet import DepthNet
from .layers import softmax


class LSSViewTransformerVoxel(nn.Module):
    """[B, N, C_in, fH, fW] + calibration -> [B, X, Y, Z, numC_Trans]."""

    def __init__(self, cfg: CoOccConfig):
        super().__init__()
        self.cfg = cfg
        lss = cfg.lss
        D = cfg.grid.num_depth_bins
        self.depth_net = DepthNet(lss.numC_input, lss.numC_input,
                                  lss.numC_Trans, D, lss.cam_channels)
        self.register_buffer("frustum", torch.from_numpy(create_frustum(
            cfg.data.input_size, lss.downsample, cfg.grid.dbound)),
            persistent=False)

    def forward(self, x, rots, trans, intrins, post_rots, post_trans, bda,
                mlp_input):
        """Returns (voxels [B, X, Y, Z, C] in x's dtype, depth_prob [B, N,
        fH, fW, D], geom [B, N, D, fH, fW, 3]). The splat weights and sums
        are fp32 whatever the compute dtype (JAX lss.py:85-90)."""
        cfg = self.cfg
        B, N, Cin, fH, fW = x.shape
        D = cfg.grid.num_depth_bins
        x = x.reshape(B * N, Cin, fH, fW)
        mlp_input = mlp_input.reshape(B * N, -1)
        out = self.depth_net(x, mlp_input)
        depth_prob = softmax(out[:, :D], dim=1)  # [BN, D, fH, fW]
        img_feat = out[:, D:D + cfg.lss.numC_Trans]
        geom = get_geometry(self.frustum, rots, trans, intrins, post_rots,
                            post_trans, bda)
        dx, bx, nx = gen_dx_bx(cfg.grid.xbound, cfg.grid.ybound,
                               cfg.grid.zbound)
        bev = lift_splat(depth_prob.reshape(B, N, D, fH, fW).float(),
                         img_feat.reshape(B, N, -1, fH, fW)
                         .permute(0, 1, 3, 4, 2),
                         geom, dx, bx, nx)
        return (bev.to(x.dtype), depth_prob.reshape(B, N, D, fH, fW)
                .permute(0, 1, 3, 4, 2), geom)
