"""SparseEncoderHD in its rulebook form (COOCC_HD_IMPL=gather, or
pts.impl 'gather' for SparseEncoderHD).

Counterpart of coocc_tpu/nn/sparse_encoder_hd.py `SparseEncoderHD`
(reference coocc/voxel_encoder/sparse_encoder_hd.py:11-209 at
coocc_lidar's configuration) on the gather-GEMM engine of
nn/sparse_enc.py, with `PackedEncoderHD`'s parameters (the same names:
one state_dict loads into both):

  * conv_input: a SubM conv, BN, ReLU;
  * each stage's basic blocks, and at the end of stages 0-2 a strided
    conv (kernel 3, stride 2) with the xyz paddings (1, 1, 1), (1, 1, 1),
    (1, 1, 0): (800, 800, 65) -> (400, 400, 33) -> (200, 200, 17) ->
    (100, 100, 8); each keeps at most `capacity` output sites, the
    largest ids dropped past it (`level_sites` keeps the counts before the
    cap);
  * conv_out: a 1x1x1 conv through the identity rulebook, BN, ReLU; then
    the sites densified to [B, C, X, Y, Z] fp32.

Every BatchNorm has eps 1e-3 and momentum 0.01 and takes the statistics of
the batch's active voxels in training (`layers.masked_batch_norm`).
Numerics: fp32 throughout, as JAX's (it never casts).
"""
from __future__ import annotations

from typing import List

import torch

from ..ops.sparse_conv import SparseTensor, conv_output_shape
from .sparse_enc import (basic_block, batched_conv, densify, row_bn,
                         strided_block, subm, subm_rulebooks, taps)
from .sparse_enc_packed_hd import (ENCODER_CHANNELS, STRIDED_PADDINGS,
                                   PackedEncoderHD)


class SparseEncoderHD(PackedEncoderHD):
    """SparseTensor (ids [B, A], voxel means [B, A, in_channels], mask) on
    the sparse_shape_xyz grid -> [B, output_channels, X/8, Y/8, Zl] fp32
    (Zl = 8 for Z0 = 65)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.level_sites: List[torch.Tensor] = []

    def forward(self, sp: SparseTensor, capacity: int) -> torch.Tensor:
        self.level_sites = []
        grid = self.sparse_shape_xyz
        rbs = subm_rulebooks(sp, grid)
        x = subm(self.conv_input[0], sp, rbs)
        f = row_bn(self.conv_input[1], x.features, x.mask)
        x = x._replace(features=torch.relu(f) * x.mask[..., None])
        last = len(ENCODER_CHANNELS) - 1
        for i, blocks in enumerate(ENCODER_CHANNELS):
            layer = getattr(self.encoder_layers, f"encoder_layer{i + 1}")
            for j in range(len(blocks)):
                if j == len(blocks) - 1 and i != last:
                    out_grid = conv_output_shape(grid, 3, 2,
                                                 STRIDED_PADDINGS[i])
                    x = strided_block(layer[j][0], layer[j][1], x, grid,
                                      out_grid, capacity,
                                      STRIDED_PADDINGS[i], self.level_sites)
                    grid = out_grid
                    rbs = subm_rulebooks(x, grid)
                else:
                    blk = layer[j]
                    x = basic_block((blk.conv1, blk.norm1, blk.conv2,
                                     blk.norm2), x, rbs)
        # conv_out: 1x1x1, each site reads its own row
        A = x.ids.shape[1]
        ident = [torch.arange(A, device=x.ids.device)[:, None]] * len(x.ids)
        f = batched_conv(x, ident, taps(self.conv_out[0]), x.mask)
        f = row_bn(self.conv_out[1], f, x.mask)
        return densify(x._replace(features=torch.relu(f)
                                  * x.mask[..., None]), grid)
