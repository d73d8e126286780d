"""The sparse LiDAR encoders on the gather-GEMM engine (pts.impl 'gather').

Counterpart of coocc_tpu/nn/sparse_enc.py `SparseLiDAREnc8x` and
`SparseLiDAREnc4x` (reference coocc/voxel_encoder/sparse_lidar_enc.py:
67-178, on spconv 2.x): a batched SparseTensor (ids [B, A], the voxel
means [B, A, C], mask) through SubM and strided sparse convs
(ops/sparse_conv.py), each one gather and one matmul, with the rulebooks
of a level shared by its SubM layers (spconv's indice_key). GroupNorm acts
per active voxel over its channel groups, BatchNorm over every active
voxel of the batch (`layers.masked_batch_norm`). The output is the last
level densified to [B, C, X, Y, Z] in fp32.

Every strided level keeps at most `capacity` output sites (the model's
`pts.max_voxels`, or `max_voxels_test` in eval): past it the largest ids
are dropped, as JAX's are (`ops/sparse_conv.py:downsample_sites`). The
sites each level had before its cap are kept in `level_sites` after a
forward (0-d tensors, read without a sync until the caller reads them).

Numerics: fp32 throughout, in a bf16 model too. JAX's gather encoders
never cast: the voxel means are fp32 and so are the weights, and only the
model's return rounds to its dtype (coocc_tpu/models/coocc_ray.py:250).

Parameters: `SparseLiDAREnc8x` has `DenseLiDAREnc8x`'s (the reference
checkpoint's names, nn/sparse_enc_dense.py), so one state_dict loads into
the gather, dense and packed forms. `SparseLiDAREnc4x` has the same
scheme at its own levels: conv_input.{0: SubM, 1: GN16}, conv1.{0, 1}
two basic blocks at the base width, conv{2,3}.0.{0: strided conv, 1: BN}
and conv{2,3}.{1,2} basic blocks, conv_out.{0: SubM, 1: GN16}; its JAX
scopes are conv_input, gn_input, res1_*, down2, res2_*, down3, res3_*,
conv_out and gn_out (convert.py).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.sparse_conv import (SparseTensor, apply_conv,
                               build_strided_rulebook, build_subm_rulebook,
                               downsample_sites, to_dense)
from .layers import BatchNorm, flax_norm, masked_batch_norm
from .sparse_enc_dense import (DenseLiDAREnc8x, SparseBasicBlock,
                               SpConvWeight)


def taps(conv: SpConvWeight) -> torch.Tensor:
    """spconv [Cout, kz, ky, kx, Cin] -> [k^3, Cin, Cout], taps kx-major."""
    w = conv.weight
    return w.permute(3, 2, 1, 4, 0).reshape(-1, w.shape[4], w.shape[0])


def subm_rulebooks(sp: SparseTensor, grid) -> List[torch.Tensor]:
    """Each sample's SubM rulebook on `grid`."""
    return [build_subm_rulebook(i, m, grid) for i, m in zip(sp.ids, sp.mask)]


def batched_conv(sp: SparseTensor, rulebooks: Sequence[torch.Tensor],
                 weight: torch.Tensor, out_mask: torch.Tensor
                 ) -> torch.Tensor:
    """apply_conv over the batch as one gather and one matmul: each
    sample's rows offset into one table ([B, A_in + 1] rows, the zero row
    of each sample its last). -> [B, A_out, Cout] fp32."""
    B, A_in, C = sp.features.shape
    rb = torch.stack([r + b * (A_in + 1) for b, r in enumerate(rulebooks)])
    feats = torch.cat([sp.features * sp.mask[..., None],
                       sp.features.new_zeros((B, 1, C))], 1)
    # the samples' rows are one table: the zero rows of all but the last
    # sample sit inside it, and apply_conv's own zero row is not read
    out = apply_conv(feats.reshape(-1, C), feats.new_ones(B * (A_in + 1),
                                                          dtype=torch.bool),
                     rb.reshape(-1, rb.shape[-1]), weight,
                     out_mask.reshape(-1))
    return out.reshape(B, -1, out.shape[-1])


def row_bn(bn: BatchNorm, f: torch.Tensor, mask: torch.Tensor):
    """Masked BatchNorm over every active row of the batch ([B, A, C])."""
    B, A, C = f.shape
    return masked_batch_norm(bn, f.reshape(B * A, C),
                             mask.reshape(B * A)).reshape(B, A, C)


def row_gn_relu(gn: nn.GroupNorm, sp: SparseTensor) -> SparseTensor:
    """GroupNorm per row (each voxel over its own channel groups, as
    torch's GroupNorm on [N_active, C]), ReLU, masked. Computed as flax's
    GroupNorm computes it (`layers.flax_norm`): with one channel a group
    x - mean is 0 and y the bias exactly."""
    f = flax_norm(sp.features, gn.num_groups, gn.weight, gn.bias, gn.eps)
    return sp._replace(features=F.relu(f) * sp.mask[..., None])


def subm(conv: SpConvWeight, sp: SparseTensor,
         rulebooks) -> SparseTensor:
    return sp._replace(features=batched_conv(sp, rulebooks, taps(conv),
                                             sp.mask))


def basic_block(net, sp: SparseTensor, rulebooks) -> SparseTensor:
    """SubM, BN, ReLU, SubM, BN, + x, ReLU, masked (the reference's
    SparseBasicBlock; JAX `_SparseBasicBlock`); net = (conv1, norm1,
    conv2, norm2)."""
    conv1, norm1, conv2, norm2 = net
    m = sp.mask[..., None]
    x = subm(conv1, sp, rulebooks)
    f = F.relu(row_bn(norm1, x.features, sp.mask)) * m
    x = subm(conv2, sp._replace(features=f), rulebooks)
    f = row_bn(norm2, x.features, sp.mask)
    return sp._replace(features=F.relu(f + sp.features) * m)


def strided_block(conv: SpConvWeight, bn: BatchNorm, sp: SparseTensor,
                  grid, out_grid, capacity: int, padding=1,
                  sites: list = None) -> SparseTensor:
    """A strided SparseConv3d (kernel 3, stride 2, `padding` per axis),
    BN, ReLU on the output sites under `capacity` (JAX `_StridedBlock`,
    `_GeneralStridedBlock`); each sample's site count before the cap is
    appended to `sites`."""
    outs = [downsample_sites(i, m, grid, out_grid, capacity,
                             padding=padding)
            for i, m in zip(sp.ids, sp.mask)]
    out_ids = torch.stack([o[0] for o in outs])
    out_mask = torch.stack([o[1] for o in outs])
    if sites is not None:
        sites.append(torch.stack([o[2] for o in outs]))
    rbs = [build_strided_rulebook(i, m, oi, om, grid, out_grid,
                                  padding=padding)
           for i, m, oi, om in zip(sp.ids, sp.mask, out_ids, out_mask)]
    f = batched_conv(sp, rbs, taps(conv), out_mask)
    f = F.relu(row_bn(bn, f, out_mask)) * out_mask[..., None]
    return SparseTensor(out_ids, f, out_mask)


def densify(sp: SparseTensor, grid) -> torch.Tensor:
    """-> [B, C, X, Y, Z] fp32."""
    return torch.stack([to_dense(i, f, m, grid) for i, f, m in zip(*sp)]
                       ).permute(0, 4, 1, 2, 3).float().contiguous()


def _net(block: SparseBasicBlock):
    """A dense-twin basic block's (conv1, norm1, conv2, norm2)."""
    net = block.net
    return net[0], net[1], net[3], net[4]


def _halve(grid) -> Tuple[int, int, int]:
    return tuple(int(s) // 2 for s in grid)


class SparseLiDAREnc8x(DenseLiDAREnc8x):
    """SparseTensor on sparse_shape_xyz -> [B, out_channel, X/8, Y/8,
    Z/8] fp32, with DenseLiDAREnc8x's parameters: a SubM stem, GN, then
    three levels of a strided block and two basic blocks, a SubM and GN
    out."""

    def __init__(self, input_channel: int = 4, base_channel: int = 16,
                 out_channel: int = 128,
                 sparse_shape_xyz=(800, 800, 64)):
        super().__init__(input_channel, base_channel, out_channel)
        self.sparse_shape_xyz = tuple(int(s) for s in sparse_shape_xyz)
        self.level_sites: List[torch.Tensor] = []

    def forward(self, sp: SparseTensor, capacity: int) -> torch.Tensor:
        self.level_sites = []
        grid = self.sparse_shape_xyz
        x = subm(self.conv_input[0], sp, subm_rulebooks(sp, grid))
        x = row_gn_relu(self.conv_input[1], x)
        for lvl in (1, 2, 3):
            blocks = getattr(self, f"conv{lvl}")
            out_grid = _halve(grid)
            x = strided_block(blocks[0][0], blocks[0][1], x, grid, out_grid,
                              capacity, sites=self.level_sites)
            grid = out_grid
            rbs = subm_rulebooks(x, grid)
            x = basic_block(_net(blocks[1]), x, rbs)
            x = basic_block(_net(blocks[2]), x, rbs)
        x = subm(self.conv_out[0], x, rbs)
        return densify(row_gn_relu(self.conv_out[1], x), grid)


class SparseLiDAREnc4x(nn.Module):
    """SparseTensor on sparse_shape_xyz -> [B, out_channel, X/4, Y/4,
    Z/4] fp32: a SubM stem, GN, two basic blocks at the base width, then
    two levels of a strided block and two basic blocks, a SubM and GN
    out (JAX `SparseLiDAREnc4x`)."""

    def __init__(self, input_channel: int = 4, base_channel: int = 16,
                 out_channel: int = 128,
                 sparse_shape_xyz=(800, 800, 64)):
        super().__init__()
        b = base_channel
        self.sparse_shape_xyz = tuple(int(s) for s in sparse_shape_xyz)
        self.level_sites: List[torch.Tensor] = []
        self.conv_input = nn.ModuleList([
            SpConvWeight(input_channel, b), nn.GroupNorm(16, b), nn.ReLU()])
        self.conv1 = nn.ModuleList([SparseBasicBlock(b),
                                    SparseBasicBlock(b)])
        for lvl, (ci, co) in ((2, (b, 2 * b)), (3, (2 * b, 4 * b))):
            setattr(self, f"conv{lvl}", nn.ModuleList([
                nn.ModuleList([SpConvWeight(ci, co), BatchNorm(co),
                               nn.ReLU()]),
                SparseBasicBlock(co), SparseBasicBlock(co)]))
        self.conv_out = nn.ModuleList([
            SpConvWeight(4 * b, out_channel), nn.GroupNorm(16, out_channel),
            nn.ReLU()])

    def forward(self, sp: SparseTensor, capacity: int) -> torch.Tensor:
        self.level_sites = []
        grid = self.sparse_shape_xyz
        rbs = subm_rulebooks(sp, grid)
        x = row_gn_relu(self.conv_input[1],
                        subm(self.conv_input[0], sp, rbs))
        for blk in self.conv1:
            x = basic_block(_net(blk), x, rbs)
        for lvl in (2, 3):
            blocks = getattr(self, f"conv{lvl}")
            out_grid = _halve(grid)
            x = strided_block(blocks[0][0], blocks[0][1], x, grid, out_grid,
                              capacity, sites=self.level_sites)
            grid = out_grid
            rbs = subm_rulebooks(x, grid)
            x = basic_block(_net(blocks[1]), x, rbs)
            x = basic_block(_net(blocks[2]), x, rbs)
        x = subm(self.conv_out[0], x, rbs)
        return densify(row_gn_relu(self.conv_out[1], x), grid)
