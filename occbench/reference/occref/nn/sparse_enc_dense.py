"""Dense masked-conv3d twin of the SparseLiDAREnc8x LiDAR encoder.

Counterpart of coocc_tpu/nn/sparse_enc_dense.py `DenseLiDAREnc8x`, selected
by pts.impl="dense"; the default, `PackedLiDAREnc8x` (sparse_enc_packed.py),
inherits its parameters and computes the same math in z-packed 2D form.
spconv's sparse semantics as masked dense convolutions:

  * inactive cells hold zeros, so a dense conv gives the sparse conv's sums
    at every site;
  * SubM layers multiply their outputs by the level's activity mask;
  * a strided SparseConv3d dilates the activity: the new mask is a max-pool
    (k 3, s 2, p 1) of the old one;
  * BatchNorm (eval: running statistics) and the per-cell GroupNorm apply at
    active cells and are zeroed elsewhere.

Parameters keep the reference checkpoint's names and spconv2 layout
(sparse_lidar_enc.py:125-178): conv_input.{0: SubM, 1: GN16},
conv{1,2,3}.0.{0: strided conv, 1: BN}, conv{l}.{1,2}.net.{0,1,3,4},
conv_out.{0: SubM, 1: GN16}; spconv weights are [Cout, kz, ky, kx, Cin].
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, masked_batch_norm


class SpConvWeight(nn.Module):
    """A k x k x k spconv weight [Cout, kz, ky, kx, Cin] (conv_module.weight;
    k = 3 but for the HD encoder's 1x1x1 conv_out)."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, k, k, k, cin))

    def conv_weight(self) -> torch.Tensor:
        """-> [Cout, Cin, kx, ky, kz] for F.conv3d over [B, C, X, Y, Z]."""
        return self.weight.permute(0, 4, 3, 2, 1)

    def forward(self, x, stride=1):
        return F.conv3d(x, self.conv_weight(), stride=stride, padding=1)


def dilate_mask(mask: torch.Tensor) -> torch.Tensor:
    """Active sites of a k3 s2 p1 sparse conv: [B, 1, X, Y, Z] float."""
    return F.max_pool3d(mask, 3, 2, 1)


def per_cell_group_norm(x, gn: nn.GroupNorm):
    """torch GroupNorm over [N_active, C] rows == each cell normalized over
    its own channel groups. x: [B, C, X, Y, Z]."""
    B, C = x.shape[:2]
    g = x.reshape(B, gn.num_groups, C // gn.num_groups, -1)
    mean = g.mean(dim=2, keepdim=True)
    var = g.var(dim=2, unbiased=False, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + gn.eps)).reshape(x.shape)
    return y * gn.weight[None, :, None, None, None] \
        + gn.bias[None, :, None, None, None]


def grid_bn(bn: BatchNorm, y: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """BatchNorm of a [B, C, X, Y, Z] grid at its active cells (mask
    [B, 1, X, Y, Z] float), zero elsewhere: in eval the running
    statistics'; in training the active cells' statistics, as JAX's
    `_DenseMaskedBN` (`layers.masked_batch_norm`). Returns fp32: JAX's
    masked BatchNorm promotes a bf16 y to its fp32 parameters (in eval
    its fp32 running statistics)."""
    if bn.training:
        return masked_batch_norm(bn, y, mask[:, 0] > 0)
    return bn(y.float()) * mask


class SparseBasicBlock(nn.Module):
    """net = (SubM, BN, ReLU, SubM, BN); residual add; ReLU (masked)."""

    def __init__(self, c: int):
        super().__init__()
        self.net = nn.ModuleList([SpConvWeight(c, c), BatchNorm(c), nn.ReLU(),
                                  SpConvWeight(c, c), BatchNorm(c)])

    def forward(self, x, mask):
        y = self.net[0](x) * mask
        y = F.relu(grid_bn(self.net[1], y, mask)) * mask
        y = self.net[3](y) * mask
        y = grid_bn(self.net[4], y, mask)
        return F.relu(y + x) * mask


class DenseLiDAREnc8x(nn.Module):
    """[B, X, Y, Z] bool occupancy -> [B, out_channel, X/8, Y/8, Z/8] fp32.

    compute_dtype is JAX's: the stem (the conv of the mask) runs in it and
    rounds once, and the first BatchNorm reads it in that dtype; every
    layer after that BatchNorm is fp32, as in JAX, whose masked BatchNorm
    promotes a bf16 input to fp32 through its parameters.

    Training (JAX `train=True`): every BatchNorm takes the statistics of
    its level's active cells (`grid_bn`), the strided levels' the dilated
    mask's; level 0 collapses as in eval (JAX takes the collapse in
    training too: the stem conv has no gradient, the stem GroupNorm's bias
    has). With a bf16 compute_dtype the first BatchNorm's statistics are
    bf16 sums, means and variances, as JAX's are
    (`layers._masked_bn_narrow`); its gradient is computed in fp32 and
    rounded once."""

    def __init__(self, input_channel: int = 4, base_channel: int = 16,
                 out_channel: int = 128,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if base_channel != 16:
            raise ValueError("the level-0 collapse assumes GroupNorm(16, 16)")
        self.compute_dtype = compute_dtype
        b = base_channel
        self.conv_input = nn.ModuleList([
            SpConvWeight(input_channel, b), nn.GroupNorm(16, b), nn.ReLU()])
        for lvl, (ci, co) in enumerate([(b, 2 * b), (2 * b, 4 * b),
                                        (4 * b, 8 * b)], start=1):
            setattr(self, f"conv{lvl}", nn.ModuleList([
                nn.ModuleList([SpConvWeight(ci, co), BatchNorm(co),
                               nn.ReLU()]),
                SparseBasicBlock(co), SparseBasicBlock(co)]))
        self.conv_out = nn.ModuleList([
            SpConvWeight(8 * b, out_channel), nn.GroupNorm(16, out_channel),
            nn.ReLU()])

    def forward(self, occupancy: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        mask = occupancy[:, None].to(cd)
        # Level 0 collapses. The stem is SubM -> GroupNorm(16, 16) -> ReLU;
        # with one channel per group the GN maps every value to its bias, so
        # the stem output is exactly relu(gn_bias) at active cells (in the
        # reference's torch graph too: the voxel features never matter).
        # conv1's strided conv over that channel-constant field is a conv of
        # the occupancy mask with the weight contracted against relu(bias).
        stem = F.relu(self.conv_input[1].bias)
        down = self.conv1[0]
        w_eff = torch.einsum("oixyz,i->oxyz", down[0].conv_weight(), stem)
        y = F.conv3d(mask, w_eff[:, None].to(cd), stride=2, padding=1)
        mask = mask.float()
        for lvl in (1, 2, 3):
            blocks = getattr(self, f"conv{lvl}")
            down = blocks[0]
            if lvl > 1:
                y = down[0](y, stride=2)
            mask = dilate_mask(mask)
            y = y * mask.to(y.dtype)
            y = F.relu(grid_bn(down[1], y, mask)) * mask
            y = blocks[1](y, mask)
            y = blocks[2](y, mask)
        y = self.conv_out[0](y) * mask
        y = per_cell_group_norm(y, self.conv_out[1]) * mask
        return F.relu(y) * mask
