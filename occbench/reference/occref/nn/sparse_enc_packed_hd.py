"""Z-packed twin of the SparseEncoderHD LiDAR encoder (the LiDAR-only
model's, coocc_lidar).

In this reference copy the training forward recomputes each basic block
and stage exit in its backward (torch.utils.checkpoint): the same values,
less memory. A recomputed BatchNorm moves its running statistics a second
time; the train step's losses, gradients and parameters do not read them.

Counterpart of coocc_tpu/nn/sparse_enc_packed_hd.py `PackedEncoderHD`, the
JAX model's default for SparseEncoderHD (pts.impl "auto"). The voxel means
(ops/voxelize.py:voxelize) are scattered into a dense packed grid
[B, bz, X, Y, p*C] (nn/sparse_enc_packed.py's layout: lane slot*C + c,
pack index in the batch dim), inactive cells zero, and every sparse conv is
a 2D one over it, masked to its active cells:

  * packing: p0 = 8 slots of C0 = 16 channels (the smallest power of two
    that halves cleanly through the three strided stages with p0*C0 <=
    128), bz = ceil(Z0 / p0) = 9 packs for Z0 = 65 (72 slots, 7 past the
    grid, never active); p halves as C doubles, so every stage has p*C =
    128 lanes and bz stays 9;
  * SubM 3x3x3: the extended-lane conv of nn/sparse_enc_packed.py. Where
    the input has a multiple of 128 lanes it goes through K2
    (`sparse_enc_packed.packed_subm`, its BN + ReLU and residual fused),
    as JAX takes its Pallas kernel on exactly that condition
    (sparse_enc_packed.py:414-415); `conv_input`, 4 input channels at p =
    8 (32 lanes), takes JAX's XLA route: the plain conv, then the
    BatchNorm;
  * strided 3x3x3, stride 2 (the last block of stages 0-2): a stride-2
    conv2d in packed layout with z padding 1, 1 and 0
    (`strided_packed_weight(..., padz)`), the active cells by the same conv
    of the mask with 0/1 weights, clipped to the stage's true z extent
    (JAX sparse_enc_packed_hd.py:128-143: a slot past it would go active
    and feed the next stage's SubM neighbours);
  * conv_out: 1x1x1 per slot, BatchNorm, ReLU; then the unpack to
    [B, Co, X, Y, Z] fp32 ([:Z] of the last level's bz*p slots).

Every BatchNorm has eps 1e-3 (momentum 0.01), the reference's
SparseEncoderHD norm_cfg, which K2's fused epilogue reads (`bn_affine`).
Numerics as in nn/sparse_enc_packed.py: K2 rounds its operands to bf16 with
fp32 sums; in bf16 compute every packed activation is bf16 and each
BatchNorm computes in fp32 with one rounding; the output is fp32, as in
JAX.

Training (`.train()`, JAX's `train=True` branch): every BatchNorm takes
the statistics of its active cells and moves its running ones by its own
momentum (`sparse_enc_packed.packed_bn_train`, JAX `_PackedBNCore`);
conv_input is the plain conv, then that BatchNorm and ReLU; a basic block
is `sparse_enc_packed.packed_basic_block_train` (K2's mask-only forward
through `subm_conv`, whose backward is K2's dX and dW in torch ops); a
strided exit is its stride-2 conv, the count conv of the mask, the z clip,
then the BatchNorm over the new mask (its statistics and its output) and
ReLU (JAX `_HDStridedTwin`); conv_out the 1x1x1 conv, BatchNorm, ReLU.

Parameters carry the reference checkpoint's names
(coocc_tpu/train/convert_torch.py:254-285): conv_input.{0: SubM, 1: BN},
encoder_layers.encoder_layer{i+1}.{j} a basic block (conv1, norm1, conv2,
norm2) or, the last of encoder_layer1-3, {0: strided conv, 1: BN},
conv_out.{0: 1x1x1 conv, 1: BN}.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.constants import device_constant
from ..ops.conv import conv
from ..ops.sparse_tensor import SparseTensor, conv_output_shape
from ..ops.subm_conv import (N_LANES, conv2d_nhwc, epilogue_plain,
                             shift_ext, subm_ext_weight)
from ..ops.voxelize import delinearize
from .layers import BatchNorm
from .sparse_enc_dense import SpConvWeight
from .sparse_enc_packed import (bn_affine, conv2d_pb, dilate_packed_weight,
                                packed_basic_block_train, packed_bn_train,
                                packed_subm, strided_packed_weight,
                                tap_weight)

# the reference SparseEncoderHD's stages (coocc_lidar.py): each stage's
# block widths, the last block of stages 0-2 a stride-2 downsample with
# these paddings (z padding 0 at the third)
ENCODER_CHANNELS = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128))
STRIDED_PADDINGS = ((1, 1, 1), (1, 1, 1), (1, 1, 0))


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=1e-3, momentum=0.01)


class HDBasicBlock(nn.Module):
    """The reference's SparseBasicBlock at HD's norm_cfg: SubM, BN, ReLU,
    SubM, BN, + x, ReLU."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1, self.norm1 = SpConvWeight(c, c), _bn(c)
        self.conv2, self.norm2 = SpConvWeight(c, c), _bn(c)


def hd_subm(conv_w: SpConvWeight, x_pb: torch.Tensor, mcell: torch.Tensor,
            C_in: int, bn: BatchNorm, identity=None) -> torch.Tensor:
    """SubM 3x3x3 conv of packed lanes, BN, (+ identity), ReLU, masked:
    through K2 where x_pb has a multiple of 128 lanes (JAX's Pallas
    condition), else as JAX's XLA route computes it (the conv in x's
    dtype, then the BatchNorm in fp32, rounded once; in training, on the
    active cells' statistics)."""
    if x_pb.shape[-1] % N_LANES == 0:
        return packed_subm(conv_w, x_pb, mcell, C_in, bn, identity)
    B, bz, X, Y, L = x_pb.shape
    p = L // C_in
    y = conv2d_nhwc(shift_ext(x_pb, C_in).reshape(B * bz, X, Y, -1),
                    subm_ext_weight(tap_weight(conv_w), p)).reshape(
                        B, bz, X, Y, -1)
    # contiguous, as K2 reads the next layer's input
    if bn.training:
        return F.relu(packed_bn_train(bn, y, mcell)).contiguous()
    return epilogue_plain(y, mcell, bn_affine(bn),
                          identity).to(x_pb.dtype).contiguous()


class PackedEncoderHD(nn.Module):
    """SparseTensor (ids [B, A], voxel means [B, A, in_channels], mask) on
    the sparse_shape_xyz grid -> [B, output_channels, X/8, Y/8, Zl] fp32
    (Zl = 8 for Z0 = 65)."""

    def __init__(self, in_channels: int = 4, base_channels: int = 16,
                 output_channels: int = 128,
                 sparse_shape_xyz: Tuple[int, int, int] = (800, 800, 65),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sparse_shape_xyz = tuple(int(s) for s in sparse_shape_xyz)
        self.compute_dtype = compute_dtype
        self.conv_input = nn.ModuleList([
            SpConvWeight(in_channels, base_channels), _bn(base_channels)])
        self.encoder_layers = nn.Module()
        c = base_channels
        last = len(ENCODER_CHANNELS) - 1
        for i, blocks in enumerate(ENCODER_CHANNELS):
            layer = nn.ModuleList()
            for j, oc in enumerate(blocks):
                if j == len(blocks) - 1 and i != last:
                    layer.append(nn.ModuleList([SpConvWeight(c, oc),
                                                _bn(oc)]))
                else:
                    layer.append(HDBasicBlock(oc))
                c = oc
            self.encoder_layers.add_module(f"encoder_layer{i + 1}", layer)
        self.conv_out = nn.ModuleList([
            SpConvWeight(c, output_channels, k=1), _bn(output_channels)])

    def _pack0(self) -> Tuple[int, int]:
        """(p0, bz) of JAX's rule (sparse_enc_packed_hd.py:168-185)."""
        C0 = ENCODER_CHANNELS[0][0]
        p0 = 2 ** (len(ENCODER_CHANNELS) - 1)
        while p0 * 2 * C0 <= N_LANES:
            p0 *= 2
        return p0, -(-self.sparse_shape_xyz[2] // p0)

    def _scatter(self, sp: SparseTensor, p0: int, bz: int):
        """The voxel means into the packed grid [B, bz, X, Y, p0*Cin] (in
        the compute dtype) and its cell mask [B, bz, X, Y, p0] bool; each
        voxel id is written once, the padding goes to a sink row."""
        X0, Y0, Z0 = self.sparse_shape_xyz
        n = X0 * Y0 * bz * p0
        cin = sp.features.shape[-1]
        xs, ms = [], []
        for ids, feats, mask in zip(sp.ids, sp.features, sp.mask):
            c = delinearize(ids, self.sparse_shape_xyz)
            lin = torch.where(
                mask, (c[:, 0] * Y0 + c[:, 1]) * (bz * p0) + c[:, 2], n)
            buf = feats.new_zeros((n + 1, cin), dtype=self.compute_dtype)
            buf[lin] = feats.to(self.compute_dtype)
            occ = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
            occ[lin] = True
            xs.append(buf[:n].reshape(X0, Y0, bz, p0 * cin).permute(
                2, 0, 1, 3))
            ms.append(occ[:n].reshape(X0, Y0, bz, p0).permute(2, 0, 1, 3))
        return torch.stack(xs).contiguous(), torch.stack(ms).contiguous()

    def _down(self, down, x_pb, mcell, p: int, padz: int, z_out: int):
        """A strided stage exit: the stride-2 packed conv, its active cells
        clipped to the z_out grid slots, BN + ReLU in fp32 rounded once."""
        cd = x_pb.dtype
        p_out = p // 2
        cin = x_pb.shape[-1] // p
        y = conv2d_pb(shift_ext(x_pb, cin), strided_packed_weight(
            tap_weight(down[0]), p, p_out, padz), 2)
        cnt = conv2d_pb(shift_ext(mcell.to(cd), 1),
                        dilate_packed_weight(p, p_out, x_pb.device, padz), 2)
        bz = x_pb.shape[1]
        slot_z = np.arange(bz)[:, None] * p_out + np.arange(p_out)
        zvalid = device_constant(slot_z < z_out, x_pb.device)
        mcell = ((cnt > 0) & zvalid[:, None, None]).contiguous()
        if self.training:
            # the BatchNorm masks its statistics and its output
            return F.relu(packed_bn_train(down[1], y, mcell)).contiguous(), \
                mcell
        return epilogue_plain(y, mcell, bn_affine(down[1])).to(
            cd).contiguous(), mcell

    def forward(self, sp: SparseTensor) -> torch.Tensor:
        p, bz = self._pack0()
        x, mcell = self._scatter(sp, p, bz)
        x = hd_subm(self.conv_input[0], x, mcell, sp.features.shape[-1],
                    self.conv_input[1])
        z = self.sparse_shape_xyz[2]
        grid = self.sparse_shape_xyz
        last = len(ENCODER_CHANNELS) - 1
        for i, blocks in enumerate(ENCODER_CHANNELS):
            layer = getattr(self.encoder_layers, f"encoder_layer{i + 1}")
            for j, oc in enumerate(blocks):
                if j == len(blocks) - 1 and i != last:
                    padz = STRIDED_PADDINGS[i][2]
                    grid = conv_output_shape(grid, 3, 2, STRIDED_PADDINGS[i])
                    z = (z + 2 * padz - 3) // 2 + 1
                    if self.training:
                        # the reference recomputes each training stage exit
                        # and block in its backward: in fp32 the saved
                        # activations of the 800x800 level do not fit
                        x, mcell = checkpoint(self._down, layer[j], x, mcell,
                                              p, padz, z, use_reentrant=False)
                    else:
                        x, mcell = self._down(layer[j], x, mcell, p, padz, z)
                    p //= 2
                elif self.training:
                    blk = layer[j]
                    x = checkpoint(packed_basic_block_train, blk.conv1,
                                   blk.norm1, blk.conv2, blk.norm2, x, mcell,
                                   oc, use_reentrant=False)
                else:
                    blk = layer[j]
                    y = hd_subm(blk.conv1, x, mcell, oc, blk.norm1)
                    x = hd_subm(blk.conv2, y, mcell, oc, blk.norm2,
                                identity=x)
        # conv_out: 1x1x1 per slot, in the compute dtype summed in fp32
        w = self.conv_out[0].weight
        Co, Cl = w.shape[0], w.shape[-1]
        B, bz, X, Y, _ = x.shape
        y = conv(F.linear, x.reshape(B, bz, X, Y, p, Cl),
                 w.reshape(Co, Cl)).reshape(B, bz, X, Y, p * Co)
        if self.training:
            y = F.relu(packed_bn_train(self.conv_out[1], y, mcell))
        else:
            y = epilogue_plain(y, mcell, bn_affine(self.conv_out[1])).to(
                x.dtype)
        # packed [B, bz, X, Y, p, Co] -> [B, Co, X, Y, Z]
        y = y.reshape(B, bz, X, Y, p, Co).permute(0, 5, 2, 3, 1, 4).reshape(
            B, Co, X, Y, bz * p)
        return y[..., :grid[2]].float().contiguous()
