"""Z-packed twin of the SparseLiDAREnc8x LiDAR encoder (the flagship's).

Counterpart of coocc_tpu/nn/sparse_enc_packed.py `PackedLiDAREnc8x`, its
default (hybrid) route `_forward_packed`. Same parameters as
`DenseLiDAREnc8x` (the class inherits them, so one state_dict loads into
either) and the same math, computed so that every convolution is a 2D one:

  * lane-major  [B, X, Y, Z*C]      z-major lanes, for the stem;
  * packed      [B, bz, X, Y, p*C]  z split into bz packs of p slots
    (p = the largest divisor of Z with p*C <= 128), lane slot*C + c; the
    pack index lives in the batch dim.

  * stem: the level-0 collapse (see sparse_enc_dense.py) as ONE stride-2
    conv2d of the [B, X0, Y0, Z0] mask with a [3, 3, Z0, Z1*C1] weight, the
    z taps unrolled into it; the active sites by the same conv of the mask
    with a 0/1 weight (count > 0.5);
  * SubM 3x3x3 conv: ONE 3x3 conv2d over [p*C core | C up-carry | C
    dn-carry] lanes with a block-tridiagonal [3, 3, (p+2)*C, p*Co] weight,
    through kernel K2 (`ops/subm_conv.py:subm_ext_conv`), whose epilogue
    applies the output mask and, inside a SparseBasicBlock, its BatchNorm,
    ReLU and residual: a block is two K2 launches and no other pass. K2
    takes a level whose p*C fills the 128 lanes (every level of every
    shipped grid); a level that packs fewer (p*C = 96 or 64: the 32- and
    64-channel levels at LiDAR depths 36, 20 and 12, see `pick_pack`) takes
    the same conv as JAX's XLA computes it there (`subm_conv_narrow`:
    cuDNN on the card, in the activation's dtype), with the BatchNorm, ReLU
    and residual as JAX's separate ops (`packed_subm`);
  * strided 3x3x3 conv (down2, down3): a stride-2 conv2d in packed layout
    with a [3, 3, (p+2)*Ci, p_out*Co] weight where p == 2*p_out, which keeps
    the pack rows (every shipped grid); elsewhere, as in JAX, one stride-2
    conv2d in lane-major layout with a [3, 3, Z*Ci, (Z//2)*Co] weight, the
    z taps unrolled into it (an odd Z floors: 9 -> 4 at depth 36);
  * the downsamples' BatchNorm (running statistics) and the per-cell
    GroupNorm as per-lane affines tiled p times, times the cell mask
    broadcast over each slot's lanes. Packed tensors are made contiguous
    where they are made.

Numerics: the SubM convolutions K2 takes have bf16 operands with fp32 sums
(K2's, on the card and in its plain version alike); the narrow route's
operands are the activation's dtype, as in JAX's XLA route. With
compute_dtype fp32 everything else is fp32: the encoder then equals the JAX
packed encoder run with COOCC_PALLAS_SUBM (its Pallas kernel path), not the
JAX pure-fp32 XLA path, and differs from `DenseLiDAREnc8x` by the bf16
rounding of K2's operands. With compute_dtype bf16 (JAX `compute_dtype=cd`) the mask, the
stem, the strided and mask-count convs and every packed activation are bf16
(K2 reads, writes and adds its residual in bf16); the downsamples' BN and
K2's epilogue compute in fp32 and round once where JAX rounds each of its
bf16 ops; the per-cell GroupNorm runs on fp32 and the output is fp32, as in
JAX (sparse_enc_packed.py:769-775).

Training (`.train()`): every BatchNorm takes its statistics over the active
cells only and moves its running variance towards the unbiased n/(n-1) one
(JAX `_PackedBNCore`, sparse_enc_packed.py:255-275, its affine in the
compute dtype); a SparseBasicBlock is K2 (mask, `subm_conv`, which has a
gradient; the narrow route's conv through autograd), BN, ReLU, K2 (mask),
BN, + x, ReLU, mask (JAX :441-449), and the
downsamples' BN follows the same rule. K2's fused BN epilogues read running
statistics and run in eval only.

JAX's other layouts of this function - the z-batch tap blocks
(`ztap_levels`, `_ZTapBasicBlock`), the z-batch stem and downsamples
(`zb_down`) and COOCC_STRIDED_MODE=lm|packed - were chosen for the TPU's
MXU and compute the same outputs (tests/test_torch_gather_encoders.py
holds each against this encoder): the port takes `pts.ztap_levels` and
runs this form.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.constants import device_constant
from ..ops.subm_conv import (ZERO_TAP, BNAffine, conv2d_nhwc,
                             epilogue_plain, gather_taps, k2_takes, masked,
                             shift_ext, subm_conv, subm_conv_narrow,
                             subm_ext_conv)
from .layers import BatchNorm
from .sparse_enc_dense import (DenseLiDAREnc8x, SpConvWeight,
                               per_cell_group_norm)

# ---------------------------------------------------------------------------
# block weights from [27, Cin, Cout] tap weights, taps kx-major, i.e.
# w27.reshape(3, 3, 3, ...) is (kx, ky, kz). Each is one gather of a z tap
# (or of a zero block, ZERO_TAP) per (input slot, output slot) pair; the
# SubM one, subm_ext_weight, lives beside K2 in ops/subm_conv.py.
# ---------------------------------------------------------------------------


def tap_weight(conv: SpConvWeight) -> torch.Tensor:
    """spconv [Cout, kz, ky, kx, Cin] -> [27, Cin, Cout], taps kx-major."""
    w = conv.weight
    return w.permute(3, 2, 1, 4, 0).reshape(27, w.shape[4], w.shape[0])


def _strided_table(z_in: int) -> np.ndarray:
    z_out = z_in // 2
    t = np.full((z_in, z_out), ZERO_TAP, np.int64)
    for zo in range(z_out):
        for dz in range(3):
            zi = 2 * zo + dz - 1
            if 0 <= zi < z_in:
                t[zi, zo] = dz
    return t


def _strided_packed_table(p_in: int, p_out: int, padz: int) -> np.ndarray:
    t = np.full((p_in + 2, p_out), ZERO_TAP, np.int64)
    for so in range(p_out):
        for dz in range(3):
            u = 2 * so + dz - padz
            if 0 <= u < p_in:
                t[u, so] = dz
            elif u == -1:
                t[p_in + 1, so] = dz   # dn carry
            elif u == p_in:
                t[p_in, so] = dz       # up carry
    return t


def strided_weight(w27: torch.Tensor, z_in: int) -> torch.Tensor:
    """[27, Ci, Co] -> [3, 3, z_in*Ci, (z_in//2)*Co] for stride-2 z."""
    return gather_taps(w27, _strided_table(z_in))


def strided_packed_weight(w27: torch.Tensor, p_in: int, p_out: int,
                          padz: int = 1) -> torch.Tensor:
    """[27, Ci, Co] -> [3, 3, (p_in+2)*Ci, p_out*Co]: a stride-2-z conv in
    packed layout (pack rows kept when p_in == 2*p_out), z padding padz:
    output slot so reads input slot 2*so + dz - padz, the dn carry at
    padz = 1, the up carry at padz = 0 (JAX
    sparse_enc_packed_hd.py:_strided_packed_weight_z)."""
    return gather_taps(w27, _strided_packed_table(p_in, p_out, padz))


def _dilation(table: np.ndarray, device) -> torch.Tensor:
    t = table != ZERO_TAP
    return device_constant(np.broadcast_to(t, (3, 3) + t.shape).astype(
        np.float32), device)


def dilate_packed_weight(p_in: int, p_out: int, device="cpu",
                         padz: int = 1):
    """0/1 [3, 3, p_in+2, p_out] mask-dilation weight in packed layout."""
    return _dilation(_strided_packed_table(p_in, p_out, padz), device)


def dilate_weight(z_in: int, device="cpu") -> torch.Tensor:
    """0/1 [3, 3, z_in, z_in//2] mask-dilation weight (k3 s2 p1)."""
    return _dilation(_strided_table(z_in), device)


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def pick_pack(C: int, Z: int) -> int:
    """Largest divisor of Z with p*C <= 128 (pack p z-slots into lanes)."""
    p = max(1, min(128 // C, Z))
    while Z % p:
        p -= 1
    return p


def lm_to_pb(x_lm: torch.Tensor, Z: int, C: int, p: int) -> torch.Tensor:
    """[B, X, Y, Z*C] -> [B, bz, X, Y, p*C]."""
    B, X, Y, _ = x_lm.shape
    return x_lm.reshape(B, X, Y, Z // p, p * C).permute(0, 3, 1, 2, 4)


def pb_to_lm(x_pb: torch.Tensor) -> torch.Tensor:
    """[B, bz, X, Y, p*C] -> [B, X, Y, Z*C]."""
    B, bz, X, Y, pc = x_pb.shape
    return x_pb.permute(0, 2, 3, 1, 4).reshape(B, X, Y, bz * pc)


def mask_pb(mask_lm: torch.Tensor, p: int) -> torch.Tensor:
    """[B, X, Y, Z] -> [B, bz, X, Y, p]."""
    B, X, Y, Z = mask_lm.shape
    return mask_lm.reshape(B, X, Y, Z // p, p).permute(0, 3, 1, 2, 4)


def conv2d_pb(x_pb: torch.Tensor, w: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    """conv2d over the (X, Y) dims of a packed [B, bz, X, Y, L] tensor."""
    B, bz, X, Y, L = x_pb.shape
    out = conv2d_nhwc(x_pb.reshape(B * bz, X, Y, L), w, stride)
    return out.reshape(B, bz, X // stride, Y // stride, -1)


# ---------------------------------------------------------------------------
# packed layers
# ---------------------------------------------------------------------------

def bn_affine(bn: BatchNorm) -> BNAffine:
    """Eval BatchNorm as K2's epilogue reads it, inv as JAX computes it."""
    inv = (1.0 / torch.sqrt(bn.running_var + bn.eps)) * bn.weight
    return BNAffine(bn.running_mean, inv, bn.bias)


def packed_bn_eval(bn: BatchNorm, x_pb: torch.Tensor,
                   mcell: torch.Tensor) -> torch.Tensor:
    """JAX `_PackedBNCore` in eval as separate ops in x_pb's dtype: mean,
    inverse and bias tiled over the p slots and rounded to it, then
    ((x - mean) * inv + bias) times the mask."""
    p, dt = mcell.shape[-1], x_pb.dtype
    a = bn_affine(bn)
    y = (x_pb - a.mean.repeat(p).to(dt)) * a.inv.repeat(p).to(dt) \
        + a.bias.repeat(p).to(dt)
    return masked(y, mcell)


def packed_subm(conv: SpConvWeight, x_pb: torch.Tensor, mcell: torch.Tensor,
                C_in: int, bn: Optional[BatchNorm] = None,
                identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SubM 3x3x3 conv of packed lanes, with K2's epilogue: times the output
    mask, then bn and ReLU when bn is given, with + identity before the ReLU
    when that is given too. Through K2 where it takes x_pb (`k2_takes`),
    else the narrow route and the epilogue as JAX's separate ops
    (`_PackedBasicBlock`, nn/sparse_enc_packed.py:441-449)."""
    p = x_pb.shape[-1] // C_in
    if k2_takes(x_pb):
        return subm_ext_conv(x_pb, tap_weight(conv), p, mcell,
                             None if bn is None else bn_affine(bn), identity)
    y = subm_conv_narrow(x_pb, tap_weight(conv), p, mcell)
    if bn is None:
        return y
    y = packed_bn_eval(bn, y, mcell)
    if identity is None:
        return F.relu(y)
    return masked(F.relu(y + identity), mcell)


def packed_subm_train(conv: SpConvWeight, x_pb: torch.Tensor,
                      mcell: torch.Tensor, C_in: int) -> torch.Tensor:
    """The mask-only SubM conv with a gradient: K2's `subm_conv` where K2
    takes x_pb, else the narrow route."""
    p = x_pb.shape[-1] // C_in
    conv_fn = subm_conv if k2_takes(x_pb) else subm_conv_narrow
    return conv_fn(x_pb, tap_weight(conv), p, mcell)


def packed_basic_block(block, x_pb: torch.Tensor, mcell: torch.Tensor,
                       C: int) -> torch.Tensor:
    """SparseBasicBlock in packed layout: SubM, BN, ReLU, SubM, BN, + x,
    ReLU, as two K2 launches and no other pass (or the narrow route's
    convs and JAX's ops where K2 does not take the lanes)."""
    net = block.net
    y = packed_subm(net[0], x_pb, mcell, C, bn=net[1])
    return packed_subm(net[3], y, mcell, C, bn=net[4], identity=x_pb)


class _PackedBNTrain(torch.autograd.Function):
    """The masked BatchNorm of `packed_bn_train` on x5 [..., p, C] and the
    cell mask [..., p]: -> (y, mean, var, n). The backward keeps x5 in its
    dtype, the mask and the [C] statistics, and computes the gradient of
    the batch-statistics normalization in fp32 from them, rounded once to
    x5's dtype (autograd through the forward's ops would keep an fp32 and
    two more copies of the input: 2.95 GB a BatchNorm at coocc_lidar's
    stage 0)."""

    @staticmethod
    def forward(ctx, x5, mcell, weight, bias, eps):
        dt = x5.dtype
        m = mcell[..., None].to(dt)
        xm = (x5 * m).float()
        dims = tuple(range(x5.dim() - 1))
        n = mcell.sum().float().clamp(min=1.0)
        mean = xm.sum(dims) / n
        var = ((xm * x5).sum(dims) / n - mean * mean).clamp(min=0.0)
        del xm
        rstd = 1.0 / torch.sqrt(var + eps)
        inv = rstd * weight
        y = ((x5 - mean.to(dt)) * inv.to(dt) + bias.to(dt)) * m
        ctx.save_for_backward(x5, mcell, weight, mean, rstd, n)
        ctx.mark_non_differentiable(mean, var, n)
        return y, mean, var, n

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar, _gn):
        x5, mcell, weight, mean, rstd, n = ctx.saved_tensors
        dims = tuple(range(x5.dim() - 1))
        m = mcell[..., None].float()
        # fp32 temporaries, updated in place: a pass over x5 each
        g = torch.mul(gy, m)
        xc = torch.sub(x5, mean).mul_(m)
        db = g.sum(dims)
        dinv = (g * xc).sum(dims)
        inv = rstd * weight
        # the mean's own gradient and the variance's (var = E[x^2] - mu^2
        # over the n active cells, inv = weight / sqrt(var + eps))
        dmean = -db * inv
        dvar = dinv * weight * (-0.5) * rstd ** 3
        dx = xc.mul_(2.0 * dvar / n).addcmul_(g, inv).addcmul_(m, dmean / n)
        return dx.to(x5.dtype), None, dinv * rstd, db, None


def packed_bn_train(bn: BatchNorm, x_pb: torch.Tensor,
                    mcell: torch.Tensor) -> torch.Tensor:
    """JAX `_PackedBNCore` in training: statistics of the active cells of
    x_pb [..., p*C] (fp32 sums; n the active cells), the running ones moved
    towards them by bn's own momentum with the variance scaled by n/(n-1),
    and the affine with mean, inverse and bias rounded to x_pb's dtype,
    times the mask (`_PackedBNTrain`)."""
    p, C = mcell.shape[-1], bn.weight.shape[0]
    x5 = x_pb.reshape(*x_pb.shape[:-1], p, C)
    y, mean, var, n = _PackedBNTrain.apply(x5, mcell, bn.weight, bn.bias,
                                           bn.eps)
    with torch.no_grad():
        bn.running_mean.copy_(bn.decay * bn.running_mean
                              + (1 - bn.decay) * mean)
        bn.running_var.copy_(bn.decay * bn.running_var + (1 - bn.decay)
                             * var * n / (n - 1).clamp(min=1.0))
    return y.reshape(x_pb.shape)


def packed_basic_block_train(conv1: SpConvWeight, norm1: BatchNorm,
                             conv2: SpConvWeight, norm2: BatchNorm,
                             x_pb: torch.Tensor, mcell: torch.Tensor,
                             C: int) -> torch.Tensor:
    """SparseBasicBlock in training (JAX `_PackedBasicBlock`, and the HD
    encoder's `_HDBasicBlock`): SubM (mask), BN, ReLU, SubM (mask), BN,
    + x, ReLU, mask; each SubM `packed_subm_train`."""
    y = packed_subm_train(conv1, x_pb, mcell, C)
    y = F.relu(packed_bn_train(norm1, y, mcell))
    y = packed_subm_train(conv2, y, mcell, C)
    y = packed_bn_train(norm2, y, mcell)
    return masked(F.relu(y + x_pb), mcell)


class PackedLiDAREnc8x(DenseLiDAREnc8x):
    """[B, X, Y, Z] bool occupancy -> [B, out_channel, X/8, Y/8, Z/8] fp32,
    with DenseLiDAREnc8x's parameters; the activations up to the per-cell
    GroupNorm are in compute_dtype."""

    def _down_bn_relu(self, bn: BatchNorm, d: torch.Tensor,
                      mcell: torch.Tensor) -> torch.Tensor:
        """A downsample's masked BN + ReLU: in eval K2's BN+ReLU epilogue
        ops, in fp32 with one rounding to d's dtype; in training JAX's
        (`down("norm", d * mf, mf, train)`, then ReLU)."""
        if self.training:
            return F.relu(packed_bn_train(bn, masked(d, mcell), mcell))
        return epilogue_plain(d, mcell, bn_affine(bn)).to(d.dtype)

    def _block(self, block, d, mcell, C):
        if self.training:
            net = block.net
            return packed_basic_block_train(net[0], net[1], net[3], net[4],
                                            d, mcell, C)
        return packed_basic_block(block, d, mcell, C)

    def forward(self, occupancy: torch.Tensor) -> torch.Tensor:
        b = self.conv_input[1].weight.shape[0]
        Z0 = occupancy.shape[-1]
        cd = self.compute_dtype
        mask0f = occupancy.to(cd)

        # level-0 collapse: the stem is relu(gn bias) at active cells, so
        # down1 is a conv of the mask, its z taps unrolled into the weight
        stem = F.relu(self.conv_input[1].bias)
        down = self.conv1[0]
        w_eff = torch.einsum("kio,i->ko", tap_weight(down[0]),
                             stem)[:, None, :]                 # [27, 1, 2b]
        C, Z = 2 * b, Z0 // 2
        p = pick_pack(C, Z)
        # one stride-2 conv, the math of JAX's space-to-depth form
        d_lm = conv2d_nhwc(mask0f, strided_weight(w_eff, Z0), 2)
        cnt = conv2d_nhwc(mask0f, dilate_weight(Z0, mask0f.device), 2)
        # the packed tensors are made contiguous where they are made: every
        # pass after this one, K2 among them, reads them densely
        d = lm_to_pb(d_lm, Z, C, p).contiguous()
        mcell = mask_pb(cnt > 0.5, p).contiguous()    # [B, bz, X, Y, p]
        d = self._down_bn_relu(down[1], d, mcell)
        d = self._block(self.conv1[1], d, mcell, C)
        d = self._block(self.conv1[2], d, mcell, C)

        for lvl in (2, 3):
            blocks = getattr(self, f"conv{lvl}")
            down = blocks[0]
            C_out = 2 * C
            p_out = pick_pack(C_out, Z // 2)
            w27 = tap_weight(down[0])
            if p == 2 * p_out:
                # packed stride-2-z downsample: only the dn carry takes part
                d = conv2d_pb(shift_ext(d, C),
                              strided_packed_weight(w27, p, p_out),
                              2).contiguous()
                cnt = conv2d_pb(shift_ext(mcell.to(cd), 1),
                                dilate_packed_weight(p, p_out, d.device), 2)
                mcell = (cnt > 0.5).contiguous()      # [B, bz, X, Y, p_out]
            else:
                # the pack rows do not halve: one lane-major stride-2 conv,
                # the z taps unrolled into its weight (JAX :724-732); an odd
                # Z floors
                d_lm = conv2d_nhwc(pb_to_lm(d), strided_weight(w27, Z), 2)
                cnt = conv2d_nhwc(pb_to_lm(mcell).to(cd),
                                  dilate_weight(Z, d.device), 2)
                d = lm_to_pb(d_lm, Z // 2, C_out, p_out).contiguous()
                mcell = mask_pb(cnt > 0.5, p_out).contiguous()
            Z, C, p = Z // 2, C_out, p_out
            d = self._down_bn_relu(down[1], d, mcell)
            d = self._block(blocks[1], d, mcell, C)
            d = self._block(blocks[2], d, mcell, C)

        if self.training:
            d = packed_subm_train(self.conv_out[0], d, mcell, C)
        else:
            d = packed_subm(self.conv_out[0], d, mcell, C)
        Co = self.conv_out[1].weight.shape[0]
        d5 = d.reshape(*d.shape[:-1], p, Co)
        # each cell normalized over its own channel groups, in fp32
        g = per_cell_group_norm(d5.float().reshape(-1, Co, 1, 1, 1),
                                self.conv_out[1]).reshape(d5.shape)
        g = F.relu(g * mcell[..., None].to(g.dtype))
        # packed [B, bz, X, Y, p, Co] -> [B, Co, X, Y, Z]
        Bs, bz, Xs, Ys = g.shape[:4]
        return g.permute(0, 5, 2, 3, 1, 4).reshape(
            Bs, Co, Xs, Ys, bz * p).contiguous()
