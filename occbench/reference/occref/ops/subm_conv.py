"""Packed SubM 3x3x3 convolution with cross-pack carries, and its epilogue
(kernel K2).

Counterpart of coocc_tpu/ops/pallas/subm_conv.py `subm_ext_conv` together
with the elementwise ops the JAX encoder applies to its output
(coocc_tpu/nn/sparse_enc_packed.py `_PackedSubM`, `_PackedBNCore`,
`_PackedBasicBlock`). The z-packed LiDAR encoder (nn/sparse_enc_packed.py)
keeps a level's z axis as bz packs of p slots, `[B, bz, X, Y, p*C]` with
lane `slot*C + c`, and computes each submanifold 3x3x3 conv as ONE 3x3
conv2d over the extended lanes `[p*C core | C up-carry | C dn-carry]`: the
up-carry is the first slot of the next pack, the dn-carry the last slot of
the previous one, both zero at a sample's first and last pack. The
extended weight `[3, 3, pC+2C, pCo]` (`subm_ext_weight`) is
block-tridiagonal: input slot z feeds only output slots z-1 .. z+1.

`subm_ext_conv` takes the tap weight `[27, C, Co]` and p, the output's
cell mask `[B, bz, X, Y, p]` and an epilogue, applied in fp32 before the
one store, in the JAX order:

  * mask (bn None):              conv * m
  * BN + ReLU (bn):              relu(((conv*m - mean)*inv + bias) * m)
  * BN + residual + ReLU (bn, identity):
                  relu(((conv*m - mean)*inv + bias) * m + identity) * m

where `inv = weight / sqrt(running_var + eps)` (`BNAffine`) and the
length-Co vectors are tiled over the p slots. Numerics of the conv are the
TPU kernel's: operands rounded to bf16 (round to nearest even), products
summed in fp32; the output has the input's dtype.

A CPU tensor takes `subm_ext_conv_plain`; a CUDA tensor launches the
hand-written kernel `csrc/subm_conv.cuh` (built as `subm_conv.cu` for bf16
activations and `subm_conv_f32.cu` for fp32) or raises. The kernel replaces the
Pallas kernel `_kernel` (called from `subm_ext_conv`,
coocc_tpu/ops/pallas/subm_conv.py:53,107); its design note is in the
source.

Training: `subm_conv` is the mask-only conv with a gradient (a
`torch.autograd.Function`; the fused BN epilogues read running statistics
and stay eval-only). The Pallas kernel has no backward of its own: JAX
trains through the XLA route of the same conv (nn/sparse_enc_packed.py:
431-433), whose custom VJP (ops/conv_acc.py:29-58) casts the cotangent to
the operands' dtype. Here, with dY the masked cotangent:

  * dX is a SubM conv of dY with the mirrored stencil, tap t taking
    w27[26 - t] transposed (`flip_taps`), at K2's numerics, without a mask
    (`subm_ext_conv_dx`: the kernel `subm_ext_conv_dx_kernel` of
    csrc/subm_conv_bwd.cuh, built as `subm_conv_dx.cu` for bf16 dX and
    `subm_conv_dx_f32.cu` for fp32; at p >= 4 its weight panels stay in
    shared memory, one column group a block, at p <= 2 they stream beside
    the halos, `dx_groups`);
  * dW [27, C, Co] is the extended weight's gradient, the shifted inputs
    (rounded to bf16, as the forward reads them) against dY summed over
    the cells in fp32 and rounded once to the activations' dtype (as JAX's
    conv transpose rounds it), then folded back onto the 27 taps in fp32
    (`gather_taps_transpose`): `subm_ext_weight_grad`, the kernel
    `subm_ext_weight_grad_kernel` of csrc/subm_conv_dw.cuh (built as
    `subm_weight_grad.cu`; wgmma, 4 K-blocks' x^T by a 32-column window
    of the tap-shifted cotangent a warpgroup), units of `dw_units` over
    the cell splits of `dw_splits`, then its reduce in a fixed order.

On the CPU both take the plain versions (`subm_ext_conv_dx_plain`,
`subm_ext_weight_grad_plain`): the autograd of an fp32 ext conv of the
bf16-rounded operands, with dY rounded to bf16 as K2 reads it for dX.

Which shapes take K2: those whose input lanes p*C fill whole 128-lane rows
(`k2_takes`), the rule by which JAX calls its Pallas kernel. The kernel
produces exactly 128 output lanes; every SubM of the shipped configs' grids
is such a shape. A z-packed grid whose depth leaves a level narrower (p*C =
96 or 64 lanes at LiDAR depths 36, 20 or 12, the 32- and 64-channel
levels) takes `subm_conv_narrow` instead: the conv JAX's XLA computes there,
in the activation's dtype. The choice is made from the shapes before any
launch; `subm_ext_conv` itself still raises on a shape it cannot take.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .constants import device_constant
from .conv import conv

ZERO_TAP = 3          # a z-tap table entry that selects a zero block
KB = 16               # input lanes per K-block of the kernel
N_LANES = 128         # output lanes p*Co the kernel produces
SLOT_WIDTHS = (16, 32, 64, 128)  # the Co the kernel is instantiated for

# ---------------------------------------------------------------------------
# block weights from [27, Cin, Cout] tap weights, taps kx-major, i.e.
# w27.reshape(3, 3, 3, ...) is (kx, ky, kz)
# ---------------------------------------------------------------------------


def gather_taps(w27: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """[27, Ci, Co] and an [n_in, n_out] table of z taps -> the block
    weight [3, 3, n_in*Ci, n_out*Co], block (i, o) = w3[:, :, table[i, o]]
    (a zero block where the table holds ZERO_TAP)."""
    _, Ci, Co = w27.shape
    w3 = w27.reshape(3, 3, 3, Ci, Co)
    w3 = torch.cat([w3, torch.zeros_like(w3[:, :, :1])], dim=2)
    n_in, n_out = table.shape
    idx = device_constant(table.reshape(-1), w27.device)
    blocks = w3[:, :, idx].reshape(3, 3, n_in, n_out, Ci, Co)
    return blocks.permute(0, 1, 2, 4, 3, 5).reshape(3, 3, n_in * Ci,
                                                    n_out * Co)


def subm_ext_table(p: int) -> np.ndarray:
    """[p+2, p] z taps: input slots 0..p-1, then the up and dn carries."""
    t = np.full((p + 2, p), ZERO_TAP, np.int64)
    for zo in range(p):
        for dz in range(3):
            zi = zo + dz - 1
            if 0 <= zi < p:
                t[zi, zo] = dz
    t[p, p - 1] = 2      # carry from the next pack's first slot
    t[p + 1, 0] = 0      # carry from the previous pack's last slot
    return t


def subm_ext_weight(w27: torch.Tensor, p: int) -> torch.Tensor:
    """[27, C, Co] -> [3, 3, (p+2)*C, p*Co] block-tridiagonal + carries."""
    return gather_taps(w27, subm_ext_table(p))


def tap_readers(table: np.ndarray) -> np.ndarray:
    """[3, k]: for each z tap, the blocks (i * n_out + o, in that order)
    that read it from an [n_in, n_out] table of z taps, padded with the
    index n_in * n_out (a zero block appended after them)."""
    flat = table.reshape(-1)
    lists = [np.flatnonzero(flat == dz) for dz in range(ZERO_TAP)]
    k = max(len(r) for r in lists)
    return np.stack([np.pad(r, (0, k - len(r)), constant_values=flat.size)
                     for r in lists])


def gather_taps_transpose(g: torch.Tensor, table: np.ndarray, Ci: int,
                          Co: int) -> torch.Tensor:
    """The transpose of `gather_taps`: a block weight's gradient [3, 3,
    n_in*Ci, n_out*Co] -> the taps' [27, Ci, Co], each tap summing the
    blocks that read it in fp32, in the order of `tap_readers` (a sum over
    one axis: the same order on every run, where atomics would not be)."""
    n_in, n_out = table.shape
    blocks = g.float().reshape(3, 3, n_in, Ci, n_out, Co).permute(
        0, 1, 2, 4, 3, 5).reshape(3, 3, n_in * n_out, Ci, Co)
    blocks = torch.cat([blocks, blocks.new_zeros(3, 3, 1, Ci, Co)], dim=2)
    idx = device_constant(tap_readers(table), g.device)
    return blocks[:, :, idx].sum(3).reshape(27, Ci, Co)


def flip_taps(w27: torch.Tensor) -> torch.Tensor:
    """[27, C, Co] -> [27, Co, C], tap t holding w27[26 - t] transposed:
    the SubM conv's transpose is the SubM conv with the mirrored stencil
    (taps kx-major, so 26 - t mirrors kx, ky and kz at once)."""
    return w27.flip(0).transpose(1, 2)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def shift_ext(x_pb: torch.Tensor, C: int) -> torch.Tensor:
    """[B, bz, X, Y, pC] -> [B, bz, X, Y, pC + 2C]: append the up-carry (the
    next pack's first C lanes) and the dn-carry (the previous pack's last C
    lanes), zero across a sample's first and last pack."""
    up = F.pad(x_pb[:, 1:, ..., :C], (0, 0, 0, 0, 0, 0, 0, 1))
    dn = F.pad(x_pb[:, :-1, ..., -C:], (0, 0, 0, 0, 0, 0, 1, 0))
    return torch.cat([x_pb, up, dn], dim=-1)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
    """[N, H, W, Ci] x [3, 3, Ci, Co] (HWIO) -> [N, H/s, W/s, Co], pad 1,
    in x's dtype (w is cast to it, as JAX's `_conv2d` casts); the
    convolution runs on channels_last views."""
    y = conv(F.conv2d, x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
             stride, 1)
    return y.permute(0, 2, 3, 1)


def masked(x_pb: torch.Tensor, mcell: torch.Tensor) -> torch.Tensor:
    """x_pb [..., p*C] times the cell mask [..., p], broadcast over each
    slot's C lanes (lane slot*C + c): the product with JAX's repeated lane
    mask, without a mask the width of the activations."""
    p = mcell.shape[-1]
    x5 = x_pb.reshape(*x_pb.shape[:-1], p, -1)
    return (x5 * mcell[..., None].to(x_pb.dtype)).reshape(x_pb.shape)


def ext_conv_plain(x_pb: torch.Tensor, w_ext: torch.Tensor, bz: int,
                   C: int) -> torch.Tensor:
    """JAX's `subm_ext_conv` in plain PyTorch (any device): x and w_ext
    rounded to bf16 and back, then an fp32 conv2d of shift_ext(x), in x's
    dtype. The product of two bf16 values is exact in fp32, so this is the
    kernel's arithmetic up to the order of the sums."""
    B, bz_, X, Y, pC = x_pb.shape
    if bz_ != bz:
        raise ValueError(f"subm_ext_conv: bz {bz} != x_pb.shape[1] {bz_}")
    xr = x_pb.to(torch.bfloat16).float()
    wr = w_ext.to(torch.bfloat16).float()
    ext = shift_ext(xr, C).reshape(B * bz, X, Y, pC + 2 * C)
    y = conv2d_nhwc(ext, wr)
    return y.reshape(B, bz, X, Y, -1).to(x_pb.dtype)


def subm_conv_unrounded(x_pb: torch.Tensor, w27: torch.Tensor, p: int,
                        mcell: torch.Tensor) -> torch.Tensor:
    """The mask-only SubM conv as JAX's XLA route computes it (a conv of
    shift_ext(x) with the extended weight in x's dtype, times the mask),
    its operands not rounded to bf16 in fp32, differentiable by autograd:
    `subm_conv_narrow` runs it where K2 does not take the lanes, and the
    tests and chip_smoke.py swap it in for `subm_conv` to hold the training
    encoder's wiring at fp32 tolerances."""
    B, bz, X, Y, pC = x_pb.shape
    ext = shift_ext(x_pb, pC // p).reshape(B * bz, X, Y, -1)
    y = conv2d_nhwc(ext, subm_ext_weight(w27, p)).reshape(B, bz, X, Y, -1)
    return masked(y, mcell)


def k2_takes(x_pb: torch.Tensor) -> bool:
    """Whether K2 computes the SubM conv of x_pb [..., p*C]: where its
    lanes fill whole 128-lane rows, as JAX calls its Pallas kernel there
    (nn/sparse_enc_packed.py:414-415); elsewhere `subm_conv_narrow`."""
    return x_pb.shape[-1] % N_LANES == 0


def subm_conv_narrow(x_pb: torch.Tensor, w27: torch.Tensor, p: int,
                     mcell: torch.Tensor) -> torch.Tensor:
    """The mask-only SubM conv where K2 does not take x_pb (`k2_takes`):
    JAX's XLA route there (nn/sparse_enc_packed.py:431-434),
    `subm_conv_unrounded` in x's dtype, i.e. fp32 operands unrounded and
    bf16 ones summed in fp32 and rounded once; cuDNN's conv on the card,
    differentiable by autograd. A CUDA tensor counts the call in
    `subm_conv_narrow.launches`."""
    return subm_conv_unrounded(x_pb, w27, p, mcell)



class BNAffine(NamedTuple):
    """An eval BatchNorm as the epilogue reads it: [Co] fp32 each, with
    inv = weight / sqrt(running_var + eps) computed as JAX's _PackedBNCore
    computes it."""
    mean: torch.Tensor
    inv: torch.Tensor
    bias: torch.Tensor


def epilogue_plain(y: torch.Tensor, mcell: torch.Tensor,
                   bn: Optional[BNAffine] = None,
                   identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epilogue on an fp32 conv output y [..., p*Co], in the JAX order
    (see the module note); fp32 out."""
    y = masked(y, mcell)
    if bn is None:
        return y
    p = mcell.shape[-1]
    y = masked((y - bn.mean.repeat(p)) * bn.inv.repeat(p) + bn.bias.repeat(p),
               mcell)
    if identity is None:
        return F.relu(y)
    return masked(F.relu(y + identity.float()), mcell)


def subm_ext_conv_plain(x_pb: torch.Tensor, w27: torch.Tensor, p: int,
                        mcell: torch.Tensor, bn: Optional[BNAffine] = None,
                        identity: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of `subm_ext_conv` (any device): JAX's conv
    (`ext_conv_plain`, its sums kept in fp32) then `epilogue_plain`, one
    rounding to x's dtype at the end, as the kernel stores."""
    C = x_pb.shape[-1] // p
    y = ext_conv_plain(x_pb.float(), subm_ext_weight(w27, p), x_pb.shape[1],
                       C)
    return epilogue_plain(y, mcell, bn, identity).to(x_pb.dtype)


# ---------------------------------------------------------------------------
# the reference's routes: every SubM conv in fp32, its operands unrounded
# ---------------------------------------------------------------------------

def subm_ext_conv(x_pb: torch.Tensor, w27: torch.Tensor, p: int,
                  mcell: torch.Tensor, bn: Optional[BNAffine] = None,
                  identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The SubM conv and its epilogue in fp32 on any device: the conv of
    shift_ext(x) with the extended weight, operands not rounded to bf16,
    then `epilogue_plain`; the result in x_pb's dtype."""
    B, bz, X, Y, pC = x_pb.shape
    ext = shift_ext(x_pb.float(), pC // p).reshape(B * bz, X, Y, -1)
    y = conv2d_nhwc(ext, subm_ext_weight(w27.float(), p)).reshape(
        B, bz, X, Y, -1)
    return epilogue_plain(y, mcell, bn, identity).to(x_pb.dtype)


def subm_conv(x_pb: torch.Tensor, w27: torch.Tensor, p: int,
              mcell: torch.Tensor) -> torch.Tensor:
    """The mask-only SubM conv with autograd's gradient
    (`subm_conv_unrounded`)."""
    return subm_conv_unrounded(x_pb, w27, p, mcell)
