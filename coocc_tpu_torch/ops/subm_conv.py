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

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ._build import load_kernel_library
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
    if x_pb.device.type == "cuda":
        subm_conv_narrow.launches += 1
    return subm_conv_unrounded(x_pb, w27, p, mcell)


subm_conv_narrow.launches = 0


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
# the kernel's weight panels
# ---------------------------------------------------------------------------

def kblocks(p: int, C: int, Co: int):
    """The kernel's K-blocks, in its order: 16 input lanes of one lane group
    of the extended input (core slots 0..p-1, the up-carry, the dn-carry)
    each, as (lane of x, pack offset of x (0, +1 or -1), first output
    column, number of output columns). Lane group z holds input slot z
    (the up-carry slot p, the dn-carry slot -1) and feeds output slots
    max(0, z-1) .. min(p-1, z+1) only: a contiguous column window, outside
    which its rows of the extended weight are structural zeros."""
    out = []
    groups = [(z * C, 0, z) for z in range(p)] + [(0, 1, p),
                                                  ((p - 1) * C, -1, -1)]
    for lane0, dg, z in groups:
        lo, hi = max(0, z - 1), min(p - 1, z + 1)
        for q in range(0, C, KB):
            out.append((lane0 + q, dg, lo * Co, (hi - lo + 1) * Co))
    return out


@functools.lru_cache(maxsize=None)
def _panel_index(p: int, C: int, Co: int) -> np.ndarray:
    """Flat indices into the extended weight [9, pC+2C, p*Co] of every
    element of the packed panels, in panel order: per K-block, per tap,
    [W/8 column groups][2 halves of the 16 rows][8 columns][8 rows] (the
    no-swizzle K-major core matrices of the kernel's B operand)."""
    # K-blocks tile the extended lanes in order: K-block i is lanes 16i..
    return _panels_of([(i, col0, width) for i, (_, _, col0, width)
                       in enumerate(kblocks(p, C, Co))], p, C, Co)


def _panels_of(rows, p: int, C: int, Co: int) -> np.ndarray:
    """`_panel_index` of the panels of rows (K-block index, first column,
    width), in their order."""
    E, N = (p + 2) * C, p * Co
    idx = []
    for i, col0, width in rows:
        e0 = i * KB
        tap = np.arange(9)[:, None, None, None, None]
        ng = np.arange(width // 8)[None, :, None, None, None]
        kh = np.arange(2)[None, None, :, None, None]
        r = np.arange(8)[None, None, None, :, None]
        c = np.arange(8)[None, None, None, None, :]
        e = e0 + kh * 8 + c
        n = col0 + ng * 8 + r
        idx.append(((tap * E + e) * N + n).reshape(-1))
    return np.concatenate(idx)


@functools.lru_cache(maxsize=16)
def _ktable(p: int, C: int, Co: int) -> np.ndarray:
    """kblocks() as the kernel's host table: int32 rows (lane, pack offset,
    first column, width)."""
    return np.ascontiguousarray(np.asarray(kblocks(p, C, Co), np.int32))


@functools.lru_cache(maxsize=None)
def _panel_index_on(p: int, C: int, Co: int, device: str) -> torch.Tensor:
    # cached by shape: the index runs to 4.4e5 entries, too many to hash
    # per call as device_constant does
    return torch.from_numpy(_panel_index(p, C, Co)).to(device)


def weight_panels(w27: torch.Tensor, p: int) -> torch.Tensor:
    """[27, C, Co] -> the kernel's packed bf16 weight panels (1-d): each
    K-block's 9 taps of its 16 rows over its column window only."""
    _, C, Co = w27.shape
    w_ext = subm_ext_weight(w27, p).reshape(-1)
    return w_ext[_panel_index_on(p, C, Co, str(w27.device))].to(
        torch.bfloat16)


# ---------------------------------------------------------------------------
# the backward kernels' host tables
# ---------------------------------------------------------------------------

DX_MAX_KB = 24        # K-blocks feeding one column group of the dX kernel
DW_COLS = 32          # output columns of a dW window (the kernel's wgmma N)
DW_MAX_KB = 6         # x tiles (K-blocks) a dW unit lands
DW_MAX_WIN = 2        # dy windows a dW unit lands
DW_ACC = 9 * 64 * DW_COLS    # fp32 sums of one consumer warpgroup
DW_ROW = 44           # ints of a unit's host row (csrc/subm_conv_dw.cuh)
# tiles a split of the dW kernel sums: a rule of the shapes alone (not of
# the card's SM count). 64 timed best summed over every train level on an
# H100 in two runs of tools/k2_backward.py --tps (24 to 96)
DW_TILES_PER_SPLIT = 64


def dx_groups(p: int, C: int, Co: int):
    """The dX kernel's column groups of its conv (the mirrored taps:
    input slots of C lanes, the cotangent's, output slots of Co, dX's),
    each a list of the K-blocks of `kblocks` whose window meets it, as
    (K-block index, lane, pack offset, first column, width) with the
    window cut to the group. At p >= 4 the kernel keeps a group's panels
    in shared memory: C // 16 groups of p*Co // (C // 16) columns (every
    output column is fed by 3C/16 K-blocks, so each group's panels take
    110,592 bytes when p*Co = 128); at p <= 2 one group of all columns,
    whose panels it streams."""
    ng = C // KB if p >= 4 else 1
    width = p * Co // ng
    groups = []
    for gc in range(ng):
        lo, hi = gc * width, (gc + 1) * width
        rows = []
        for i, (lane, dg, col0, w) in enumerate(kblocks(p, C, Co)):
            a, b = max(lo, col0), min(hi, col0 + w)
            if a < b:
                rows.append((i, lane, dg, a, b - a))
        groups.append(rows)
    return groups


@functools.lru_cache(maxsize=None)
def _dx_index(p: int, C: int, Co: int) -> np.ndarray:
    """Flat indices into the extended weight of the dX kernel's packed
    panels: each group's K-blocks cut to the group, in group order."""
    return _panels_of([(i, a, w) for rows in dx_groups(p, C, Co)
                       for i, _, _, a, w in rows], p, C, Co)


@functools.lru_cache(maxsize=16)
def _dx_table(p: int, C: int, Co: int):
    """dx_groups() as the kernel's host tables: int32 rows [groups,
    DX_MAX_KB, 4] of (lane, pack offset, first column in the group,
    width), the K-blocks a group [groups] and the groups' panel byte
    offsets [groups + 1]."""
    groups = dx_groups(p, C, Co)
    width = p * Co // len(groups)
    table = np.zeros((len(groups), DX_MAX_KB, 4), np.int32)
    base = [0]
    for gc, rows in enumerate(groups):
        for k, (_, lane, dg, a, w) in enumerate(rows):
            table[gc, k] = (lane, dg, a - gc * width, w)
        base.append(base[-1] + sum(9 * KB * w * 2 for *_, w in rows))
    return (np.ascontiguousarray(table),
            np.asarray([len(r) for r in groups], np.int32),
            np.asarray(base, np.int32))


@functools.lru_cache(maxsize=None)
def _dx_taps_on(p: int, C: int, Co: int, device: str) -> torch.Tensor:
    """For each element of the dX panels, its index in the forward's taps
    [27, C, Co] (flattened): the panels hold no structural zero, so each
    is one tap weight, and one gather packs them."""
    taps = torch.arange(1, 27 * C * Co + 1, dtype=torch.float64).reshape(
        27, C, Co)
    idx = subm_ext_weight(flip_taps(taps), p).reshape(-1)[
        torch.from_numpy(_dx_index(p, Co, C))].long() - 1
    if bool((idx < 0).any()):
        raise AssertionError("a dX panel element is a structural zero")
    return idx.to(device)


def dx_weight_panels(w27: torch.Tensor, p: int) -> torch.Tensor:
    """[27, C, Co] (the forward's taps) -> the dX kernel's packed bf16
    panels of the mirrored taps (1-d), group by group."""
    _, C, Co = w27.shape
    return w27.to(torch.bfloat16).reshape(-1)[
        _dx_taps_on(p, C, Co, str(w27.device))]


def dw_windows(p: int, C: int, Co: int):
    """For each 32-column window of the p*Co output columns, the K-blocks
    of `kblocks` (by index) whose column window meets it."""
    return [[i for i, (_, _, c0, w) in enumerate(kblocks(p, C, Co))
             if c0 < j + DW_COLS and j < c0 + w]
            for j in range(0, p * Co, DW_COLS)]


def dw_units(p: int, C: int, Co: int):
    """The dW kernel's units, a block each: (x tiles, windows, warpgroups)
    with the x tiles K-block indices of `kblocks` (at most DW_MAX_KB), the
    windows first output columns (at most 2), and each of the two consumer
    warpgroups a (window index, x tile of each of its 4 warps or -1). A
    warpgroup multiplies its K-blocks' 64 lanes by its window's 32 columns;
    every nonzero (K-block, window) pair is in exactly one warpgroup. Two
    windows with the same K-blocks (p <= 2) share each run of 4 K-blocks;
    two whose K-blocks are 4 or fewer each and 6 or fewer together (p = 8)
    share one unit; else (p = 4) a window's K-blocks go 6 at a time, 4 to
    the first warpgroup and the rest to the second."""
    wins = dw_windows(p, C, Co)

    def slots(kbs, run):
        return [kbs.index(i) for i in run] + [-1] * (4 - len(run))
    units, j = [], 0
    while j < len(wins):
        a = wins[j]
        b = wins[j + 1] if j + 1 < len(wins) else None
        cols = [j * DW_COLS, (j + 1) * DW_COLS]
        if a == b:
            for r in range(0, len(a), 4):
                run = a[r:r + 4]
                units.append((run, cols, [(0, slots(run, run)),
                                          (1, slots(run, run))]))
            j += 2
        elif (b is not None and len(a) <= 4 and len(b) <= 4
              and len(set(a) | set(b)) <= DW_MAX_KB):
            kbs = sorted(set(a) | set(b))
            units.append((kbs, cols, [(0, slots(kbs, a)), (1, slots(kbs, b))]))
            j += 2
        else:
            for r in range(0, len(a), DW_MAX_KB):
                run = a[r:r + DW_MAX_KB]
                units.append((run, cols[:1], [(0, slots(run, run[:4])),
                                              (0, slots(run, run[4:]))]))
            j += 1
    return units


@functools.lru_cache(maxsize=16)
def _dw_table(p: int, C: int, Co: int) -> np.ndarray:
    """dw_units() as the kernel's host table: int32 rows of DW_ROW in
    csrc/subm_conv_dw.cuh's DwUnit layout (x tiles, windows, each window's
    first column, each warpgroup's window and x tile a warp, then each x
    tile's extended K-block, x lane, pack offset and nonzero columns)."""
    blocks = kblocks(p, C, Co)
    units = dw_units(p, C, Co)
    table = np.zeros((len(units), DW_ROW), np.int32)
    for u, (kbs, cols, wgs) in enumerate(units):
        row = [len(kbs), len(cols), *cols, *[0] * (DW_MAX_WIN - len(cols)),
               *[w for w, _ in wgs], *[x for _, xs in wgs for x in xs]]
        fields = [(i, *blocks[i][:3], blocks[i][2] + blocks[i][3])
                  for i in kbs]
        for f in zip(*fields):
            row += [*f, *[0] * (DW_MAX_KB - len(kbs))]
        table[u] = row
    return np.ascontiguousarray(table)


def dw_tiles(G: int, X: int, Y: int) -> int:
    """The 16 x 16 site tiles of G pack rows of an X x Y grid."""
    return G * -(-X // 16) * -(-Y // 16)


def dw_splits(T: int, per: int = DW_TILES_PER_SPLIT) -> int:
    """How many ranges the dW kernel cuts T tiles into, at most `per`
    tiles each (split s takes tiles T*s // S .. T*(s+1) // S - 1 and sums
    them in order): a rule of the shapes alone, so the sums' order, and
    the result, are the same on every card and every run."""
    return max(1, -(-T // per))


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
# x, panels, out, mode, mcell, mean, inv, bias, identity, K-block table,
# dtype, G, bz, X, Y, pC, C, Co, K-blocks, stream
ARGTYPES = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _I, _I, _I, _P]


# one library per activation dtype (csrc/subm_conv.cuh, instantiated by
# subm_conv.cu and subm_conv_f32.cu, which nvcc builds in parallel)
_LIBRARY = {torch.float32: "subm_conv_f32", torch.bfloat16: "subm_conv"}


@functools.lru_cache(maxsize=2)
def _launcher(dtype: torch.dtype):
    fn = load_kernel_library(_LIBRARY[dtype]).subm_ext_conv
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def subm_ext_conv(x_pb: torch.Tensor, w27: torch.Tensor, p: int,
                  mcell: torch.Tensor, bn: Optional[BNAffine] = None,
                  identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_pb [B, bz, X, Y, p*C] fp32 or bf16; w27 [27, C, Co] tap weights;
    mcell [B, bz, X, Y, p] bool, the output's cell mask; bn and identity
    select the epilogue (see the module note). Returns [B, bz, X, Y, p*Co]
    in x_pb's dtype.

    A CPU tensor takes `subm_ext_conv_plain`; a CUDA tensor launches the
    kernel (and counts the launch in `subm_ext_conv.launches`)."""
    if x_pb.device.type == "cpu":
        return subm_ext_conv_plain(x_pb, w27, p, mcell, bn, identity)
    out = _launch(x_pb, w27, p, mcell, bn, identity)
    subm_ext_conv.launches += 1
    return out


subm_ext_conv.launches = 0


def subm_ext_conv_dx_plain(dy_pb: torch.Tensor, w27: torch.Tensor,
                           p: int) -> torch.Tensor:
    """Plain PyTorch version of `subm_ext_conv_dx` (any device): the conv
    of `subm_ext_conv_plain` with the mirrored taps and no mask, rounded
    once to dy_pb's dtype."""
    return ext_conv_plain(dy_pb.float(), subm_ext_weight(flip_taps(w27), p),
                          dy_pb.shape[1], dy_pb.shape[-1] // p).to(
                              dy_pb.dtype)


def subm_ext_conv_dx(dy_pb: torch.Tensor, w27: torch.Tensor,
                     p: int) -> torch.Tensor:
    """dX of the SubM conv with tap weights w27 [27, C, Co], given the
    masked cotangent dy_pb [B, bz, X, Y, p*Co]: the conv with the mirrored
    taps and no mask, [B, bz, X, Y, p*C] in dy_pb's dtype. A CPU tensor
    takes `subm_ext_conv_dx_plain`; a CUDA tensor launches the dX kernel
    (counted in `subm_ext_conv_dx.launches`) or raises."""
    if dy_pb.device.type == "cpu":
        return subm_ext_conv_dx_plain(dy_pb, w27, p)
    out = _launch_dx(dy_pb, w27, p)
    subm_ext_conv_dx.launches += 1
    return out


subm_ext_conv_dx.launches = 0


def subm_ext_weight_grad(x_pb: torch.Tensor, dy_pb: torch.Tensor, p: int,
                         tiles_per_split: int = DW_TILES_PER_SPLIT
                         ) -> torch.Tensor:
    """dW [27, C, Co] fp32 of the SubM conv of x_pb [B, bz, X, Y, p*C]
    given the masked cotangent dy_pb [B, bz, X, Y, p*Co] (see the module
    note). A CPU tensor takes `subm_ext_weight_grad_plain`; a CUDA tensor
    launches the dW kernel and its reduce (counted in
    `subm_ext_weight_grad.launches`) over the splits of `dw_splits(...,
    tiles_per_split)` or raises; both fold the extended gradient onto the
    taps with `gather_taps_transpose`."""
    if x_pb.device.type == "cpu":
        return subm_ext_weight_grad_plain(x_pb, dy_pb, p)
    C, Co = x_pb.shape[-1] // p, dy_pb.shape[-1] // p
    g = _launch_dw(x_pb, dy_pb, p, tiles_per_split)
    subm_ext_weight_grad.launches += 1
    return gather_taps_transpose(g, subm_ext_table(p), C, Co)


subm_ext_weight_grad.launches = 0


def subm_ext_weight_grad_plain(x_pb: torch.Tensor, dy_pb: torch.Tensor,
                               p: int) -> torch.Tensor:
    """Plain PyTorch version of `subm_ext_weight_grad` (any device):
    `ext_weight_grad_plain` folded onto the taps."""
    C, Co = x_pb.shape[-1] // p, dy_pb.shape[-1] // p
    return gather_taps_transpose(ext_weight_grad_plain(x_pb, dy_pb, p),
                                 subm_ext_table(p), C, Co)


def ext_weight_grad_plain(x_pb: torch.Tensor, dy_pb: torch.Tensor,
                          p: int) -> torch.Tensor:
    """The extended weight's gradient [3, 3, (p+2)C, p*Co] in the
    activations' dtype, summed in fp32 and rounded once (on the CPU a bf16
    one is the fp32 sum of the bf16 values, as ops/conv.py computes; on the
    card cuDNN's bf16 weight gradient)."""
    B, bz, X, Y, pC = x_pb.shape
    C, Co = pC // p, dy_pb.shape[-1] // p
    dt = x_pb.dtype
    ext = shift_ext(x_pb.to(torch.bfloat16), C).to(dt).reshape(
        B * bz, X, Y, pC + 2 * C).permute(0, 3, 1, 2)
    dy = dy_pb.to(dt).reshape(B * bz, X, Y, p * Co).permute(0, 3, 1, 2)
    if dt != torch.float32 and x_pb.device.type == "cpu":
        ext, dy = ext.float(), dy.float()
    g = torch.nn.grad.conv2d_weight(ext, (p * Co, pC + 2 * C, 3, 3), dy,
                                    padding=1).to(dt)
    return g.permute(2, 3, 1, 0)


class _SubMConv(torch.autograd.Function):
    """The mask-only K2 conv with the gradient of the module note."""

    @staticmethod
    def forward(ctx, x_pb, w27, p, mcell):
        ctx.p = p
        ctx.save_for_backward(x_pb, w27, mcell)
        return subm_ext_conv(x_pb, w27, p, mcell)

    @staticmethod
    def backward(ctx, dy):
        x_pb, w27, mcell = ctx.saved_tensors
        # the cotangent in the operands' dtype (JAX ops/conv_acc.py:47-54),
        # times the output mask the forward applied
        dy = masked(dy.to(x_pb.dtype), mcell).contiguous()
        dx = subm_ext_conv_dx(dy, w27, ctx.p) \
            if ctx.needs_input_grad[0] else None
        dw = subm_ext_weight_grad(x_pb, dy, ctx.p).to(w27.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def subm_conv(x_pb: torch.Tensor, w27: torch.Tensor, p: int,
              mcell: torch.Tensor) -> torch.Tensor:
    """`subm_ext_conv` with its mask-only epilogue, differentiable in x_pb
    and w27 (the training encoder's SubM conv)."""
    return _SubMConv.apply(x_pb, w27, p, mcell)


def _cuda_5d(name: str, *ts: torch.Tensor):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.dtype not in _DTYPE_CODE or t.dim() != 5:
            raise ValueError(f"{name}: inputs must be 5-d fp32 or bf16 "
                             f"tensors, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             "16-byte aligned")


@functools.lru_cache(maxsize=2)
def _dx_launcher(dtype: torch.dtype):
    lib = {torch.float32: "subm_conv_dx_f32",
           torch.bfloat16: "subm_conv_dx"}[dtype]
    fn = load_kernel_library(lib).subm_ext_conv_dx
    # dy, panels, out, table, nkb, base, groups, p, G, bz, X, Y, stream
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _launch_dx(dy_pb: torch.Tensor, w27: torch.Tensor,
               p: int) -> torch.Tensor:
    """Check the inputs and launch the dX kernel on the card (or raise)."""
    _cuda_5d("subm_ext_conv_dx", dy_pb)
    B, bz, X, Y, L = dy_pb.shape
    _, C, Co = w27.shape
    if w27.shape != (27, C, Co) or w27.device != dy_pb.device:
        raise ValueError("subm_ext_conv_dx: w27 must be [27, C, Co] on "
                         "dy_pb's device")
    if not (p * C == p * Co == L == N_LANES and C % KB == 0):
        raise ValueError(f"subm_ext_conv_dx: the kernel needs p*C = p*Co = "
                         f"{N_LANES} lanes, C a multiple of {KB}; got "
                         f"dy_pb {tuple(dy_pb.shape)}, w27 "
                         f"{tuple(w27.shape)}, p={p}")
    # the mirrored conv reads the cotangent's slots (Co) and writes dX's (C)
    table, nkb, base = _dx_table(p, Co, C)
    panels = dx_weight_panels(w27, p)
    out = torch.empty((B, bz, X, Y, p * C), dtype=dy_pb.dtype,
                      device=dy_pb.device)
    if out.numel() == 0:
        return out
    # the kernel reads bf16: fp32 dy is rounded once, as K2 reads it
    dyb = dy_pb.to(torch.bfloat16)
    err = _dx_launcher(dy_pb.dtype)(
        dyb.data_ptr(), panels.data_ptr(), out.data_ptr(),
        table.ctypes.data, nkb.ctypes.data, base.ctypes.data, len(nkb), p,
        B * bz, bz, X, Y, torch.cuda.current_stream(dy_pb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"subm_ext_conv_dx kernel launch failed: CUDA "
                           f"error {err}")
    return out


@functools.lru_cache(maxsize=1)
def _dw_launcher():
    fn = load_kernel_library("subm_weight_grad").subm_ext_weight_grad
    # x, dy0, dy1, dy2, parts, table, units, S, partials, gw, out dtype,
    # G, bz, X, Y, pC, E, stream
    fn.argtypes = [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I,
                   _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def dy_parts(dy_pb: torch.Tensor):
    """The bf16 tensors the dW kernel sums the products of: dy itself in
    bf16; in fp32 its three-way split hi + mid + lo (each the bf16 rounding
    of what the ones before leave), whose sum is dy exactly, so that each
    product with a bf16 x is exact in fp32."""
    if dy_pb.dtype == torch.bfloat16:
        return [dy_pb]
    parts, rest = [], dy_pb
    for _ in range(3):
        parts.append(rest.to(torch.bfloat16))
        rest = rest - parts[-1].float()
    return parts


def _launch_dw(x_pb: torch.Tensor, dy_pb: torch.Tensor, p: int,
               tiles_per_split: int) -> torch.Tensor:
    """Check the inputs and launch the dW kernel and its reduce on the
    card (or raise). -> the extended weight's gradient [3, 3, (p+2)C,
    p*Co], each element rounded to the activations' dtype and held in fp32
    (the fold sums in fp32), zero outside the nonzero blocks."""
    _cuda_5d("subm_ext_weight_grad", x_pb, dy_pb)
    B, bz, X, Y, pC = x_pb.shape
    L = dy_pb.shape[-1]
    if (dy_pb.shape[:-1] != x_pb.shape[:-1] or dy_pb.dtype != x_pb.dtype
            or dy_pb.device != x_pb.device):
        raise ValueError("subm_ext_weight_grad: x_pb and dy_pb must share "
                         "their device, dtype and leading shape")
    C, Co = pC // p, L // p
    if pC % p or L != N_LANES or p * Co != L or C % KB:
        raise ValueError(f"subm_ext_weight_grad: the kernel needs p*Co = "
                         f"{N_LANES}, C a multiple of {KB}; got x_pb "
                         f"{tuple(x_pb.shape)}, dy_pb {tuple(dy_pb.shape)}, "
                         f"p={p}")
    E = (p + 2) * C
    table = _dw_table(p, C, Co)
    G = B * bz
    S = dw_splits(dw_tiles(G, X, Y), tiles_per_split)
    gw = torch.zeros((3, 3, E, L), dtype=torch.float32, device=x_pb.device)
    if x_pb.numel() == 0:
        return gw
    xb = x_pb.to(torch.bfloat16)
    parts = dy_parts(dy_pb)
    partials = torch.empty(len(parts) * S * len(table) * 2 * DW_ACC,
                           dtype=torch.float32, device=x_pb.device)
    ptrs = [t.data_ptr() for t in parts] + [0] * (3 - len(parts))
    err = _dw_launcher()(
        xb.data_ptr(), *ptrs, len(parts), table.ctypes.data, len(table), S,
        partials.data_ptr(), gw.data_ptr(), _DTYPE_CODE[x_pb.dtype], G, bz,
        X, Y, pC, E, torch.cuda.current_stream(x_pb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"subm_ext_weight_grad kernel launch failed: CUDA "
                           f"error {err}")
    return gw


def _launch(x_pb: torch.Tensor, w27: torch.Tensor, p: int,
            mcell: torch.Tensor, bn: Optional[BNAffine],
            identity: Optional[torch.Tensor]) -> torch.Tensor:
    """Check the inputs and launch K2 on the card (or raise)."""
    if x_pb.device.type != "cuda":
        raise ValueError(f"subm_ext_conv: unsupported device {x_pb.device}")
    if x_pb.dtype not in _DTYPE_CODE or x_pb.dim() != 5:
        raise ValueError("subm_ext_conv: x_pb must be a 5-d fp32 or bf16 "
                         f"tensor, got {x_pb.dtype} {tuple(x_pb.shape)}")
    B, bz, X, Y, pC = x_pb.shape
    _, C, Co = w27.shape
    if pC % p or w27.shape != (27, pC // p, Co):
        raise ValueError(f"subm_ext_conv: x_pb {tuple(x_pb.shape)} with p "
                         f"{p} needs w27 [27, {pC // p}, Co], got "
                         f"{tuple(w27.shape)}")
    if C % KB or Co not in SLOT_WIDTHS or p * Co != N_LANES:
        raise ValueError(f"subm_ext_conv: the kernel needs C a multiple of "
                         f"{KB}, Co one of {SLOT_WIDTHS} and p*Co = "
                         f"{N_LANES}; got C={C}, Co={Co}, p={p}")
    if not x_pb.is_contiguous() or x_pb.data_ptr() % 16:
        raise ValueError("subm_ext_conv: x_pb must be contiguous and 16-byte "
                         "aligned (the kernel reads it densely; it copies "
                         "nothing)")
    out_shape = (B, bz, X, Y, N_LANES)
    if (mcell.shape != (B, bz, X, Y, p) or mcell.dtype != torch.bool
            or not mcell.is_contiguous()):
        raise ValueError(f"subm_ext_conv: mcell must be a contiguous bool "
                         f"{(B, bz, X, Y, p)} tensor, got {mcell.dtype} "
                         f"{tuple(mcell.shape)}")
    if identity is not None and (
            bn is None or identity.shape != out_shape
            or identity.dtype != x_pb.dtype or not identity.is_contiguous()):
        raise ValueError("subm_ext_conv: identity needs bn and must be a "
                         f"contiguous {x_pb.dtype} {out_shape} tensor")
    vecs = ([] if bn is None else
            [v.to(torch.float32).contiguous() for v in bn])
    if any(v.shape != (Co,) for v in vecs):
        raise ValueError(f"subm_ext_conv: bn vectors must be [{Co}]")
    tensors = [w27, mcell, *vecs] + ([] if identity is None else [identity])
    if any(t.device != x_pb.device for t in tensors):
        raise ValueError("subm_ext_conv: all inputs must be on x_pb's device")
    mode = 0 if bn is None else 1 if identity is None else 2
    mean, inv, bias = vecs or (None, None, None)
    table = _ktable(p, C, Co)
    panels = weight_panels(w27, p)
    out = torch.empty(out_shape, dtype=x_pb.dtype, device=x_pb.device)
    if out.numel() == 0:
        return out
    err = _launcher(x_pb.dtype)(
        x_pb.data_ptr(), panels.data_ptr(), out.data_ptr(), mode,
        mcell.data_ptr(), _ptr(mean), _ptr(inv), _ptr(bias), _ptr(identity),
        table.ctypes.data, _DTYPE_CODE[x_pb.dtype], B * bz, bz, X, Y, pC, C,
        Co, len(table), torch.cuda.current_stream(x_pb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"subm_ext_conv kernel launch failed: CUDA error "
                           f"{err}")
    return out
