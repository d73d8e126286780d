"""Packed SubM 3x3x3 convolution with cross-pack carries (kernel K2).

Counterpart of coocc_tpu/ops/pallas/subm_conv.py `subm_ext_conv`. The
z-packed LiDAR encoder (nn/sparse_enc_packed.py) keeps a level's z axis as
bz packs of p slots, `[B, bz, X, Y, p*C]` with lane `slot*C + c`, and
computes each submanifold 3x3x3 conv as ONE 3x3 conv2d over the extended
lanes `[p*C core | C up-carry | C dn-carry]`: the up-carry is the first slot
of the next pack, the dn-carry the last slot of the previous one, both zero
at a sample's first and last pack. The extended weight `[3, 3, pC+2C, pCo]`
comes from `_subm_ext_weight`.

Numerics are the TPU kernel's: operands rounded to bf16 (round to nearest
even), products summed in fp32, the output in the input's dtype.

`subm_ext_conv` launches the hand-written CUDA kernel `csrc/subm_conv.cu`
for a CUDA tensor and takes `subm_ext_conv_plain` for a CPU tensor; there is
no other route. The kernel replaces the Pallas kernel `_kernel` (called from
`subm_ext_conv`, coocc_tpu/ops/pallas/subm_conv.py:53,107), which padded the
carry slab to 128 lanes and built a thin carry array in HBM to meet Mosaic's
(8, 128) tiling. On the card a block stages the halo of its (x, y) tile of
one pack row in shared memory instead, carries included, rounding to bf16 as
it stages, and runs an implicit GEMM (M = sites, N = pCo, K = 9*(pC+2C)) on
the tensor cores with `mma.sync` m16n8k16. At the flagship the 13 calls of a
forward do 3.37 TFLOP (structural zeros of the weight included) and move
about 7 GB, so the kernel is bound by operations (about 3.4 ms at 989
TFLOP/s bf16).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load_kernel_library

# the kernel's tiling: channels per staged chunk and output lanes per block
KC = 32
BN = 128


def shift_ext(x_pb: torch.Tensor, C: int) -> torch.Tensor:
    """[B, bz, X, Y, pC] -> [B, bz, X, Y, pC + 2C]: append the up-carry (the
    next pack's first C lanes) and the dn-carry (the previous pack's last C
    lanes), zero across a sample's first and last pack."""
    up = F.pad(x_pb[:, 1:, ..., :C], (0, 0, 0, 0, 0, 0, 0, 1))
    dn = F.pad(x_pb[:, :-1, ..., -C:], (0, 0, 0, 0, 0, 0, 1, 0))
    return torch.cat([x_pb, up, dn], dim=-1)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
    """[N, H, W, Ci] x [3, 3, Ci, Co] (HWIO) -> [N, H/s, W/s, Co], pad 1;
    the convolution runs on channels_last views."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def subm_ext_conv_plain(x_pb: torch.Tensor, w_ext: torch.Tensor, bz: int,
                        C: int) -> torch.Tensor:
    """Plain PyTorch version of `subm_ext_conv` (any device): x and w_ext
    rounded to bf16 and back, then an fp32 conv2d of shift_ext(x). The
    product of two bf16 values is exact in fp32, so this is the kernel's
    arithmetic up to the order of the sums."""
    B, bz_, X, Y, pC = x_pb.shape
    if bz_ != bz:
        raise ValueError(f"subm_ext_conv: bz {bz} != x_pb.shape[1] {bz_}")
    xr = x_pb.to(torch.bfloat16).float()
    wr = w_ext.to(torch.bfloat16).float()
    ext = shift_ext(xr, C).reshape(B * bz, X, Y, pC + 2 * C)
    y = conv2d_nhwc(ext, wr)
    return y.reshape(B, bz, X, Y, -1).to(x_pb.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = load_kernel_library("subm_conv").subm_ext_conv
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def subm_ext_conv(x_pb: torch.Tensor, w_ext: torch.Tensor, bz: int,
                  C: int) -> torch.Tensor:
    """x_pb [B, bz, X, Y, pC] fp32 or bf16; w_ext [3, 3, pC+2C, pCo].
    Returns [B, bz, X, Y, pCo] in x_pb's dtype, equal to
    conv2d(shift_ext(x_pb), w_ext) with bf16 operands and fp32 sums.

    A CPU tensor takes `subm_ext_conv_plain`; a CUDA tensor launches the
    kernel (and counts the launch in `subm_ext_conv.launches`)."""
    if x_pb.device.type == "cpu":
        return subm_ext_conv_plain(x_pb, w_ext, bz, C)
    if x_pb.device.type != "cuda":
        raise ValueError(f"subm_ext_conv: unsupported device {x_pb.device}")
    if x_pb.dtype not in _DTYPE_CODE or x_pb.dim() != 5:
        raise ValueError("subm_ext_conv: x_pb must be a 5-d fp32 or bf16 "
                         f"tensor, got {x_pb.dtype} {tuple(x_pb.shape)}")
    B, bz_, X, Y, pC = x_pb.shape
    ext = pC + 2 * C
    pCo = w_ext.shape[-1]
    if bz_ != bz or w_ext.shape != (3, 3, ext, pCo):
        raise ValueError(f"subm_ext_conv: x_pb {tuple(x_pb.shape)} with bz "
                         f"{bz}, C {C} needs w_ext [3, 3, {ext}, pCo], got "
                         f"{tuple(w_ext.shape)}")
    if C % 8 or pC % 8 or ext % KC or pCo % BN:
        raise ValueError(f"subm_ext_conv: the kernel needs C and pC "
                         f"multiples of 8, pC+2C of {KC} and pCo of {BN}; got "
                         f"C={C}, pC={pC}, pCo={pCo}")
    if w_ext.device != x_pb.device:
        raise ValueError("subm_ext_conv: x_pb and w_ext on different devices")
    x_pb = x_pb.contiguous()
    # [9 taps (kx-major), pC+2C, pCo] in bf16: the kernel's B operand
    w = w_ext.to(torch.bfloat16).contiguous()
    if x_pb.data_ptr() % 16:
        raise ValueError("subm_ext_conv: x_pb must be 16-byte aligned")
    out = torch.empty((B, bz, X, Y, pCo), dtype=x_pb.dtype,
                      device=x_pb.device)
    if out.numel() == 0:
        return out
    err = _launcher()(x_pb.data_ptr(), w.data_ptr(), out.data_ptr(),
                      _DTYPE_CODE[x_pb.dtype], B * bz, bz, X, Y, pC, C, pCo,
                      torch.cuda.current_stream(x_pb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"subm_ext_conv kernel launch failed: CUDA error "
                           f"{err}")
    subm_ext_conv.launches += 1
    return out


subm_ext_conv.launches = 0
