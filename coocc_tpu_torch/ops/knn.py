"""Exact brute-force 2-nearest-neighbour search (kernel K3).

Counterpart of coocc_tpu/ops/pallas/knn.py `knn2`: for each of Q query
points, the indices of the two nearest of K key points under L2, over the
keys whose mask is set, with a distance threshold. Squared distances use
the expansion d2 = (|q|^2 + |k|^2) - 2 q.k in fp32 (not |q - k|^2), masked
keys count as 1e30, and keys are taken in tiles of KT = 512, each tile's
best two merged with the carried best two by the TPU kernel's
four-candidate rule, so thresholds and ties resolve as they do there.

`knn2` launches the hand-written CUDA kernel `csrc/knn.cu` for CUDA tensors
and takes `knn2_plain` for CPU tensors; there is no other route. The kernel
replaces the Pallas kernel `_knn2_kernel` (coocc_tpu/ops/pallas/knn.py:29,
called from `knn2` :99). No model path calls it, in the JAX package or
here: `knn2` is its entry point. At 8 fp32 operations per (query, key) pair
and 12 bytes per point, operations bound it. The kernel stays on the CUDA
cores (a TF32 or bf16 cross term would miss the 1e-4 distance tolerance):
8 lanes split each staged key tile of a query and reduce their best twos
by (d2, index), each thread holds 4 queries so a key read serves 4 pairs,
and the merge across tiles runs per query in tile order, so the TPU
kernel's tie rule holds. Its products and sums are rounded one by one, as
here, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import load_kernel_library

KT = 512        # key tile, as the TPU kernel's
BIG = 1e30
Q_CHUNK = 4096  # queries per step of the plain version (bounds its memory)


def _sq3(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 of [n, 3] points, summed in the kernel's order."""
    return (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]


def _threshold2(dist_thresh: float) -> float:
    """thresh^2 as fp32, as the TPU kernel compares it."""
    return float(np.float32(dist_thresh * dist_thresh))


def knn2_plain(queries, keys, query_mask, key_mask, dist_thresh=13.3):
    """Plain PyTorch version of `knn2` (any device): the TPU kernel's
    tile-and-merge order, over chunks of Q_CHUNK queries."""
    q = queries.float()
    k = keys.float()
    Q, K = q.shape[0], k.shape[0]
    kk = _sq3(k)
    idx = torch.empty((Q, 2), dtype=torch.int32, device=q.device)
    dist = torch.empty((Q, 2), dtype=torch.float32, device=q.device)
    thresh2 = _threshold2(dist_thresh)
    for s in range(0, Q, Q_CHUNK):
        qc = q[s:s + Q_CHUNK]
        n = qc.shape[0]
        qq = _sq3(qc)
        bd = torch.full((n, 2), BIG, dtype=torch.float32, device=q.device)
        bi = torch.full((n, 2), -1, dtype=torch.long, device=q.device)
        for base in range(0, K, KT):
            kt = k[base:base + KT]
            cross = (qc[:, 0:1] * kt[:, 0] + qc[:, 1:2] * kt[:, 1]) \
                + qc[:, 2:3] * kt[:, 2]
            d2 = (qq[:, None] + kk[None, base:base + KT]) - 2.0 * cross
            d2 = torch.where(key_mask[None, base:base + KT], d2, BIG)
            if d2.shape[1] < KT:  # the TPU kernel's padded, masked keys
                d2 = torch.nn.functional.pad(d2, (0, KT - d2.shape[1]),
                                             value=BIG)
            # argmin takes the first of equal minima, like jnp.argmin
            a1 = d2.argmin(dim=1)
            m1 = d2.gather(1, a1[:, None])[:, 0]
            d2b = d2.scatter(1, a1[:, None], BIG)
            a2 = d2b.argmin(dim=1)
            m2 = d2b.gather(1, a2[:, None])[:, 0]
            i1, i2 = base + a1, base + a2
            bd1, bd2, bi1, bi2 = bd[:, 0], bd[:, 1], bi[:, 0], bi[:, 1]
            take_new1 = m1 < bd1
            nd1 = torch.where(take_new1, m1, bd1)
            ni1 = torch.where(take_new1, i1, bi1)
            other1 = torch.where(take_new1, bd1, m1)
            oidx1 = torch.where(take_new1, bi1, i1)
            cand2d = torch.minimum(m2, bd2)
            cand2i = torch.where(m2 < bd2, i2, bi2)
            use_other1 = other1 < cand2d
            nd2 = torch.where(use_other1, other1, cand2d)
            ni2 = torch.where(use_other1, oidx1, cand2i)
            bd = torch.stack([nd1, nd2], dim=1)
            bi = torch.stack([ni1, ni2], dim=1)
        valid = (bd < thresh2) & query_mask[s:s + n, None]
        idx[s:s + n] = torch.where(valid, bi, -1).to(torch.int32)
        dist[s:s + n] = torch.sqrt(torch.clamp(bd, min=0.0))
    return idx, dist


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = load_kernel_library("knn").knn2
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def knn2(queries, keys, query_mask, key_mask, dist_thresh=13.3):
    """queries [Q, 3], keys [K, 3] float; query_mask [Q], key_mask [K] bool.
    Returns (idx [Q, 2] int32, -1 where invalid; dist [Q, 2] fp32).

    CPU tensors take `knn2_plain`; CUDA tensors launch the kernel (and
    count the launch in `knn2.launches`)."""
    if queries.device.type == "cpu":
        return knn2_plain(queries, keys, query_mask, key_mask, dist_thresh)
    if queries.device.type != "cuda":
        raise ValueError(f"knn2: unsupported device {queries.device}")
    tensors = (queries, keys, query_mask, key_mask)
    if any(t.device != queries.device for t in tensors):
        raise ValueError("knn2: inputs on different devices")
    if queries.dim() != 2 or queries.shape[1] != 3 or keys.dim() != 2 \
            or keys.shape[1] != 3:
        raise ValueError(f"knn2: queries and keys must be [n, 3], got "
                         f"{tuple(queries.shape)}, {tuple(keys.shape)}")
    Q, K = queries.shape[0], keys.shape[0]
    if query_mask.shape != (Q,) or key_mask.shape != (K,) \
            or query_mask.dtype != torch.bool or key_mask.dtype != torch.bool:
        raise ValueError("knn2: masks must be bool [Q] and [K]")
    q = queries.float().contiguous()
    k = keys.float().contiguous()
    qm = query_mask.contiguous()
    km = key_mask.contiguous()
    idx = torch.empty((Q, 2), dtype=torch.int32, device=q.device)
    dist = torch.empty((Q, 2), dtype=torch.float32, device=q.device)
    err = _launcher()(q.data_ptr(), k.data_ptr(), qm.data_ptr(),
                      km.data_ptr(), Q, K, _threshold2(dist_thresh),
                      idx.data_ptr(), dist.data_ptr(),
                      torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn2 kernel launch failed: CUDA error {err}")
    knn2.launches += 1
    return idx, dist


knn2.launches = 0
