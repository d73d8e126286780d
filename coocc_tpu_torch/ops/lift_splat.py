"""LSS lift-splat as one scatter-add into the voxel grid.

Counterpart of coocc_tpu/ops/lift_splat.py:

    out[b, v, :] = sum_{p: voxel(p) = v} depth_prob[p] * img_feat[pixel(p), :]

The JAX version sorts the points by voxel id and takes a segment-sum; here
`index_add_` sums in place. On the card its adds are atomics whose order
changes from run to run, so fp32 sums differ from the sorted order in the
last bits: compare within a tolerance (the model tests use 5e-3), never bit
for bit.
"""
from __future__ import annotations

import torch

from ..geometry.frustum import voxel_indices
from .voxelize import linearize


def lift_splat(depth_prob: torch.Tensor, img_feat: torch.Tensor,
               geom: torch.Tensor, dx, bx, nx) -> torch.Tensor:
    """depth_prob [B, N, D, fH, fW]; img_feat [B, N, fH, fW, C];
    geom [B, N, D, fH, fW, 3]; dx/bx/nx the grid (gen_dx_bx).
    Returns [B, X, Y, Z, C]."""
    B, N, D, fH, fW = depth_prob.shape
    C = img_feat.shape[-1]
    nx = [int(v) for v in nx]
    n_vox = nx[0] * nx[1] * nx[2]
    idx, valid = voxel_indices(geom, dx, bx, nx)
    vox_id = torch.where(valid, linearize(idx, nx), n_vox).reshape(B, -1)
    # pixel of each frustum point in the [N*fH*fW, C] feature table
    pix = torch.arange(N * fH * fW, device=geom.device).reshape(N, 1, fH, fW)
    pix = pix.expand(N, D, fH, fW).reshape(-1)
    outs = []
    for b in range(B):
        contrib = img_feat[b].reshape(N * fH * fW, C)[pix] \
            * depth_prob[b].reshape(-1, 1)
        out = contrib.new_zeros(n_vox + 1, C)
        out.index_add_(0, vox_id[b].long(), contrib)
        outs.append(out[:n_vox].reshape(nx[0], nx[1], nx[2], C))
    return torch.stack(outs)
