"""LSS lift-splat as a sorted segment-sum into the voxel grid.

Counterpart of coocc_tpu/ops/lift_splat.py:

    out[b, v, :] = sum_{p: voxel(p) = v} depth_prob[p] * img_feat[pixel(p), :]

As in the JAX version, the points are sorted by voxel id (stably, so each
voxel keeps its points in their order) and summed by segment: every voxel
sums its points in the same order on every run and on every device, and
the CPU's sums equal `index_add_`'s bit for bit. A scatter-add on the card
would not repeat: `index_add_`'s atomics sum in an order that changes from
run to run, a few voxels then round to another bf16 value, and every layer
after the splat, the eval's argmax included, changes with them (on an H100
80GB HBM3, 22-24 of the flagship's 10,240,000 img_voxel elements and
0.63-0.67M of semantic1's 2.56M moved between two runs). There the sorted
splat takes 1.06 ms against 2.35 ms for `index_add_`, whose every point
is gathered, the sink's too; `index_put_(accumulate=True)` repeats, but
walks each voxel's run of points in one warp: 161.5 ms
(`python -m coocc_tpu_torch.tools.splat_repeat`).
"""
from __future__ import annotations

import torch

from ..geometry.frustum import voxel_indices
from .gather import gather_rows
from .voxelize import linearize


def lift_splat(depth_prob: torch.Tensor, img_feat: torch.Tensor,
               geom: torch.Tensor, dx, bx, nx) -> torch.Tensor:
    """depth_prob [B, N, D, fH, fW]; img_feat [B, N, fH, fW, C] in any
    dtype; geom [B, N, D, fH, fW, 3]; dx/bx/nx the grid (gen_dx_bx).
    Returns [B, X, Y, Z, C] in depth_prob's dtype: the features are
    gathered in their own dtype and upcast after the gather, as the JAX
    version does (the same values, half the gathered bytes in bf16)."""
    B, N, D, fH, fW = depth_prob.shape
    C = img_feat.shape[-1]
    nx = [int(v) for v in nx]
    n_vox = nx[0] * nx[1] * nx[2]
    idx, valid = voxel_indices(geom, dx, bx, nx)
    vox_id = linearize(idx, nx).reshape(B, -1)
    valid = valid.reshape(B, -1)
    # pixel of each frustum point in the [N*fH*fW, C] feature table
    pix = torch.arange(N * fH * fW, device=geom.device).reshape(N, 1, fH, fW)
    pix = pix.expand(N, D, fH, fW).reshape(-1)
    first = torch.arange(n_vox + 1, device=geom.device)
    outs = []
    for b in range(B):
        keep = valid[b].nonzero()[:, 0]
        order = keep[torch.argsort(vox_id[b, keep], stable=True)]
        # the sorted points of voxel v are rows ends[v]:ends[v + 1]
        ends = torch.searchsorted(vox_id[b, order].long(), first)
        contrib = gather_rows(img_feat[b].reshape(N * fH * fW, C),
                              pix[order]).to(depth_prob.dtype) \
            * depth_prob[b].reshape(-1)[order, None]
        # the lengths sum to the rows by construction: unsafe skips the
        # check, which would wait for the card
        out = torch.segment_reduce(contrib, "sum", lengths=ends.diff(),
                                   unsafe=True)
        outs.append(out.reshape(nx[0], nx[1], nx[2], C))
    return torch.stack(outs)
