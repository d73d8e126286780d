"""Camera frustum geometry: frustum creation and camera->ego unprojection.

Counterpart of coocc_tpu/geometry/frustum.py (the LSS geometry of
ViewTransformerLSSBEVDepth.py:104-150 and get_mlp_input :636-691), for the
3x3-intrinsics / 3x3-BDA layout of the nuScenes configs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def gen_dx_bx(xbound, ybound, zbound):
    """Voxel size dx, first-voxel-center bx, grid-size nx (numpy)."""
    bounds = (xbound, ybound, zbound)
    dx = np.array([row[2] for row in bounds], np.float32)
    bx = np.array([row[0] + row[2] / 2.0 for row in bounds], np.float32)
    nx = np.array([int(round((row[1] - row[0]) / row[2])) for row in bounds],
                  np.int32)
    return dx, bx, nx


def create_frustum(input_size: Tuple[int, int], downsample: int,
                   dbound: Tuple[float, float, float]) -> np.ndarray:
    """[D, fH, fW, 3] grid of (pixel_x, pixel_y, depth) sample points."""
    ogfH, ogfW = input_size
    fH, fW = ogfH // downsample, ogfW // downsample
    ds = np.arange(dbound[0], dbound[1], dbound[2], dtype=np.float32)
    D = ds.shape[0]
    xs = np.linspace(0, ogfW - 1, fW, dtype=np.float32)
    ys = np.linspace(0, ogfH - 1, fH, dtype=np.float32)
    return np.stack([
        np.broadcast_to(xs[None, None, :], (D, fH, fW)),
        np.broadcast_to(ys[None, :, None], (D, fH, fW)),
        np.broadcast_to(ds[:, None, None], (D, fH, fW)),
    ], axis=-1)


def get_geometry(frustum, rots, trans, intrins, post_rots, post_trans, bda):
    """Unproject frustum pixels to ego-frame points.

    frustum [D, fH, fW, 3]; rots/intrins/post_rots [B, N, 3, 3];
    trans/post_trans [B, N, 3]; bda [B, 3, 3]. Returns [B, N, D, fH, fW, 3].
    """
    pts = frustum[None, None] - post_trans[:, :, None, None, None, :]
    pts = torch.einsum("bnij,bndhwj->bndhwi", torch.linalg.inv(post_rots),
                       pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = rots @ torch.linalg.inv(intrins)
    pts = torch.einsum("bnij,bndhwj->bndhwi", combine, pts)
    pts = pts + trans[:, :, None, None, None, :]
    return torch.einsum("bij,bndhwj->bndhwi", bda, pts)


def get_mlp_input(rots, trans, intrins, post_rots, post_trans, bda):
    """27-d camera conditioning vector per camera -> [B, N, 27]."""
    B, N = rots.shape[:2]
    bda_n = bda[:, None].expand(B, N, 3, 3)
    mlp_input = torch.stack([
        intrins[:, :, 0, 0], intrins[:, :, 1, 1],
        intrins[:, :, 0, 2], intrins[:, :, 1, 2],
        post_rots[:, :, 0, 0], post_rots[:, :, 0, 1], post_trans[:, :, 0],
        post_rots[:, :, 1, 0], post_rots[:, :, 1, 1], post_trans[:, :, 1],
        bda_n[:, :, 0, 0], bda_n[:, :, 0, 1],
        bda_n[:, :, 1, 0], bda_n[:, :, 1, 1], bda_n[:, :, 2, 2],
    ], dim=-1)
    sensor2ego = torch.cat([rots, trans.reshape(B, N, 3, 1)],
                           dim=-1).reshape(B, N, -1)
    return torch.cat([mlp_input, sensor2ego], dim=-1)


def voxel_indices(geom, dx, bx, nx):
    """Ego points -> (int32 voxel index [..., 3], in-grid mask [...]).

    `.long()`-style truncation toward zero, as the reference
    (ViewTransformerLSSVoxel.py:106-118); negatives that truncate to 0 are
    the reference's behaviour too.
    """
    dx = torch.as_tensor(dx, dtype=geom.dtype, device=geom.device)
    bx = torch.as_tensor(bx, dtype=geom.dtype, device=geom.device)
    idx = ((geom - (bx - dx / 2.0)) / dx).to(torch.int32)
    nx = torch.as_tensor(nx, dtype=torch.int32, device=geom.device)
    valid = ((idx >= 0) & (idx < nx)).all(dim=-1)
    return idx, valid
