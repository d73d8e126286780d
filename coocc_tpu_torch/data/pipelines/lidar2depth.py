"""LiDAR -> per-view GT depth maps (vectorized z-buffer).

A numpy copy of coocc_tpu/data/pipelines/lidar2depth.py (tests/
test_torch_data_path.py holds it against it bit for bit).
Capability parity with CreateDepthFromLiDAR
(reference: datasets/pipelines/lidar2depth.py:11-88): project the raw sweep
into every view, keep in-bounds positive-depth hits, z-buffer by writing in
DESCENDING depth order so the closest point wins each pixel. The reference's
per-camera python loop + sort becomes one lexsort + last-write-wins scatter.
"""
from __future__ import annotations

import numpy as np


def project_points(points, rots, trans, intrins, post_rots, post_trans):
    """points [P, 3]; per-cam [N, ...] -> uvd [P, N, 3]."""
    p = points[:, None, :] - trans[None, :, :]
    inv_rots = np.linalg.inv(rots)  # [N, 3, 3]
    p = np.einsum("nij,pnj->pni", inv_rots, p)
    if intrins.shape[-1] == 4:
        ones = np.ones((*p.shape[:2], 1), p.dtype)
        p = np.einsum("nij,pnj->pni", intrins,
                      np.concatenate([p, ones], axis=-1))
    else:
        p = np.einsum("nij,pnj->pni", intrins, p)
    d = p[..., 2:3]
    uv = p[..., :2] / d
    uv = np.einsum("nij,pnj->pni", post_rots[:, :2, :2], uv) \
        + post_trans[None, :, :2]
    return np.concatenate([uv, d], axis=-1)


def create_depth_maps(points, rots, trans, intrins, post_rots, post_trans,
                      img_h: int, img_w: int) -> np.ndarray:
    """Returns [N, H, W] float32 depth maps (0 = no return)."""
    uvd = project_points(points[:, :3].astype(np.float64), rots, trans,
                         intrins, post_rots, post_trans)
    N = rots.shape[0]
    u = np.round(uvd[..., 0])
    v = np.round(uvd[..., 1])
    d = uvd[..., 2]
    valid = (uvd[..., 0] >= 0) & (uvd[..., 1] >= 0) \
        & (uvd[..., 0] <= img_w - 1) & (uvd[..., 1] <= img_h - 1) & (d > 0)

    depth = np.zeros((N, img_h, img_w), np.float32)
    for n in range(N):
        m = valid[:, n]
        if not m.any():
            continue
        un = u[m, n].astype(np.int64)
        vn = v[m, n].astype(np.int64)
        dn = d[m, n].astype(np.float32)
        # descending depth order: later (closer) writes win
        order = np.argsort(-dn, kind="stable")
        depth[n, vn[order], un[order]] = dn[order]
    return depth
