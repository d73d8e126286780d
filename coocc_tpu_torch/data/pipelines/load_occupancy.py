"""Occupancy GT loading (SurroundOcc & OpenOccupancy label formats) + BDA.

A numpy copy of coocc_tpu/data/pipelines/load_occupancy.py, function for
function (tests/test_torch_data_path.py holds each against it bit for bit).
Capability parity with LoadOccupancy / LoadOccupancy2
(reference: datasets/pipelines/loading.py:18-393):
  * SurroundOcc: sparse [K, 4] (x, y, z, cls) npy -> dense [X, Y, Z] grid,
    class 0 -> 255 ignore (:115-116)
  * OpenOccupancy: sparse voxel [K, 4] (z?, ..., cls) per-scene npy with a
    numba majority-vote densifier -> vectorized numpy sort-reduce here
  * BDA (bird's-eye data augmentation) sampling: flips + rotation + scale
    (voxel_transform, loading.py:450-487)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def sample_bda(bda_cfg, rng: Optional[np.random.RandomState] = None):
    rng = rng or np.random
    rot = rng.uniform(*bda_cfg.get("rot_lim", (0, 0)))
    scale = rng.uniform(*bda_cfg.get("scale_lim", (1, 1)))
    flip_dx = rng.uniform() < bda_cfg.get("flip_dx_ratio", 0)
    flip_dy = rng.uniform() < bda_cfg.get("flip_dy_ratio", 0)
    flip_dz = rng.uniform() < bda_cfg.get("flip_dz_ratio", 0)
    return rot, scale, flip_dx, flip_dy, flip_dz


def bda_matrix(rotate_deg=0.0, scale=1.0, flip_dx=False, flip_dy=False,
               flip_dz=False) -> np.ndarray:
    """[3, 3] BDA rotation (reference voxel_transform, loading.py:450-487).

    Note the reference composes flip @ rot and never applies `scale` to the
    matrix (scale_lim is (1, 1) in all shipped configs).
    """
    a = np.deg2rad(rotate_deg)
    rot = np.array([[np.cos(a), -np.sin(a), 0],
                    [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]], np.float32)
    flip = np.eye(3, dtype=np.float32)
    if flip_dx:
        flip = flip @ np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
    if flip_dy:
        flip = flip @ np.diag([1.0, -1.0, 1.0]).astype(np.float32)
    if flip_dz:
        flip = flip @ np.diag([1.0, 1.0, -1.0]).astype(np.float32)
    return (flip @ rot).astype(np.float32)


def load_surroundocc_gt(occ_npy_path: str, grid_size,
                        use_semantic: bool = True) -> np.ndarray:
    """SurroundOcc sparse labels -> dense [X, Y, Z]; cls 0 -> 255 ignore."""
    occ = np.load(occ_npy_path).astype(np.float32)
    return densify_surroundocc(occ, grid_size, use_semantic)


def densify_surroundocc(occ: np.ndarray, grid_size,
                        use_semantic: bool = True) -> np.ndarray:
    voxel = np.zeros(tuple(grid_size), np.int64)
    cls = occ[:, 3].copy()
    if use_semantic:
        cls[cls == 0] = 255
    else:
        keep = cls > 0
        occ = occ[keep]
        cls = np.ones(occ.shape[0])
    voxel[occ[:, 0].astype(np.int64), occ[:, 1].astype(np.int64),
          occ[:, 2].astype(np.int64)] = cls.astype(np.int64)
    return voxel


def majority_vote_densify(coords: np.ndarray, labels: np.ndarray,
                          grid_size) -> np.ndarray:
    """Vectorized replacement for the reference's numba nb_process_label
    (loading.py:433-448): per output voxel, the most frequent label with
    smallest-label tie-break.
    """
    X, Y, Z = grid_size
    lid = (coords[:, 0].astype(np.int64) * Y + coords[:, 1]) * Z + coords[:, 2]
    order = np.lexsort((labels, lid))
    lid_s, lab_s = lid[order], labels[order]
    # count (voxel, label) pairs
    key = lid_s * 4096 + lab_s
    uniq, counts = np.unique(key, return_counts=True)
    uvox = uniq // 4096
    ulab = uniq % 4096
    # pick max count per voxel, ties -> smallest label (lexsort order)
    o = np.lexsort((ulab, -counts, uvox))
    uvox_o = uvox[o]
    first = np.ones(len(o), bool)
    first[1:] = uvox_o[1:] != uvox_o[:-1]
    voxel = np.zeros(X * Y * Z, np.int64)
    voxel[uvox_o[first]] = ulab[o][first]
    return voxel.reshape(X, Y, Z)


def load_panoptic_voxel_gt(points: np.ndarray, panoptic_labels: np.ndarray,
                           learning_map, pc_range, voxel_size, grid_size,
                           unoccupied_id: int = 17) -> np.ndarray:
    """Voxelize panoptic point labels by majority vote.

    Reference: LoadNuscPanopticOccupancyAnnotations
    (loading_nusc_panoptic_occ.py:76-165): labels are general_class*1000 +
    instance; the general class is remapped through `learning_map` keeping
    the instance id; points are CLIPPED into range (not dropped); the
    per-voxel vote excludes the noise label 0 unless it is alone
    (numba counter[0]=0 before argmax); empty voxels get 0, noise-won
    voxels get 65535 (ignore).

    Returns [X, Y, Z] int64 panoptic grid (mapped_class*1000 + instance).
    """
    pcr = np.asarray(pc_range, np.float64)
    vs = np.asarray(voxel_size, np.float64)
    X, Y, Z = [int(g) for g in grid_size]

    sem = (panoptic_labels // 1000).astype(np.int64)
    inst = (panoptic_labels % 1000).astype(np.int64)
    mapped = np.asarray([learning_map.get(int(c), 0)
                         for c in np.unique(sem)])
    lut = np.zeros(int(sem.max(initial=0)) + 1, np.int64)
    for c, m in zip(np.unique(sem), mapped):
        lut[c] = m
    lab = lut[sem] * 1000 + inst

    eps = 1e-5
    xyz = np.clip(points[:, :3], pcr[:3], pcr[3:] - eps)
    ijk = np.floor((xyz - pcr[:3]) / vs).astype(np.int64)
    lid = (ijk[:, 0] * Y + ijk[:, 1]) * Z + ijk[:, 2]

    mult = int(lab.max(initial=0)) + 1
    key = lid * mult + lab
    uniq, counts = np.unique(key, return_counts=True)
    uvox = uniq // mult
    ulab = uniq % mult
    counts = np.where(ulab == 0, 0, counts)  # noise never outvotes
    o = np.lexsort((ulab, -counts, uvox))
    first = np.ones(len(o), bool)
    first[1:] = uvox[o][1:] != uvox[o][:-1]

    grid = np.full(X * Y * Z, unoccupied_id * 1000, np.int64)
    grid[uvox[o][first]] = ulab[o][first]
    grid[grid == 0] = 65535                   # noise-won -> ignore
    grid[grid == unoccupied_id * 1000] = 0    # empty -> free
    return grid.reshape(X, Y, Z)


def world_to_voxel(points: np.ndarray, pc_range, voxel_size) -> np.ndarray:
    pcr = np.asarray(pc_range)
    vs = np.asarray(voxel_size)
    return np.floor((points - pcr[:3]) / vs).astype(np.int64)


def load_openoccupancy_gt(occ_path: str, scene_token: str, lidar_token: str,
                          grid_size, pc_range,
                          bda_rot: Optional[np.ndarray] = None,
                          return_coords: bool = False):
    """OpenOccupancy per-scene sparse labels -> dense [X, Y, Z] grid.

    Reference LoadOccupancy2 (loading.py:265-294): loads
    `scene_{token}/occupancy/{lidar_token}.npy` rows [z, y, x, cls] (or
    [z, y, x, vx, vy, vz, cls]), maps cls 0 -> 255 ignore, converts voxel
    centers to world (voxel2world with +0.5), applies BDA, converts back
    (world2voxel), clips into the grid, then majority-vote densifies.

    return_coords=True additionally returns (world_coords_pre_bda,
    transformed_voxel_coords, labels) for the visible-mask computation.
    """
    import os
    rel = f"scene_{scene_token}/occupancy/{lidar_token}.npy"
    pcd = np.load(os.path.join(occ_path, rel))
    labels = pcd[..., -1].astype(np.int64).copy()
    labels[labels == 0] = 255
    vs = (np.asarray(pc_range[3:]) - np.asarray(pc_range[:3])) \
        / np.asarray(grid_size)
    world = (pcd[..., [2, 1, 0]].astype(np.float64) + 0.5) * vs[None] \
        + np.asarray(pc_range[:3])[None]
    untransformed = world.copy()
    if bda_rot is not None:
        world = world @ np.asarray(bda_rot, np.float64).T
    vox = (world - np.asarray(pc_range[:3])[None]) / vs[None]
    vox = np.clip(vox, 0, np.asarray(grid_size) - 1).astype(np.int64)
    dense = majority_vote_densify(vox, labels, grid_size)
    if return_coords:
        return dense, untransformed, vox, labels
    return dense


def visible_mask_lidar(points: np.ndarray, pc_range, grid_size) -> np.ndarray:
    """Voxels containing at least one LiDAR point (reference
    loading.py:337-345). points: [P, >=3] (post-BDA, like the reference's)."""
    pcr = np.asarray(pc_range, np.float64)
    vs = (pcr[3:] - pcr[:3]) / np.asarray(grid_size)
    pts = points[:, :3]
    inside = np.all((pts >= pcr[:3]) & (pts < pcr[3:]), axis=1)
    vox = ((pts[inside] - pcr[:3]) / vs).astype(np.int64)
    vox = np.clip(vox, 0, np.asarray(grid_size) - 1)
    mask = np.zeros(tuple(grid_size), np.uint8)
    mask[vox[:, 0], vox[:, 1], vox[:, 2]] = 1
    return mask


def visible_mask_camera(occ_world: np.ndarray, trans_vox: np.ndarray,
                        rots, trans, intrins, post_rots, post_trans,
                        img_hw, grid_size) -> np.ndarray:
    """Voxels whose centers survive a per-camera pixel z-buffer (reference
    loading.py:301-335 + nb_process_img_points :396-411).

    occ_world: [N, 3] UNtransformed world centers; trans_vox: [N, 3] the
    BDA-transformed voxel coords used to scatter visibility into the grid.
    """
    H, W = img_hw
    N = occ_world.shape[0]
    n_cam = rots.shape[0]
    visible_pt = np.zeros(N, bool)
    inv_rots = np.linalg.inv(np.asarray(rots, np.float64))
    for c in range(n_cam):
        p = (occ_world - np.asarray(trans[c])[None]) @ inv_rots[c].T
        p = p @ np.asarray(intrins[c], np.float64).T
        d = p[:, 2]
        uv = p[:, :2] / np.maximum(d[:, None], 1e-9)
        uv = uv @ np.asarray(post_rots[c][:2, :2], np.float64).T \
            + np.asarray(post_trans[c][:2])[None]
        ok = (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) \
            & (uv[:, 1] < H) & (d >= 0)
        if not ok.any():
            continue
        # z-buffer at int16 depth*10 resolution like the reference
        ui = uv[ok].astype(np.int64)
        di = (d[ok] * 10).astype(np.int64)
        pix = ui[:, 1] * W + ui[:, 0]
        canvas = np.full(H * W, 2048, np.int64)
        np.minimum.at(canvas, pix, di)
        vis = di <= canvas[pix]
        idx = np.where(ok)[0]
        visible_pt[idx[vis]] = True
    mask = np.zeros(tuple(grid_size), np.uint8)
    # majority vote of per-point visibility into voxels (reference reuses
    # nb_process_label); any-visible is equivalent for a 0/1 label modally
    # tied to the denser side — we follow majority like the reference
    vis_lab = visible_pt.astype(np.int64)
    mask = majority_vote_densify(trans_vox, vis_lab, grid_size).astype(np.uint8)
    return mask
