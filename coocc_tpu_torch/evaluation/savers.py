"""Prediction dumps and the benchmark submission writers.

A numpy copy of coocc_tpu/evaluation/savers.py (reference
coocc/apis/utils.py:18-134): `save_output_nuscenes`, per-sample npz files
of the predicted (and ground-truth) voxel classes for offline
visualization, under a scene's folder where one is named;
`save_output_semantic_kitti`, the SemanticKITTI `.label` submission
(uint16 raw labels through the inverse learning map, under
sequences/XX/predictions), and `validate_semkitti_submission`, its format
check; `save_output_nuscenes_lidarseg`, the nuScenes lidarseg `.bin`
submission (uint8 labels under lidarseg/test), and
`validate_lidarseg_submission`, its format check.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config.semantic_kitti import KITTI_LEARNING_MAP_INV


def save_output_semantic_kitti(pred_voxels: np.ndarray, out_dir: str,
                               sequence: str, frame_id: str):
    """pred_voxels: [X, Y, Z] int train-ids -> .label uint16 submission."""
    inv = np.zeros(max(KITTI_LEARNING_MAP_INV) + 1, np.uint16)
    for k, v in KITTI_LEARNING_MAP_INV.items():
        inv[k] = v
    labels = inv[pred_voxels.astype(np.int64).reshape(-1)]
    d = os.path.join(out_dir, "sequences", sequence, "predictions")
    os.makedirs(d, exist_ok=True)
    labels.astype(np.uint16).tofile(os.path.join(d, f"{frame_id}.label"))


def save_output_nuscenes(pred_voxels: np.ndarray, out_dir: str,
                         sample_token: str,
                         gt_voxels: Optional[np.ndarray] = None,
                         scene_name: Optional[str] = None):
    """Dump pred (and optionally GT) voxels as npz for visualization, in
    out_dir/scene_name where a scene is named."""
    d = os.path.join(out_dir, scene_name) if scene_name else out_dir
    os.makedirs(d, exist_ok=True)
    arrays = {"pred": pred_voxels.astype(np.uint8)}
    if gt_voxels is not None:
        arrays["gt"] = gt_voxels.astype(np.uint8)
    np.savez_compressed(os.path.join(d, f"{sample_token}.npz"), **arrays)


def save_output_nuscenes_lidarseg(point_preds: np.ndarray, out_dir: str,
                                  lidar_token: str):
    """point_preds: [P] train-ids (1..16) -> official .bin uint8 submission."""
    d = os.path.join(out_dir, "lidarseg", "test")
    os.makedirs(d, exist_ok=True)
    point_preds.astype(np.uint8).tofile(
        os.path.join(d, f"{lidar_token}_lidarseg.bin"))


def validate_semkitti_submission(root: str) -> bool:
    """The official format check (reference
    tools/validate_semkitti_submission.py): every prediction of sequences
    11..21 is a uint16 .label of 256 x 256 x 32 voxels."""
    ok = True
    for seq in [f"{i}" for i in range(11, 22)]:
        d = os.path.join(root, "sequences", seq, "predictions")
        if not os.path.isdir(d):
            continue
        for f in os.listdir(d):
            labels = np.fromfile(os.path.join(d, f), dtype=np.uint16)
            if labels.size != 256 * 256 * 32:
                ok = False
    return ok


def validate_lidarseg_submission(root: str, num_classes: int = 17) -> bool:
    """The official format check (reference
    projects/mmdet3d_plugin/tools/validate_lidarseg_submission.py): every
    lidarseg .bin is non-empty uint8 with labels in [1, num_classes - 1]
    (0 is the ignore/noise class and is never predicted), and there is at
    least one."""
    d = os.path.join(root, "lidarseg", "test")
    if not os.path.isdir(d):
        return False
    ok = True
    n_files = 0
    for f in os.listdir(d):
        if not f.endswith("_lidarseg.bin"):
            continue
        n_files += 1
        labels = np.fromfile(os.path.join(d, f), dtype=np.uint8)
        if labels.size == 0 or labels.min() < 1 or labels.max() >= num_classes:
            ok = False
    return ok and n_files > 0
