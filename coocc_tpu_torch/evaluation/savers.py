"""Prediction dumps.

A numpy copy of coocc_tpu/evaluation/savers.py `save_output_nuscenes`
(reference coocc/apis/utils.py:18-134): per-sample npz files of the
predicted (and ground-truth) voxel classes for offline visualization. The
submission writers (SemanticKITTI labels, lidarseg bins) are not copied.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_output_nuscenes(pred_voxels: np.ndarray, out_dir: str,
                         sample_token: str,
                         gt_voxels: Optional[np.ndarray] = None):
    """Dump pred (and optionally GT) voxels as npz for visualization."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = {"pred": pred_voxels.astype(np.uint8)}
    if gt_voxels is not None:
        arrays["gt"] = gt_voxels.astype(np.uint8)
    np.savez_compressed(os.path.join(out_dir, f"{sample_token}.npz"),
                        **arrays)
