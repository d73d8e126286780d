"""nuScenes class metadata: the balanced CE class weights.

A copy of the part of coocc_tpu/config/nuscenes.py the losses read (the
reference's nusc_param.py:10-12 voxel counts and occ_head.py:135-139's
1 / log(freq) weighting); tests/test_torch_losses.py pins it equal.
"""
from __future__ import annotations

import numpy as np

NUM_NUSC_CLASSES = 17

# voxel counts per class over the nuScenes-Occupancy training split
NUSC_CLASS_FREQUENCIES = np.array([
    2242961742295, 25985376, 1561108, 28862014, 196106643, 15920504,
    2158753, 26539491, 4004729, 34838681, 75173306, 2255027978, 50959399,
    646022466, 869055679, 1446141335, 1724391378,
], dtype=np.float64)


def class_weights(num_classes: int = NUM_NUSC_CLASSES) -> np.ndarray:
    """Balanced CE class weights 1 / log(freq + 0.001), fp32. Only the
    nuScenes table is copied: SemanticKITTI's (20 classes) raises."""
    if num_classes != NUM_NUSC_CLASSES:
        raise NotImplementedError(
            f"class weights for {num_classes} classes are not ported")
    return (1.0 / np.log(NUSC_CLASS_FREQUENCIES + 0.001)).astype(np.float32)
