"""nuScenes class metadata: the class names, the balanced CE class
weights and the lidarseg learning map.

A copy of the part of coocc_tpu/config/nuscenes.py the port reads: the 17
occupancy class names the eval tables print (reference
coocc_multi_r50_256x704.py:17-21), the nusc_param.py:10-12 voxel counts
and occ_head.py:135-139's 1 / log(freq) weighting, of these counts or, for
any other class count, of SemanticKITTI's (config/semantic_kitti.py), and
the 32 -> 17 lidarseg learning map (reference nuscenes.yaml:53-85) the
loader reads; tests/test_torch_losses.py, tests/test_torch_eval.py and
tests/test_torch_data.py pin them equal.
"""
from __future__ import annotations

import numpy as np

from .semantic_kitti import KITTI_CLASS_FREQUENCIES

NUSC_CLASS_NAMES = [
    "empty", "barrier", "bicycle", "bus", "car",
    "construction_vehicle", "motorcycle", "pedestrian",
    "traffic_cone", "trailer", "truck", "driveable_surface",
    "other_flat", "sidewalk", "terrain", "manmade", "vegetation",
]

NUM_NUSC_CLASSES = len(NUSC_CLASS_NAMES)  # 17

# voxel counts per class over the nuScenes-Occupancy training split
NUSC_CLASS_FREQUENCIES = np.array([
    2242961742295, 25985376, 1561108, 28862014, 196106643, 15920504,
    2158753, 26539491, 4004729, 34838681, 75173306, 2255027978, 50959399,
    646022466, 869055679, 1446141335, 1724391378,
], dtype=np.float64)


# lidarseg raw label (0..31) -> 17-class learning map
NUSC_LEARNING_MAP = {
    1: 0, 5: 0, 7: 0, 8: 0, 10: 0, 11: 0, 13: 0, 19: 0, 20: 0, 0: 0,
    29: 0, 31: 0,
    9: 1, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 21: 6,
    2: 7, 3: 7, 4: 7, 6: 7,
    12: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 30: 16,
}


def learning_map_array() -> np.ndarray:
    """Dense lookup table: raw lidarseg label -> train id."""
    table = np.zeros(32, dtype=np.int64)
    for src, dst in NUSC_LEARNING_MAP.items():
        table[src] = dst
    return table


def class_weights(num_classes: int = NUM_NUSC_CLASSES) -> np.ndarray:
    """Balanced CE class weights 1 / log(freq + 0.001), fp32: of the
    nuScenes counts for 17 classes, of SemanticKITTI's otherwise (JAX
    nuscenes.py:49-60)."""
    freq = NUSC_CLASS_FREQUENCIES if num_classes == NUM_NUSC_CLASSES \
        else KITTI_CLASS_FREQUENCIES
    return (1.0 / np.log(freq + 0.001)).astype(np.float32)
