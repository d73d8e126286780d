"""SemanticKITTI class metadata.

A copy of coocc_tpu/config/semantic_kitti.py (reference
projects/mmdet3d_plugin/utils/semkitti.py:6-52 for the class names and
frequencies, projects/configs/_base_/semantickitti.yaml:109-143 for the raw
-> train learning map and its inverse): the 20 class names, the voxel
counts `config/nuscenes.py:class_weights` weights for 20 classes, and the
maps the label writer (evaluation/savers.py) reads. tests/test_torch_data.py
pins them equal to JAX's.
"""
from __future__ import annotations

import numpy as np

KITTI_CLASS_NAMES = [
    "empty", "car", "bicycle", "motorcycle", "truck", "other-vehicle",
    "person", "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
]

NUM_KITTI_CLASSES = len(KITTI_CLASS_NAMES)  # 20

KITTI_CLASS_FREQUENCIES = np.array([
    5.41773033e09, 1.57835390e07, 1.25136000e05, 1.18809000e05,
    6.46799000e05, 8.21951000e05, 2.62978000e05, 2.83696000e05,
    2.04750000e05, 6.16887030e07, 4.50296100e06, 4.48836500e07,
    2.26992300e06, 5.68402180e07, 1.57196520e07, 1.58442623e08,
    2.06162300e06, 3.69705220e07, 1.15198800e06, 3.34146000e05,
], dtype=np.float64)

KITTI_LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5,
    30: 6, 31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13,
    51: 14, 52: 0, 60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19,
    99: 0, 252: 1, 253: 7, 254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

KITTI_LEARNING_MAP_INV = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32,
    9: 40, 10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71,
    17: 72, 18: 80, 19: 81,
}


def learning_map_array() -> np.ndarray:
    """Dense lookup table: raw SemanticKITTI label -> train id."""
    table = np.zeros(260, dtype=np.int64)
    for src, dst in KITTI_LEARNING_MAP.items():
        table[src] = dst
    return table
