"""nuScenes class metadata: the class names and the balanced CE class
weights.

A copy of the part of coocc_tpu/config/nuscenes.py the port reads: the 17
occupancy class names the eval tables print (reference
coocc_multi_r50_256x704.py:17-21), the nusc_param.py:10-12 voxel counts
and occ_head.py:135-139's 1 / log(freq) weighting of these counts.
"""
from __future__ import annotations

import numpy as np

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


def class_weights(num_classes: int = NUM_NUSC_CLASSES) -> np.ndarray:
    """Balanced CE class weights 1 / log(freq + 0.001), fp32, of the
    nuScenes counts (JAX nuscenes.py:49-60; the port's other class counts
    are not in the copy)."""
    if num_classes != NUM_NUSC_CLASSES:
        raise NotImplementedError(f"{num_classes} classes")
    freq = NUSC_CLASS_FREQUENCIES
    return (1.0 / np.log(freq + 0.001)).astype(np.float32)
