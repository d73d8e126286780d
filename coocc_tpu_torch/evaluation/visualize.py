"""Offline occupancy visualization (matplotlib, imported inside the
functions that draw; no GPU).

A numpy copy of coocc_tpu/evaluation/visualize.py (the reference's
visualize/visualize_{nusc,kitti,...}.py): read the npz dumps of
evaluation/savers.py:save_output_nuscenes and render bird's-eye and 3D
scatter views in the nuScenes palette.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# nuScenes-style 17-class palette (RGB 0-255), free = transparent
NUSC_PALETTE = np.array([
    [0, 0, 0],        # 0 free
    [112, 128, 144],  # barrier
    [220, 20, 60],    # bicycle
    [255, 127, 80],   # bus
    [255, 158, 0],    # car
    [233, 150, 70],   # construction_vehicle
    [255, 61, 99],    # motorcycle
    [0, 0, 230],      # pedestrian
    [47, 79, 79],     # traffic_cone
    [255, 140, 0],    # trailer
    [255, 99, 71],    # truck
    [0, 207, 191],    # driveable_surface
    [175, 0, 75],     # other_flat
    [75, 0, 75],      # sidewalk
    [112, 180, 60],   # terrain
    [222, 184, 135],  # manmade
    [0, 175, 0],      # vegetation
], dtype=np.uint8)


def bev_image(voxels: np.ndarray, palette: np.ndarray = NUSC_PALETTE,
              free_idx: int = 0) -> np.ndarray:
    """[X, Y, Z] labels -> [X, Y, 3] BEV image (the topmost occupied voxel
    of each column; 255, ignore, counts as free)."""
    X, Y, Z = voxels.shape
    occ = (voxels != free_idx) & (voxels != 255)
    top_z = Z - 1 - np.argmax(occ[:, :, ::-1], axis=2)
    has = occ.any(axis=2)
    labels = np.where(has, voxels[np.arange(X)[:, None],
                                  np.arange(Y)[None, :], top_z], free_idx)
    return palette[np.clip(labels, 0, len(palette) - 1)]


def save_visualization(npz_path: str, out_path: Optional[str] = None,
                       palette: np.ndarray = NUSC_PALETTE):
    """Render a saver npz (pred [+ gt]) to a side-by-side BEV png."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.load(npz_path)
    panels = [("prediction", bev_image(data["pred"], palette))]
    if "gt" in data:
        panels.append(("ground truth", bev_image(data["gt"], palette)))
    fig, axes = plt.subplots(1, len(panels),
                             figsize=(6 * len(panels), 6), squeeze=False)
    for ax, (title, img) in zip(axes[0], panels):
        ax.imshow(np.transpose(img, (1, 0, 2))[::-1])
        ax.set_title(title)
        ax.axis("off")
    out_path = out_path or npz_path.replace(".npz", ".png")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path


def scatter3d(voxels: np.ndarray, out_path: str, max_points: int = 40000,
              palette: np.ndarray = NUSC_PALETTE, free_idx: int = 0):
    """3D scatter of the occupied voxels (at most max_points, drawn with
    a fixed seed)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    occ = np.argwhere((voxels != free_idx) & (voxels != 255))
    if len(occ) > max_points:
        occ = occ[np.random.RandomState(0).choice(len(occ), max_points,
                                                  replace=False)]
    colors = palette[np.clip(voxels[occ[:, 0], occ[:, 1], occ[:, 2]],
                             0, len(palette) - 1)] / 255.0
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(occ[:, 0], occ[:, 1], occ[:, 2], c=colors, s=1, marker="s")
    ax.set_box_aspect((voxels.shape[0], voxels.shape[1],
                       voxels.shape[2] * 4))
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path
