"""Write a nuScenes tree in the reference's on-disk layout, made from a seed,
for the data path to read where the dataset is not at hand:

    python -m coocc_tpu_torch.tools.nuscenes_tree <dir> [--seed 0]
        [--n-train 3] [--n-val 2]

then, for the LiDAR-only config,

    python -m coocc_tpu_torch.train coocc_lidar --data-root <dir> \\
        --ann-file <dir>/nuscenes_infos_temporal_train.pkl \\
        --val-ann-file <dir>/nuscenes_infos_temporal_val.pkl \\
        --occ-path <dir>/nuscenes_occ --steps-per-epoch 2 --max-epochs 1

The layout (data/nuscenes_dataset.py reads it): the info pickles
`nuscenes_infos_temporal_{train,val}.pkl` ({"infos": [...]}), each
keyframe with its token, scene token and name, LiDAR token and timestamp;
`samples/LIDAR_TOP/*.pcd.bin`, float32 [P, 5] (x, y, z, intensity, ring),
P = 34,720 by default (a nuScenes keyframe's typical count); its sweeps
under `sweeps/LIDAR_TOP/` (10 by default, each with a timestamp 50 ms
apart and a sensor2lidar rotation about z and translation that are not the
identity), so that a keyframe with its sweeps holds 381,920 points and the
loader's 350,000-point capacity truncates it as the reference's does;
`lidarseg/*_lidarseg.bin`, uint8 raw labels (0..31) for the keyframe's
points; the SurroundOcc ground truth `nuscenes_occ/samples/<LiDAR file
name>.npy`, int64 [K, 4] (x, y, z, class) on the 200 x 200 x 16 grid; six
cameras' calibration (nuScenes' intrinsics at 1600 x 900, an outward ring
of extrinsics) and no image (`write_tree(images=True)` writes JPEGs, with
PIL): the LiDAR-only configs read none. Points lie in the flagship's range
(-50..50 m, -5..3 m); the keyframes of a split share one scene.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict

import numpy as np

from ..data.synthetic import camera_ring

CAMS = ("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_LEFT",
        "CAM_BACK", "CAM_BACK_RIGHT")
# nuScenes' camera intrinsics at 1600 x 900 (CAM_FRONT's, rounded)
INTRINSIC = ((1266.4, 0.0, 816.3), (0.0, 1266.4, 491.5), (0.0, 0.0, 1.0))
GRID = (200, 200, 16)


def _cloud(rng, n: int) -> np.ndarray:
    """[n, 5] float32: x, y uniform over +-50 m, z over -3..1.5 m,
    intensity 0..255, ring index 0..31."""
    pts = np.empty((n, 5), np.float32)
    pts[:, :2] = rng.uniform(-50.0, 50.0, (n, 2))
    pts[:, 2] = rng.uniform(-3.0, 1.5, n)
    pts[:, 3] = rng.uniform(0.0, 255.0, n)
    pts[:, 4] = rng.randint(0, 32, n)
    return pts


def _rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def write_tree(root: str, seed: int = 0, n_train: int = 3, n_val: int = 2,
               points: int = 34720, sweeps: int = 10, occupied: int = 60000,
               images: bool = False, cams=CAMS,
               grid=GRID) -> Dict[str, str]:
    """Write the tree under `root` (module note; `cams` names the cameras,
    `grid` is the ground truth's). -> the CLIs' data flags: {"data_root",
    "ann_file", "val_ann_file", "occ_path"}."""
    rng = np.random.RandomState(seed)
    dirs = {k: os.path.join(root, *k.split("/")) for k in (
        "samples/LIDAR_TOP", "sweeps/LIDAR_TOP", "lidarseg",
        "nuscenes_occ/samples")}
    if images:
        dirs.update({c: os.path.join(root, "samples", c) for c in cams})
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    rots, trans = camera_ring(len(cams), rng)
    splits = {"train": [], "val": []}
    for i in range(n_train + n_val):
        split = "train" if i < n_train else "val"
        name = f"n008-{split}-{i:04d}"
        ts = 1_533_151_603_000_000 + i * 500_000
        lidar = os.path.join(dirs["samples/LIDAR_TOP"],
                             f"{name}__LIDAR_TOP__{ts}.pcd.bin")
        _cloud(rng, points).tofile(lidar)
        sw = []
        for j in range(sweeps):
            path = os.path.join(dirs["sweeps/LIDAR_TOP"],
                                f"{name}__LIDAR_TOP__{ts - 50_000 * (j + 1)}"
                                ".pcd.bin")
            _cloud(rng, points).tofile(path)
            sw.append({"data_path": path,
                       "timestamp": ts - 50_000 * (j + 1),
                       "sensor2lidar_rotation": _rot_z(0.01 * (j + 1)),
                       "sensor2lidar_translation": np.array(
                           [0.5 * (j + 1), 0.02 * (j + 1), 0.0])})
        cam_infos = {}
        for c, cam in enumerate(cams):
            s2l = np.eye(4)
            s2l[:3, :3] = rots[c]
            s2l[:3, 3] = trans[c] + np.array([0.0, 0.0, 1.5])
            rel = f"samples/{cam}/{name}__{cam}__{ts}.jpg"
            if images:
                from ..data.pipelines.image_loading import pil_image
                pil_image().fromarray(rng.randint(
                    0, 256, (900, 1600, 3)).astype(np.uint8)).save(
                    os.path.join(root, rel))
            cam_infos[cam] = {"data_path": rel, "cam_intrinsic": np.array(
                INTRINSIC), "lidar2cam": np.linalg.inv(s2l),
                "sensor2lidar_rotation": s2l[:3, :3],
                "sensor2lidar_translation": s2l[:3, 3]}
        seg = f"lidarseg/{name}_lidarseg.bin"
        rng.randint(0, 32, points).astype(np.uint8).tofile(
            os.path.join(root, seg))
        occ = np.stack([rng.randint(0, grid[0], occupied),
                        rng.randint(0, grid[1], occupied),
                        rng.randint(0, grid[2], occupied),
                        rng.randint(0, 17, occupied)], axis=1)
        np.save(os.path.join(dirs["nuscenes_occ/samples"],
                             os.path.basename(lidar) + ".npy"), occ)
        splits[split].append({
            "token": f"{name}-token", "scene_token": f"scene-{split}",
            "scene_name": f"scene-{split}", "lidar_token": f"{name}-lidar",
            "lidar_path": lidar, "lidarseg": seg, "timestamp": ts,
            "sweeps": sw, "cams": cam_infos,
            "lidar2ego_rotation": np.array([1.0, 0.0, 0.0, 0.0]),
            "lidar2ego_translation": np.array([0.94, 0.0, 1.84]),
            "ego2global_rotation": np.array([1.0, 0.0, 0.0, 0.0]),
            "ego2global_translation": np.array([600.0 + 5.0 * i, 1600.0,
                                                0.0])})
    out = {"data_root": root, "occ_path": os.path.join(root, "nuscenes_occ")}
    for split, key in (("train", "ann_file"), ("val", "val_ann_file")):
        out[key] = os.path.join(root,
                                f"nuscenes_infos_temporal_{split}.pkl")
        with open(out[key], "wb") as f:
            pickle.dump({"infos": splits[split]}, f)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m coocc_tpu_torch.tools."
                                 "nuscenes_tree")
    ap.add_argument("root")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=3)
    ap.add_argument("--n-val", type=int, default=2)
    args = ap.parse_args(argv)
    flags = write_tree(args.root, args.seed, args.n_train, args.n_val)
    print(" ".join(f"--{k.replace('_', '-')} {v}" for k, v in flags.items()))


if __name__ == "__main__":
    main()
