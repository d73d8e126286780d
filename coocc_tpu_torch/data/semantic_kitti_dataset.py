"""SemanticKITTI occupancy dataset (stereo cams + voxel GT at 1_1..1_16).

A numpy copy of coocc_tpu/data/semantic_kitti_dataset.py (tests/
test_torch_data_path.py holds `get_sample` against it bit for bit); its
images need PIL (pipelines/image_loading.py).
Capability parity with CustomSemanticKITTILssDataset
(reference: datasets/semantic_kitti_lss_dataset.py:11-617): sequence/calib
parsing (read_calib :41-74), scan index from voxels/*.bin, stereo image_2/3
cameras with P2/P3 @ Tr projection, preprocessed voxel GT npys at
multi-scale suffixes _1_1.npy etc. Produces the same padded-Batch format as
the nuScenes loader (KITTI intrinsics kept 3x4 — the geometry lib handles
the translation column, geometry/frustum.py get_geometry).
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from ..config.base import CoOccConfig
from .nuscenes_dataset import pad_points
from .pipelines.image_loading import (img_transform, load_image,
                                     sample_augmentation)

SPLITS = {
    "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
    "val": ["08"],
    "trainval": ["00", "01", "02", "03", "04", "05", "06", "07", "08",
                 "09", "10"],
    "test": ["08"],
    "test-submit": ["11", "12", "13", "14", "15", "16", "17", "18", "19",
                    "20", "21"],
}


def read_calib(calib_path: str) -> Dict[str, np.ndarray]:
    """Parse KITTI calib.txt -> P2/P3 (4x4) and Tr (velo->cam, 4x4)."""
    calib_all = {}
    with open(calib_path) as f:
        for line in f:
            if line == "\n":
                break
            key, value = line.split(":", 1)
            calib_all[key] = np.array([float(x) for x in value.split()])
    out = {}
    for k in ("P2", "P3"):
        m = np.identity(4)
        m[:3, :4] = calib_all[k].reshape(3, 4)
        out[k] = m
    tr = np.identity(4)
    tr[:3, :4] = calib_all["Tr"].reshape(3, 4)
    out["Tr"] = tr
    return out


class SemanticKITTIOccDataset:
    def __init__(self, cfg: CoOccConfig, data_root: str, ann_file: str,
                 split: str = "train", camera_used=("left",),
                 is_train: bool = True):
        self.cfg = cfg
        self.data_root = data_root
        self.ann_file = ann_file  # preprocessed voxel GT root
        self.is_train = is_train
        camera_map = {"left": "2", "right": "3"}
        self.camera_used = [camera_map[c] for c in camera_used]
        self.scans: List[Dict] = []
        for seq in SPLITS[split]:
            calib = read_calib(os.path.join(
                data_root, "dataset", "sequences", seq, "calib.txt"))
            base = os.path.join(data_root, "dataset", "sequences", seq)
            for vox in sorted(glob.glob(os.path.join(base, "voxels",
                                                     "*.bin"))):
                frame = os.path.basename(vox).split(".")[0]
                voxel_path = os.path.join(ann_file, seq, f"{frame}_1_1.npy")
                voxel_path_2 = os.path.join(ann_file, seq,
                                            f"{frame}_1_2.npy")
                self.scans.append(dict(
                    sequence=seq, frame_id=frame,
                    img_paths={c: os.path.join(base, f"image_{c}",
                                               f"{frame}.png")
                               for c in self.camera_used},
                    lidar_path=os.path.join(base, "velodyne",
                                            f"{frame}.bin"),
                    P={c: calib[f"P{c}"] for c in self.camera_used},
                    T_velo_2_cam=calib["Tr"],
                    voxel_path=voxel_path if os.path.exists(voxel_path)
                    else None,
                    voxel_path_2=voxel_path_2
                    if os.path.exists(voxel_path_2) else None,
                ))

    def __len__(self):
        return len(self.scans)

    @property
    def group_flags(self) -> np.ndarray:
        """Single aspect-ratio group (reference custom_3d.py:363-370)."""
        return np.zeros(len(self), np.uint8)

    def get_sample(self, idx: int,
                   rng: Optional[np.random.RandomState] = None) -> Dict:
        cfg = self.cfg
        info = self.scans[idx]
        rng = rng or np.random.RandomState()
        out: Dict = {}

        imgs, intrins, rots, trans, post_rots, post_trans = \
            [], [], [], [], [], []
        for c in self.camera_used:
            img = load_image(info["img_paths"][c])
            augs = sample_augmentation(img.height, img.width, cfg.data,
                                       self.is_train, rng)
            img, pr2, pt2 = img_transform(img, *augs)
            post_rot = np.eye(3, dtype=np.float32)
            post_tran = np.zeros(3, np.float32)
            post_rot[:2, :2] = pr2
            post_tran[:2] = pt2
            imgs.append(np.asarray(img, np.float32) / 255.0)
            # KITTI convention: intrins = P (3x4), extrinsics velo->cam
            intrins.append(info["P"][c][:3].astype(np.float32))
            cam2velo = np.linalg.inv(info["T_velo_2_cam"])
            rots.append(cam2velo[:3, :3].astype(np.float32))
            trans.append(cam2velo[:3, 3].astype(np.float32))
            post_rots.append(post_rot)
            post_trans.append(post_tran)

        out["imgs"] = np.stack(imgs)
        out["intrins"] = np.stack(intrins)
        out["rots"] = np.stack(rots)
        out["trans"] = np.stack(trans)
        out["post_rots"] = np.stack(post_rots)
        out["post_trans"] = np.stack(post_trans)
        out["bda"] = np.eye(3, dtype=np.float32)

        if info["voxel_path"] is not None:
            out["gt_occ"] = np.load(info["voxel_path"]).astype(np.int64)
        else:
            out["gt_occ"] = np.zeros(cfg.occ_size, np.int64)
        # preprocessed half-scale GT (semantic_kitti_downsample majority
        # vote); the loss prefers it over mode-pooling the 1_1 grid
        # (reference: semantic_kitti_lss_dataset.py multi-scale gt loading)
        if info.get("voxel_path_2") is not None:
            out["gt_occ_2"] = np.load(info["voxel_path_2"]).astype(np.int64)

        pts = np.fromfile(info["lidar_path"],
                          dtype=np.float32).reshape(-1, 4)
        # per-view GT depth maps from the scan (reference kitti pipeline
        # CreateDepthFromLiDAR equivalent; feeds DepthNet BCE + render loss)
        H, W = cfg.data.input_size
        from .pipelines.lidar2depth import create_depth_maps
        out["gt_depths"] = create_depth_maps(
            pts[:, :3], out["rots"], out["trans"], out["intrins"],
            out["post_rots"], out["post_trans"], H, W)
        if cfg.use_lidar:
            pad5 = np.concatenate(
                [pts, np.zeros((pts.shape[0], 1), np.float32)], axis=1)
            out["points"], out["points_mask"] = pad_points(
                pad5, cfg.pts.max_points)
        return out
