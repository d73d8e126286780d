"""nuScenes occupancy dataset: infos pkl -> model-ready fixed-shape batches.

A numpy copy of coocc_tpu/data/nuscenes_dataset.py (tests/
test_torch_data_path.py holds every key of `get_sample` and `collate`
against it bit for bit, with the same RandomState). Capability parity with
CustomNuScenesOccLSSDataset + its pipeline (reference:
datasets/nuscenes_lss_dataset.py:9-207 get_data_info packing, pipeline
order coocc_multi_r50_256x704.py:191-223: load points (+10 sweeps),
load/aug images, LiDAR->depth maps, occupancy GT). Every sample is padded
to static shapes (points capacity, fixed cams), as JAX's are. Batching and
prefetch live in data/loader.py (threaded prefetch + per-rank index
sharding, the DataLoader/DistributedGroupSampler equivalent); `collate`
gives the port's models/coocc_ray.py:Batch of numpy arrays, which
`Batch.to(device)` copies onto the card.

On-disk layout (the reference's; paths in the infos are absolute or
relative to the working directory, a camera's `data_path` relative to
`data_root`): an info pickle ({"infos": [...]} or a list) of keyframes with
`token`, `timestamp` (us), `lidar_path` (a float32 [P, 5] .pcd.bin),
`sweeps` (each `data_path`, `timestamp`, `sensor2lidar_rotation` and
`_translation`), `cams` (each `data_path`, `cam_intrinsic` and `lidar2cam`,
or `sensor2lidar_rotation` and `_translation`), optionally `scene_token`,
`scene_name`, `lidar_token`, `lidarseg` (a uint8 label file) and the
stereo config's ego poses; SurroundOcc ground truth at
`<occ_path>/samples/<basename(lidar_path)>.npy` ([K, 4] x, y, z, class),
OpenOccupancy's at `<occ_path>/scene_<scene_token>/occupancy/
<lidar_token>.npy`. A config without cameras reads no image: PIL is
imported only where pixels are decoded (pipelines/image_loading.py).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from ..config.base import CoOccConfig
from .pipelines.image_loading import (load_multi_view_images,
                                     post_homography, sample_augmentation)
from .pipelines.lidar2depth import create_depth_maps
from .pipelines.load_occupancy import (
    bda_matrix, load_surroundocc_gt, sample_bda,
)

DEFAULT_BDA = dict(rot_lim=(0, 0), scale_lim=(1, 1), flip_dx_ratio=0,
                   flip_dy_ratio=0, flip_dz_ratio=0)


def _quat_rot(q) -> np.ndarray:
    """[w, x, y, z] quaternion -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ])


def load_points_with_sweeps(info: Dict, sweeps_num: int = 10,
                            rng: Optional[np.random.RandomState] = None,
                            test_mode: bool = False) -> np.ndarray:
    """Keyframe + up to `sweeps_num` motion-compensated sweeps, 5-dim
    (x, y, z, intensity, dt). Reference: mmdet3d LoadPointsFromFile +
    LoadPointsFromMultiSweeps(sweeps_num=10), loading.py:99-220."""
    pts = np.fromfile(info["lidar_path"], dtype=np.float32).reshape(-1, 5)
    pts[:, 4] = 0.0
    clouds = [pts]
    sweeps = info.get("sweeps", [])
    if len(sweeps) > 0:
        if len(sweeps) <= sweeps_num or test_mode:
            choices = np.arange(min(len(sweeps), sweeps_num))
        else:
            rng = rng or np.random
            choices = rng.choice(len(sweeps), sweeps_num, replace=False)
        ts = info["timestamp"] / 1e6
        for i in choices:
            sw = sweeps[i]
            p = np.fromfile(sw["data_path"], dtype=np.float32).reshape(-1, 5)
            p[:, 4] = 0.0
            r = np.asarray(sw["sensor2lidar_rotation"])
            t = np.asarray(sw["sensor2lidar_translation"])
            p[:, :3] = p[:, :3] @ r.T + t
            p[:, 4] = ts - sw["timestamp"] / 1e6
            clouds.append(p)
    return np.concatenate(clouds, axis=0)


def pad_points(points: np.ndarray, capacity: int):
    P = points.shape[0]
    if P >= capacity:
        return points[:capacity], np.ones(capacity, bool)
    out = np.zeros((capacity, points.shape[1]), np.float32)
    out[:P] = points
    mask = np.zeros(capacity, bool)
    mask[:P] = True
    return out, mask


def camera_free_geometry(cam_infos: Dict, data_cfg) -> Dict:
    """Per-camera calibration + deterministic (test-style) post homography
    without loading any image — the lidar-only config's rendering geometry
    (reference: lidar2depth.py:90-178 builds the same tuple with zero
    images and default augmentation). JAX opens a blank PIL image of
    src_size only to call img_transform, whose homography does not read
    pixels: here post_homography computes it, and PIL is never imported."""
    H_src, W_src = data_cfg.src_size
    rots, trans, intrins, post_rots, post_trans = [], [], [], [], []
    for cam_name in data_cfg.cams:
        cam = cam_infos[cam_name]
        sensor2lidar = np.linalg.inv(np.asarray(cam["lidar2cam"], np.float64))
        resize, _, crop, flip, rotate = sample_augmentation(
            H_src, W_src, data_cfg, is_train=False)
        pr2, pt2 = post_homography(resize, crop, flip, rotate)
        post_rot = np.eye(3, dtype=np.float32)
        post_tran = np.zeros(3, np.float32)
        post_rot[:2, :2] = pr2
        post_tran[:2] = pt2
        rots.append(sensor2lidar[:3, :3].astype(np.float32))
        trans.append(sensor2lidar[:3, 3].astype(np.float32))
        intrins.append(np.asarray(cam["cam_intrinsic"], np.float32))
        post_rots.append(post_rot)
        post_trans.append(post_tran)
    return {
        "rots": np.stack(rots), "trans": np.stack(trans),
        "intrins": np.stack(intrins), "post_rots": np.stack(post_rots),
        "post_trans": np.stack(post_trans),
    }


class NuScenesOccDataset:
    """Reads nuscenes_infos_temporal_{train,val}.pkl and produces samples."""

    def __init__(self, cfg: CoOccConfig, data_root: str, ann_file: str,
                 occ_path: str, is_train: bool,
                 bda_aug_conf: Optional[Dict] = None,
                 cal_visible: bool = False):
        self.cfg = cfg
        self.data_root = data_root
        self.occ_path = occ_path
        self.is_train = is_train
        self.cal_visible = cal_visible
        self.bda_aug_conf = bda_aug_conf or DEFAULT_BDA
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
        self.infos = sorted(infos, key=lambda x: x["timestamp"])

    def __len__(self):
        return len(self.infos)

    @property
    def group_flags(self) -> np.ndarray:
        """Aspect-ratio group per sample for the group-aware sampler.
        3D datasets are single-group in the reference too
        (mmdet3d custom_3d.py:363-370 sets flag = zeros); kept as a
        property so format variants can bucket differently."""
        return np.zeros(len(self), np.uint8)

    def _add_stereo_prev(self, idx: int, info: Dict, out: Dict) -> None:
        """Previous-keyframe inputs for the BEVStereo depth path
        (cfg.lss.stereo): imgs_prev + per-camera key-cam -> prev-cam rigid
        transforms via the global frame (cam2global = ego2global @ lidar2ego
        @ sensor2lidar, cam timestamp approximated by the lidar keyframe's).
        First frame of a scene pairs with itself (identity motion) — the
        BEVStereo convention for missing adjacency. Prev images are loaded
        with the deterministic test-time transform (the plane-sweep warp
        omits image aug, nn/lss_stereo.homo_warp)."""
        prev = self.infos[idx - 1] if idx > 0 and \
            self.infos[idx - 1].get("scene_token") == \
            info.get("scene_token") else info

        def cam2global(fr, cam_name):
            cam = fr["cams"][cam_name]
            s2l = np.eye(4)
            s2l[:3, :3] = np.asarray(cam["sensor2lidar_rotation"])
            s2l[:3, 3] = np.asarray(cam["sensor2lidar_translation"])
            l2e = np.eye(4)
            l2e[:3, :3] = _quat_rot(fr["lidar2ego_rotation"])
            l2e[:3, 3] = np.asarray(fr["lidar2ego_translation"])
            e2g = np.eye(4)
            e2g[:3, :3] = _quat_rot(fr["ego2global_rotation"])
            e2g[:3, 3] = np.asarray(fr["ego2global_translation"])
            return e2g @ l2e @ s2l

        prev_cam_infos = {}
        for cam_name, cam in prev["cams"].items():
            prev_cam_infos[cam_name] = dict(
                data_path=os.path.join(self.data_root, cam["data_path"])
                if not os.path.isabs(cam["data_path"]) else cam["data_path"],
                cam_intrinsic=cam["cam_intrinsic"],
                lidar2cam=np.eye(4),  # unused for stereo imgs
            )
        prev_imgs = load_multi_view_images(prev_cam_infos, self.cfg.data,
                                           is_train=False)
        out["imgs_prev"] = prev_imgs["imgs"]

        k2s_r, k2s_t = [], []
        for cam_name in self.cfg.data.cams:
            T = np.linalg.inv(cam2global(prev, cam_name)) \
                @ cam2global(info, cam_name)
            k2s_r.append(T[:3, :3].astype(np.float32))
            k2s_t.append(T[:3, 3].astype(np.float32))
        out["k2s_rots"] = np.stack(k2s_r)
        out["k2s_trans"] = np.stack(k2s_t)

    def get_sample(self, idx: int,
                   rng: Optional[np.random.RandomState] = None) -> Dict:
        cfg = self.cfg
        info = self.infos[idx]
        rng = rng or np.random.RandomState()
        out: Dict = {}

        # --- camera infos
        cam_infos = {}
        for cam_name, cam in info["cams"].items():
            lidar2cam = cam.get("lidar2cam")
            if lidar2cam is None:
                # build from sensor2lidar rotation/translation if present
                r = np.asarray(cam["sensor2lidar_rotation"])
                t = np.asarray(cam["sensor2lidar_translation"])
                s2l = np.eye(4)
                s2l[:3, :3] = r
                s2l[:3, 3] = t
                lidar2cam = np.linalg.inv(s2l)
            cam_infos[cam_name] = dict(
                data_path=os.path.join(self.data_root, cam["data_path"])
                if not os.path.isabs(cam["data_path"]) else cam["data_path"],
                cam_intrinsic=cam["cam_intrinsic"],
                lidar2cam=lidar2cam,
            )

        if cfg.use_camera:
            imgs = load_multi_view_images(cam_infos, cfg.data, self.is_train,
                                          rng)
            out.update(imgs)
            if cfg.lss is not None and cfg.lss.stereo:
                self._add_stereo_prev(idx, info, out)
        elif cfg.render.use_rendering:
            # camera-free geometry branch (reference: lidar2depth.py:90-178
            # builds per-camera calib + depth maps without loading images so
            # the lidar-only model can still render depth)
            out.update(camera_free_geometry(cam_infos, cfg.data))

        # --- LiDAR points (+ sweeps)
        points = load_points_with_sweeps(info, rng=rng,
                                         test_mode=not self.is_train)
        if "rots" in out:
            H, W = cfg.data.input_size
            raw = np.fromfile(info["lidar_path"],
                              dtype=np.float32).reshape(-1, 5)[:, :3]
            out["gt_depths"] = create_depth_maps(
                raw, out["rots"], out["trans"], out["intrins"],
                out["post_rots"], out["post_trans"], H, W)

        # --- BDA + occupancy GT
        if self.is_train:
            bda = bda_matrix(*sample_bda(self.bda_aug_conf, rng))
        else:
            bda = np.eye(3, dtype=np.float32)
        out["bda"] = bda
        points[:, :3] = points[:, :3] @ bda.T

        if cfg.gt_format == "openoccupancy":
            from .pipelines.load_occupancy import (
                load_openoccupancy_gt, visible_mask_camera,
                visible_mask_lidar)
            dense, occ_world, trans_vox, _ = load_openoccupancy_gt(
                self.occ_path, info["scene_token"], info["lidar_token"],
                cfg.occ_size, cfg.point_cloud_range, bda,
                return_coords=True)
            out["gt_occ"] = dense
            if self.cal_visible:
                vis = visible_mask_lidar(points, cfg.point_cloud_range,
                                         cfg.occ_size)
                if "rots" in out:
                    vis = vis | visible_mask_camera(
                        occ_world, trans_vox, out["rots"], out["trans"],
                        out["intrins"], out["post_rots"], out["post_trans"],
                        cfg.data.input_size, cfg.occ_size)
                out["visible_mask"] = vis
        else:
            token = os.path.basename(info["lidar_path"])
            occ_file = os.path.join(self.occ_path, "samples", f"{token}.npy")
            if os.path.exists(occ_file):
                out["gt_occ"] = load_surroundocc_gt(occ_file, cfg.occ_size)
            else:
                out["gt_occ"] = np.zeros(cfg.occ_size, np.int64)

        # --- lidarseg point labels (points_occ) for the aux readout
        # (reference: LoadOccupancy2 loading.py:233-241 / LoadNuscOccupancy-
        # Annotations loading_nusc_occ.py:16-155; eval coocc_ray.py:556-560)
        lseg = info.get("lidarseg")
        if lseg is not None:
            from ..config.nuscenes import learning_map_array
            path = lseg if os.path.isabs(lseg) \
                else os.path.join(self.data_root, lseg)
            if os.path.exists(path):
                labels = np.fromfile(path, dtype=np.uint8)
                labels = learning_map_array()[labels]
                raw = np.fromfile(info["lidar_path"],
                                  dtype=np.float32).reshape(-1, 5)[:, :3]
                pts_occ = np.concatenate(
                    [raw @ bda.T, labels[:, None].astype(np.float32)], axis=1)
                out["points_occ"], out["points_occ_mask"] = pad_points(
                    pts_occ.astype(np.float32), cfg.points_occ_capacity)

        if cfg.use_lidar:
            cap = cfg.pts.max_points
            out["points"], out["points_mask"] = pad_points(
                points.astype(np.float32), cap)
        return out


def collate(samples, cfg: CoOccConfig):
    """Stack host samples into a Batch of numpy arrays (the ground truth
    int32)."""
    from ..models.coocc_ray import Batch
    keys = set()
    for s in samples:
        keys.update(s.keys())
    kw = {}
    for k in keys:
        kw[k] = np.stack([s[k] for s in samples])
    for k in ("gt_occ", "gt_occ_2"):
        if k in kw:
            kw[k] = kw[k].astype(np.int32)
    return Batch(**kw)


def build_loaders(cfg: CoOccConfig, data_root: str, ann_file: str,
                  val_ann_file: str, occ_path: str, batch_size: int = 1,
                  seed: int = 0, num_workers: int = 2,
                  process_index: Optional[int] = None,
                  process_count: Optional[int] = None):
    """Returns (train_iter_fn, val_iter_fn, steps_per_epoch) backed by the
    threaded prefetch loader with per-rank sharding (data/loader.py):
    batch_size rows a batch on this rank, which reads its own shard
    (process_index of process_count; the default process group's rank
    and world when not given). steps_per_epoch is the training set's
    length over the global batch (batch_size x process_count), as JAX's
    over its global batch."""
    from .loader import prefetch_batches, rank_and_world

    process_index, process_count = rank_and_world(process_index,
                                                  process_count)
    train_ds = NuScenesOccDataset(cfg, data_root, ann_file, occ_path,
                                  is_train=True)
    val_ds = NuScenesOccDataset(cfg, data_root, val_ann_file, occ_path,
                                is_train=False)
    steps = len(train_ds) // (batch_size * process_count)
    epoch_box = {"train": 0}
    shard = dict(seed=seed, num_workers=num_workers,
                 process_index=process_index, process_count=process_count)

    def train_iter():
        e = epoch_box["train"]
        epoch_box["train"] += 1
        return prefetch_batches(train_ds, cfg, batch_size, epoch=e,
                                is_train=True, **shard)

    def val_iter():
        return prefetch_batches(val_ds, cfg, batch_size, epoch=0,
                                is_train=False, **shard)

    return train_iter, val_iter, steps
