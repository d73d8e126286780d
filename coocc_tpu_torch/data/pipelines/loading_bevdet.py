"""BEVDet-style alternative loading pipelines (host-side, pure numpy/PIL).

A numpy copy of coocc_tpu/data/pipelines/loading_bevdet.py, function for
function (tests/test_torch_data_path.py holds it against it); PIL is
imported inside the functions that touch pixels (image_loading.pil_image).
Capability parity with the reference's alternative image-loading path
(datasets/pipelines/loading_bevdet.py:1-531 and multi_view.py:1-311) —
the last §2.2/§2.7 inventory row. No shipped reference config uses these,
but they define the capability envelope: BEVDet-convention loading with
  * ImageNet mean/std normalization via mmcv's imnormalize
    (loading_bevdet.py:14-29) instead of the live loader's /255 scaling,
  * sparse point-depth files transformed through the image augmentation
    into dense per-pixel depth maps (depth_transform, :31-76),
  * random camera subsetting at train time (choose_cams, :148-154),
  * sensor->ego (key/sweep) and sensor->lidar 4x4 chains from quaternion
    info dicts (:183-284),
  * photometric distortion in HSV space (:444-532),
  * BDA (rot/scale/flip) annotation augmentation producing the bda matrix
    the LSS geometry consumes (bev_transform + LoadAnnotationsBEVDepth,
    :379-442),
  * the NeRF-oriented MultiViewPipeline variant that additionally emits
    per-pixel ray origins/directions and camera-to-world poses
    (multi_view.py:112-233, 304-311).

Everything is a plain function over info dicts + numpy arrays (this
framework's pipeline idiom — see image_loading.py); no torch, no
registries. Geometry helpers (sample_augmentation, img_transform) are
shared with the live loader rather than duplicated.

Reference quirks preserved on purpose (documented where they occur):
PIL loads RGB but mmlabNormalize's to_rgb=True assumes BGR and swaps
channels, so the network actually sees BGR-normalized images; the same
swap hits the HSV colorjitter. Behavioral parity keeps both.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .image_loading import (img_transform, load_image, pil_image,
                            sample_augmentation)

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def mmlab_normalize(img, img_norm_cfg: Optional[Dict] = None) -> np.ndarray:
    """ImageNet-normalize an image, replicating mmlabNormalize.

    Reference loading_bevdet.py:14-29: imnormalize(mean, std, to_rgb=True).
    imnormalize's to_rgb flips channel order BEFORE normalizing; the
    reference feeds it a PIL (RGB) array, so the output is channel-swapped
    (BGR) then normalized — preserved here for parity. Returns float32
    [H, W, 3] (this framework keeps HWC; the reference permutes to CHW).
    """
    if img_norm_cfg is None:
        mean, std, to_rgb = IMAGENET_MEAN, IMAGENET_STD, True
    else:
        mean = np.asarray(img_norm_cfg["mean"], np.float32)
        std = np.asarray(img_norm_cfg["std"], np.float32)
        to_rgb = bool(img_norm_cfg["to_rgb"])
    img = np.asarray(img, np.float32)
    if to_rgb:
        img = img[..., ::-1]
    return (img - mean) / std


def depth_transform(cam_depth: np.ndarray, resize: float,
                    resize_dims: Tuple[int, int], crop, flip: bool,
                    rotate: float) -> np.ndarray:
    """Push sparse (x, y, depth) points through the image augmentation and
    rasterize a dense [H, W] depth map.

    Reference loading_bevdet.py:31-76, kept step-for-step: scale, crop
    offset, horizontal flip about resize_dims[1] (the reference indexes the
    (H, W) tuple with [1], i.e. flips about W), rotation about the map
    center, int16 truncation of coordinates, and last-write-wins scatter
    for duplicate pixels.
    """
    cam_depth = np.array(cam_depth, np.float32, copy=True)
    H, W = resize_dims
    cam_depth[:, :2] *= resize
    cam_depth[:, 0] -= crop[0]
    cam_depth[:, 1] -= crop[1]
    if flip:
        cam_depth[:, 0] = resize_dims[1] - cam_depth[:, 0]

    cam_depth[:, 0] -= W / 2.0
    cam_depth[:, 1] -= H / 2.0
    h = rotate / 180.0 * np.pi
    rot = np.array([[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]],
                   np.float32)
    cam_depth[:, :2] = (rot @ cam_depth[:, :2].T).T
    cam_depth[:, 0] += W / 2.0
    cam_depth[:, 1] += H / 2.0

    coords = cam_depth[:, :2].astype(np.int16)
    depth_map = np.zeros((H, W), np.float32)
    valid = ((coords[:, 1] < H) & (coords[:, 0] < W)
             & (coords[:, 1] >= 0) & (coords[:, 0] >= 0))
    depth_map[coords[valid, 1], coords[valid, 0]] = cam_depth[valid, 2]
    return depth_map


# --- HSV colorjitter -------------------------------------------------------

def _bgr2hsv(img: np.ndarray) -> np.ndarray:
    """cv2-convention float32 BGR->HSV: H in [0,360), S in [0,1], V = max."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    diff = v - mn
    safe = np.where(diff == 0, 1.0, diff)
    h = np.where(
        v == r, 60.0 * (g - b) / safe,
        np.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                 240.0 + 60.0 * (r - g) / safe))
    h = np.where(diff == 0, 0.0, h)
    h = np.where(h < 0, h + 360.0, h)
    s = np.where(v == 0, 0.0, diff / np.where(v == 0, 1.0, v))
    return np.stack([h, s, v], -1)


def _hsv2bgr(img: np.ndarray) -> np.ndarray:
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    h = (h % 360.0) / 60.0
    i = np.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([b, g, r], -1)


def photometric_distortion(img,
                           rng: Optional[np.random.RandomState] = None,
                           brightness_delta: float = 32.0,
                           contrast_range: Tuple[float, float] = (0.5, 1.5),
                           saturation_range: Tuple[float, float] = (0.5, 1.5),
                           hue_delta: float = 18.0):
    """PhotoMetricDistortionMultiViewImage (loading_bevdet.py:444-532).

    Each op fires with p=0.5: brightness shift, contrast scale (before or
    after the HSV block), saturation scale, hue shift, channel permutation.
    The reference runs cv2's BGR<->HSV on what is actually an RGB array;
    numerically that just relabels which channels play the B/R roles, and
    the final channel-permutation op erases any fixed naming anyway.

    Divergence from the reference, copied from JAX's
    (coocc_tpu/data/pipelines/loading_bevdet.py:170): the result is
    clipped to [0, 255] before its uint8 cast; the reference casts
    without clipping, so its out-of-range values wrap modulo 256.
    """
    rng = rng or np.random
    arr = np.asarray(img, np.float32)
    if rng.randint(2):
        arr = arr + rng.uniform(-brightness_delta, brightness_delta)
    mode = rng.randint(2)
    if mode == 1 and rng.randint(2):
        arr = arr * rng.uniform(*contrast_range)
    hsv = _bgr2hsv(arr)
    if rng.randint(2):
        hsv[..., 1] *= rng.uniform(*saturation_range)
    if rng.randint(2):
        hsv[..., 0] += rng.uniform(-hue_delta, hue_delta)
        hsv[..., 0][hsv[..., 0] > 360] -= 360
        hsv[..., 0][hsv[..., 0] < 0] += 360
    arr = _hsv2bgr(hsv)
    if mode == 0 and rng.randint(2):
        arr = arr * rng.uniform(*contrast_range)
    if rng.randint(2):
        arr = arr[..., rng.permutation(3)]
    return pil_image().fromarray(np.clip(arr, 0, 255).astype(np.uint8))


# --- pose chains -----------------------------------------------------------

def quat_to_rot(wxyz: Sequence[float]) -> np.ndarray:
    """Unit-quaternion (w, x, y, z) -> 3x3 rotation (pyquaternion order)."""
    w, x, y, z = (float(v) for v in wxyz)
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _pose44(rot_quat, tran) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = quat_to_rot(rot_quat)
    m[:3, 3] = np.asarray(tran, np.float64)
    return m


def rotation_translation_to_pose(r_quat, t_vec) -> np.ndarray:
    """multi_view.py:10-22: (w,x,y,z) quaternion + translation -> 4x4."""
    return _pose44(r_quat, t_vec)


def sensor2ego_transformation(cam_info: Dict, key_info: Dict,
                              cam_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(sweep sensor -> key ego, key sensor -> sweep sensor) 4x4 pair.

    Reference loading_bevdet.py:183-234: composes
    sweepsensor->sweepego->global->keyego (and its key-sensor inverse
    chain) from the per-camera quaternion info entries.
    """
    cam = cam_info["cams"][cam_name]
    sweepsensor2sweepego = _pose44(cam["sensor2ego_rotation"],
                                   cam["sensor2ego_translation"])
    sweepego2global = _pose44(cam["ego2global_rotation"],
                              cam["ego2global_translation"])
    key = key_info["cams"][cam_name]
    keyego2global = _pose44(key["ego2global_rotation"],
                            key["ego2global_translation"])
    global2keyego = np.linalg.inv(keyego2global)
    keysensor2keyego = _pose44(key["sensor2ego_rotation"],
                               key["sensor2ego_translation"])
    keyego2keysensor = np.linalg.inv(keysensor2keyego)
    keysensor2sweepsensor = np.linalg.inv(
        keyego2keysensor @ global2keyego @ sweepego2global
        @ sweepsensor2sweepego)
    sweepsensor2keyego = (global2keyego @ sweepego2global
                          @ sweepsensor2sweepego)
    return sweepsensor2keyego, keysensor2sweepsensor


def sensor2lidar_transformation(cam_info: Dict, cam_name: str,
                                sample_info: Dict) -> np.ndarray:
    """Camera sensor -> lidar 4x4 (loading_bevdet.py:236-284)."""
    cam = cam_info["cams"][cam_name]
    sweepsensor2sweepego = _pose44(cam["sensor2ego_rotation"],
                                   cam["sensor2ego_translation"])
    sweepego2global = _pose44(cam["ego2global_rotation"],
                              cam["ego2global_translation"])
    global2lidarego = np.linalg.inv(_pose44(
        sample_info["ego2global_rotation"],
        sample_info["ego2global_translation"]))
    ego2lidar = np.linalg.inv(_pose44(sample_info["lidar2ego_rotation"],
                                      sample_info["lidar2ego_translation"]))
    return (ego2lidar @ global2lidarego @ sweepego2global
            @ sweepsensor2sweepego)


# --- BDA annotation augmentation ------------------------------------------

def bev_transform(rotate_angle: float, scale_ratio: float, flip_dx: bool,
                  flip_dy: bool) -> np.ndarray:
    """3x3 BDA matrix: flip @ (scale @ rot). loading_bevdet.py:379-393."""
    h = rotate_angle / 180.0 * np.pi
    rot = np.array([[np.cos(h), -np.sin(h), 0],
                    [np.sin(h), np.cos(h), 0],
                    [0, 0, 1]], np.float32)
    scale = np.eye(3, dtype=np.float32) * scale_ratio
    flip = np.eye(3, dtype=np.float32)
    if flip_dx:
        flip = flip @ np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
    if flip_dy:
        flip = flip @ np.diag([1.0, -1.0, 1.0]).astype(np.float32)
    return flip @ (scale @ rot)


def sample_bda_augmentation(bda_aug_conf: Dict, is_train: bool,
                            rng: Optional[np.random.RandomState] = None):
    """loading_bevdet.py:411-423 — (rotate, scale, flip_dx, flip_dy)."""
    rng = rng or np.random
    if is_train:
        return (rng.uniform(*bda_aug_conf["rot_lim"]),
                rng.uniform(*bda_aug_conf["scale_lim"]),
                bool(rng.uniform() < bda_aug_conf["flip_dx_ratio"]),
                bool(rng.uniform() < bda_aug_conf["flip_dy_ratio"]))
    return 0.0, 1.0, False, False


def load_annotations_bevdepth(sample: Dict, bda_aug_conf: Dict,
                              is_train: bool = True,
                              rng: Optional[np.random.RandomState] = None
                              ) -> Dict:
    """LoadAnnotationsBEVDepth (loading_bevdet.py:396-442), functional form.

    Samples a BDA augmentation, rotates the point cloud by it, and attaches
    `bda` to the sample (the reference rewires its img_inputs tuple from 8
    to 10 entries; this framework's Batch carries bda as a named field).
    """
    rot_bda, scale_bda, flip_dx, flip_dy = sample_bda_augmentation(
        bda_aug_conf, is_train, rng)
    bda_rot = bev_transform(rot_bda, scale_bda, flip_dx, flip_dy)
    out = dict(sample)
    out["bda"] = bda_rot
    if out.get("points") is not None:
        pts = np.array(out["points"], np.float32, copy=True)
        pts[:, :3] = pts[:, :3] @ bda_rot.T
        out["points"] = pts
    return out


# --- ray directions (MultiViewPipeline) ------------------------------------

def get_ray_direction_with_intrinsics(h: int, w: int,
                                      intrin: np.ndarray) -> np.ndarray:
    """Per-pixel camera-frame ray directions, OpenGL z=-1 convention.

    multi_view.py:304-311: dir = ((i-cx)/fx, (j-cy)/fy, -1) per pixel.
    """
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    fx, fy = float(intrin[0, 0]), float(intrin[1, 1])
    cx, cy = float(intrin[0, 2]), float(intrin[1, 2])
    return np.stack([(i - cx) / fx, (j - cy) / fy, -np.ones_like(i)], -1)


# --- the two loader entry points -------------------------------------------

def choose_cams(data_cfg, is_train: bool, n_cams: Optional[int] = None,
                rng: Optional[np.random.RandomState] = None):
    """Random camera subset at train when Ncams < len(cams) (:148-154)."""
    rng = rng or np.random
    if is_train and n_cams is not None and n_cams < len(data_cfg.cams):
        return list(rng.choice(list(data_cfg.cams), n_cams, replace=False))
    return list(data_cfg.cams)


def load_multi_view_images_bevdet(
        cam_infos: Dict[str, Dict], data_cfg, is_train: bool,
        rng: Optional[np.random.RandomState] = None,
        img_norm_cfg: Optional[Dict] = None,
        colorjitter: bool = False,
        depth_points: Optional[Dict[str, np.ndarray]] = None,
        n_cams: Optional[int] = None) -> Dict[str, np.ndarray]:
    """LoadMultiViewImageFromFiles_BEVDet.get_inputs (:286-372).

    cam_infos: {cam_name: {data_path | array, cam_intrinsic, lidar2cam}}.
    depth_points: optional {cam_name: [N, 3] (x, y, depth)} sparse GT depth
    (the reference reads `<img>.bin` files from depth_gt_path); when given,
    each is pushed through the augmentation into a dense per-pixel map.

    Returns stacked numpy arrays: imgs [N, H, W, 3] ImageNet-normalized
    (channel-swapped, see mmlab_normalize), rots/trans (sensor->lidar),
    intrins, post_rots/post_trans [N, 3, 3]/[N, 3], gt_depths [N, H, W],
    sensor2sensors [N, 4, 4], canvas [N, H, W, 3] uint8 (pre-normalize).

    Divergence from the reference, copied from JAX's
    (coocc_tpu/data/pipelines/loading_bevdet.py:355): each camera samples
    its own train-time flip. The reference rebinds `flip` from each
    camera's augmentation and passes it into the next camera's
    sample_augmentation, so one camera's flip carries into the next;
    eval (no flip) is the same either way.
    """
    rng = rng or np.random
    names = choose_cams(data_cfg, is_train, n_cams, rng)
    fH, fW = data_cfg.input_size
    out = {k: [] for k in ("imgs", "rots", "trans", "intrins", "post_rots",
                           "post_trans", "gt_depths", "sensor2sensors",
                           "canvas")}
    for cam_name in names:
        cam = cam_infos[cam_name]
        img = load_image(cam["data_path"])
        intrin = np.asarray(cam["cam_intrinsic"], np.float32)
        sensor2lidar = np.linalg.inv(np.asarray(cam["lidar2cam"],
                                                np.float64))
        augs = sample_augmentation(img.height, img.width, data_cfg,
                                   is_train, rng)
        resize, resize_dims, crop, flip, rotate = augs
        img, pr2, pt2 = img_transform(img, resize, resize_dims, crop, flip,
                                      rotate)
        post_rot = np.eye(3, dtype=np.float32)
        post_tran = np.zeros(3, np.float32)
        post_rot[:2, :2] = pr2
        post_tran[:2] = pt2

        if depth_points is not None and cam_name in depth_points:
            out["gt_depths"].append(depth_transform(
                depth_points[cam_name], resize, (fH, fW), crop, flip,
                rotate))
        else:
            out["gt_depths"].append(np.zeros((fH, fW), np.float32))

        out["canvas"].append(np.asarray(img, np.uint8))
        if colorjitter and is_train:
            img = photometric_distortion(img, rng)
        out["imgs"].append(mmlab_normalize(img, img_norm_cfg))
        out["intrins"].append(intrin)
        out["rots"].append(sensor2lidar[:3, :3].astype(np.float32))
        out["trans"].append(sensor2lidar[:3, 3].astype(np.float32))
        out["post_rots"].append(post_rot)
        out["post_trans"].append(post_tran)
        out["sensor2sensors"].append(sensor2lidar.astype(np.float32))
    return {k: np.stack(v) for k, v in out.items()}


def multi_view_pipeline(cam_infos: Dict[str, Dict], data_cfg,
                        is_train: bool,
                        rng: Optional[np.random.RandomState] = None,
                        img_norm_cfg: Optional[Dict] = None
                        ) -> Dict[str, np.ndarray]:
    """MultiViewPipeline.get_inputs (multi_view.py:112-233).

    The NeRF-oriented loader: everything the BEVDet loader emits plus
    per-pixel ray directions rotated into the world frame (raydirs), ray
    origins (lightpos = cam2world translation broadcast per pixel), and
    the camera-to-world 4x4 poses (c2ws) built from the per-camera
    sensor2ego/ego2global quaternions.
    """
    rng = rng or np.random
    base = load_multi_view_images_bevdet(cam_infos, data_cfg, is_train,
                                         rng, img_norm_cfg)
    names = list(data_cfg.cams)
    fH, fW = data_cfg.input_size
    raydirs, lightpos, c2ws = [], [], []
    for n, cam_name in enumerate(names):
        cam = cam_infos[cam_name]
        cam_pose = rotation_translation_to_pose(
            cam["sensor2ego_rotation"], cam["sensor2ego_translation"])
        ego_pose = rotation_translation_to_pose(
            cam["ego2global_rotation"], cam["ego2global_translation"])
        c2w = ego_pose @ cam_pose
        dirs = get_ray_direction_with_intrinsics(
            fH, fW, np.asarray(cam["cam_intrinsic"], np.float32))
        rays_d = np.sum(dirs[..., np.newaxis, :] * c2w[:3, :3], -1)
        rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
        raydirs.append(rays_d.astype(np.float32))
        lightpos.append(np.array(rays_o, np.float32))
        c2ws.append(c2w.astype(np.float32))
    base["raydirs"] = np.stack(raydirs)
    base["lightpos"] = np.stack(lightpos)
    base["c2ws"] = np.stack(c2ws)
    return base
