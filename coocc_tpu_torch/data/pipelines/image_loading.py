"""Multi-view image loading + augmentation with homography bookkeeping.

A numpy copy of coocc_tpu/data/pipelines/image_loading.py (reference
LoadMultiViewImageFromFiles_OccFormer, loading_nusc_imgs.py:25-221):
per-camera resize/crop/flip/rotate augmentation accumulated into (post_rot,
post_tran) so the LSS geometry can undo it; images scaled to [0, 1] (not
ImageNet-normalized, :188); rots/trans are sensor->lidar from the inverse
lidar2cam. The random draws come from the RandomState passed in, in JAX's
order.

One split: the post-homography (`post_homography`) depends on the
augmentation alone, not on pixels, so the LiDAR-only configs' camera-free
geometry (data/nuscenes_dataset.py:camera_free_geometry) computes it
without an image. PIL is imported inside the functions that touch pixels
(`img_transform`, `load_multi_view_images`, `load_image`); without PIL
they raise ImportError.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def pil_image():
    """PIL.Image, or ImportError naming what needs it; every use of PIL by
    the data path comes through here, and is counted in
    `pil_image.calls`."""
    pil_image.calls += 1
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "the camera configs' image path (decoding and augmenting camera "
            "images) needs PIL (Pillow), which is not installed; the "
            "LiDAR-only configs (coocc_lidar) read no image") from e
    return Image


pil_image.calls = 0


def get_rot2(h: float) -> np.ndarray:
    return np.array([[np.cos(h), np.sin(h)],
                     [-np.sin(h), np.cos(h)]], np.float32)


def sample_augmentation(H: int, W: int, data_cfg, is_train: bool,
                        rng: Optional[np.random.RandomState] = None,
                        flip=None, scale=None):
    """Returns (resize, resize_dims, crop, flip, rotate).

    Reference: loading_nusc_imgs.py:88-111.
    """
    rng = rng or np.random
    fH, fW = data_cfg.input_size
    if is_train:
        resize = float(fW) / float(W)
        resize += rng.uniform(*data_cfg.resize)
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - rng.uniform(*data_cfg.crop_h)) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = bool(data_cfg.flip) and bool(rng.choice([0, 1]))
        rotate = rng.uniform(*data_cfg.rot)
    else:
        resize = float(fW) / float(W) + data_cfg.resize_test
        if scale is not None:
            resize = scale
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - np.mean(data_cfg.crop_h)) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = False if flip is None else flip
        rotate = 0.0
    return resize, resize_dims, crop, flip, rotate


def post_homography(resize, crop, flip, rotate):
    """The augmentation's image-plane homography: (post_rot2 [2, 2],
    post_tran2 [2]), as img_transform accumulates it (JAX
    image_loading.py:64-77)."""
    post_rot = np.eye(2, dtype=np.float32) * resize
    post_tran = -np.array(crop[:2], np.float32)
    if flip:
        A = np.array([[-1, 0], [0, 1]], np.float32)
        b = np.array([crop[2] - crop[0], 0], np.float32)
        post_rot = A @ post_rot
        post_tran = A @ post_tran + b
    A = get_rot2(rotate / 180 * np.pi)
    b = np.array([crop[2] - crop[0], crop[3] - crop[1]], np.float32) / 2
    b = A @ (-b) + b
    post_rot = A @ post_rot
    post_tran = A @ post_tran + b
    return post_rot, post_tran


def img_transform(img, resize, resize_dims, crop, flip, rotate):
    """Apply PIL transforms and return (img, post_rot2 [2,2], post_tran2 [2])."""
    Image = pil_image()
    img = img.resize(resize_dims)
    img = img.crop(crop)
    if flip:
        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    img = img.rotate(rotate)
    return (img,) + post_homography(resize, crop, flip, rotate)


def load_image(data_path):
    """A camera's image: a file path (decoded to RGB) or an array."""
    Image = pil_image()
    return Image.open(data_path).convert("RGB") \
        if isinstance(data_path, str) else Image.fromarray(data_path)


def load_multi_view_images(cam_infos: Dict[str, Dict], data_cfg,
                           is_train: bool,
                           rng: Optional[np.random.RandomState] = None):
    """cam_infos: {cam_name: {data_path, cam_intrinsic, lidar2cam}}.

    Returns dict of stacked numpy arrays: imgs [N, H, W, 3] in [0,1],
    rots/trans (sensor->lidar), intrins, post_rots [N,3,3], post_trans [N,3].
    """
    imgs, rots, trans, intrins, post_rots, post_trans = [], [], [], [], [], []
    for cam_name in data_cfg.cams:
        cam = cam_infos[cam_name]
        img = load_image(cam["data_path"])
        intrin = np.asarray(cam["cam_intrinsic"], np.float32)
        sensor2lidar = np.linalg.inv(np.asarray(cam["lidar2cam"], np.float64))
        rot = sensor2lidar[:3, :3].astype(np.float32)
        tran = sensor2lidar[:3, 3].astype(np.float32)

        augs = sample_augmentation(img.height, img.width, data_cfg, is_train,
                                   rng)
        resize, resize_dims, crop, flip, rotate = augs
        img, pr2, pt2 = img_transform(img, resize, resize_dims, crop, flip,
                                      rotate)
        post_rot = np.eye(3, dtype=np.float32)
        post_tran = np.zeros(3, np.float32)
        post_rot[:2, :2] = pr2
        post_tran[:2] = pt2

        imgs.append(np.asarray(img, np.float32) / 255.0)
        rots.append(rot)
        trans.append(tran)
        intrins.append(intrin)
        post_rots.append(post_rot)
        post_trans.append(post_tran)

    return {
        "imgs": np.stack(imgs),
        "rots": np.stack(rots),
        "trans": np.stack(trans),
        "intrins": np.stack(intrins),
        "post_rots": np.stack(post_rots),
        "post_trans": np.stack(post_trans),
    }
