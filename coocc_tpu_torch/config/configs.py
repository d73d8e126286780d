"""The shipped config names, reproduced with the reference's exact knobs.

A copy of coocc_tpu/config/configs.py (tests/test_torch_data.py pins every
registered config equal across the two packages). `compute_dtype` is read by
no code of the port yet: its forward computes in fp32.

Reference config files (projects/configs/coocc_nusc/):
  coocc_lidar.py, coocc_cam_r101_896x1600.py, coocc_multi_r50_256x704.py,
  coocc_multi_r101_896x1600.py, coocc_multi_r101_openoccupancy.py
Key deltas verified by diff (SURVEY §2.6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from .base import (
    CoOccConfig, DataConfig, FuserConfig, GridConfig, ImageBackboneConfig,
    ImageNeckConfig, LSSConfig, OccHeadConfig, PtsBranchConfig, RenderConfig,
    SECOND3DConfig, SemanticEncoderConfig,
)

_REGISTRY: Dict[str, Callable[[], CoOccConfig]] = {}


def register(fn: Callable[[], CoOccConfig]) -> Callable[[], CoOccConfig]:
    _REGISTRY[fn.__name__] = fn
    return fn


def get_config(name: str, **overrides) -> CoOccConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown config '{name}'; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def list_configs():
    return sorted(_REGISTRY)


def _grid(pc_range, occ_size, lss_downsample) -> GridConfig:
    vx = tuple((pc_range[i + 3] - pc_range[i]) / occ_size[i] for i in range(3))
    return GridConfig(
        xbound=(pc_range[0], pc_range[3], vx[0] * lss_downsample[0]),
        ybound=(pc_range[1], pc_range[4], vx[1] * lss_downsample[1]),
        zbound=(pc_range[2], pc_range[5], vx[2] * lss_downsample[2]),
        dbound=(2.0, 58.0, 0.5),
    )


@register
def coocc_multi_r50_256x704() -> CoOccConfig:
    pc_range = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    occ_size = (200, 200, 16)
    lss_ds = (2, 2, 2)
    return CoOccConfig(
        name="coocc_multi_r50_256x704",
        compute_dtype="bfloat16",
        model_type="COOCC_Ray",
        point_cloud_range=pc_range,
        occ_size=occ_size,
        lss_downsample=lss_ds,
        scale=16,
        data=DataConfig(input_size=(256, 704)),
        grid=_grid(pc_range, occ_size, lss_ds),
        img_backbone=ImageBackboneConfig(depth=50),
        img_neck=ImageNeckConfig(),
        lss=LSSConfig(downsample=16),
        pts=PtsBranchConfig(
            voxel_size=(0.125, 0.125, 0.125),
            sparse_shape_xyz=(800, 800, 64),
        ),
        fuser=FuserConfig(knum=2),
        semantic=SemanticEncoderConfig(),
        occ_head=OccHeadConfig(
            cascade_ratio=2, sample_from_voxel=True, sample_from_img=True,
            final_occ_size=occ_size, fine_topk=15000,
        ),
        render=RenderConfig(
            N_samples=64, N_rand=4096, near_far_range=(0.2, 100.0),
        ),
    )


@register
def coocc_multi_r50_256x704_stereo() -> CoOccConfig:
    """Flagship + BEVStereo temporal-stereo depth (capability envelope:
    the reference registers ViewTransformerLSSBEVStereo but ships no config
    using it, ViewTransformerLSSBEVDepth.py:938). The dataset feeds the
    previous keyframe per sample (nuscenes_dataset._add_stereo_prev)."""
    base = coocc_multi_r50_256x704()
    return base.replace(
        name="coocc_multi_r50_256x704_stereo",
        lss=dataclasses.replace(base.lss, stereo=True),
    )


@register
def coocc_multi_r101_896x1600() -> CoOccConfig:
    return coocc_multi_r50_256x704().replace(
        name="coocc_multi_r101_896x1600",
        data=DataConfig(input_size=(896, 1600)),
        img_backbone=ImageBackboneConfig(depth=101),
    )


@register
def coocc_multi_r101_openoccupancy() -> CoOccConfig:
    pc_range = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    occ_size = (512, 512, 40)
    lss_ds = (4, 4, 4)
    base = coocc_multi_r50_256x704()
    return base.replace(
        name="coocc_multi_r101_openoccupancy",
        gt_format="openoccupancy",
        point_cloud_range=pc_range,
        occ_size=occ_size,
        lss_downsample=lss_ds,
        scale=4,
        data=DataConfig(input_size=(896, 1600)),
        grid=_grid(pc_range, occ_size, lss_ds),
        img_backbone=ImageBackboneConfig(depth=101),
        pts=PtsBranchConfig(
            voxel_size=(0.1, 0.1, 0.1),
            sparse_shape_xyz=(1024, 1024, 80),
        ),
        # fuser grid here is 128x128x10 @ 0.8 m (vs flagship 100x100x8 @
        # 1.0 m); the window radii are re-derived from measurement at THIS
        # grid (tools/knn_window_missrate.py --grid 128,128,10,0.8, 5
        # seeds): (6,6,7) misses 0.76% img->pts / 0.32% pts->img of
        # in-threshold neighbours, (8,8,9) misses 0.13% / 0.09%,
        # (10,10,9) 0.02% / 0. (8,8,9) matches the flagship's measured
        # sub-1% operating point at ~2x window volume.
        fuser=dataclasses.replace(base.fuser, window_rx=8, window_ry=8,
                                  window_rz=9, window_img_rx=6,
                                  window_img_ry=6, window_img_rz=7),
        occ_head=OccHeadConfig(
            cascade_ratio=4, sample_from_voxel=True, sample_from_img=True,
            final_occ_size=occ_size, fine_topk=15000,
        ),
    )


@register
def coocc_cam_r101_896x1600() -> CoOccConfig:
    base = coocc_multi_r101_896x1600()
    return base.replace(
        name="coocc_cam_r101_896x1600",
        use_lidar=False,
        pts=None,
        fuser=None,
        render=RenderConfig(
            N_samples=64, N_rand=2048, near_far_range=(0.2, 50.0),
        ),
    )


@register
def coocc_kitti() -> CoOccConfig:
    """SemanticKITTI stereo-camera occupancy (capability-envelope config).

    The reference ships SemanticKITTI support (dataset
    semantic_kitti_lss_dataset.py, head variant occ_head_kitti.py — 20
    classes, 2-camera projection, 3x4 intrinsics) without a committed config;
    this config exercises that surface. Grid 256x256x32 @ 0.2 m over
    x [0, 51.2], y [-25.6, 25.6], z [-2, 4.4] (SemanticKITTI convention).
    """
    pc_range = (0.0, -25.6, -2.0, 51.2, 25.6, 4.4)
    occ_size = (256, 256, 32)
    lss_ds = (2, 2, 2)
    return CoOccConfig(
        name="coocc_kitti",
        compute_dtype="bfloat16",
        model_type="COOCC_Ray",
        num_classes=20,
        point_cloud_range=pc_range,
        occ_size=occ_size,
        lss_downsample=lss_ds,
        scale=16,
        data=DataConfig(input_size=(384, 1280),
                        cams=("CAM_LEFT",), src_size=(376, 1241)),
        grid=_grid(pc_range, occ_size, lss_ds),
        img_backbone=ImageBackboneConfig(depth=50),
        img_neck=ImageNeckConfig(),
        # 3x4 KITTI intrinsics -> 30-d camera conditioning vector
        lss=LSSConfig(downsample=16, cam_channels=30),
        pts=PtsBranchConfig(
            voxel_size=(0.1, 0.1, 0.1),
            sparse_shape_xyz=(512, 512, 64),
        ),
        fuser=FuserConfig(knum=2),
        semantic=SemanticEncoderConfig(),
        occ_head=OccHeadConfig(
            out_channel=20, cascade_ratio=2, sample_from_voxel=True,
            sample_from_img=True, final_occ_size=occ_size, fine_topk=15000,
            data_type="kitti", point_cloud_range=pc_range,
            input_size=(384, 1280),
        ),
        render=RenderConfig(N_samples=64, N_rand=2048,
                            near_far_range=(0.2, 50.0)),
    )


@register
def coocc_lidar() -> CoOccConfig:
    pc_range = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    occ_size = (200, 200, 16)
    lss_ds = (2, 2, 2)
    return CoOccConfig(
        name="coocc_lidar",
        compute_dtype="bfloat16",
        model_type="COOCC_Ray_L",
        point_cloud_range=pc_range,
        occ_size=occ_size,
        lss_downsample=lss_ds,
        scale=4,
        use_camera=False,
        data=DataConfig(input_size=(896, 1600)),
        grid=_grid(pc_range, occ_size, lss_ds),
        img_backbone=None,
        img_neck=None,
        lss=None,
        pts=PtsBranchConfig(
            voxel_size=(0.125, 0.125, 0.125),
            encoder="SparseEncoderHD",
            sparse_shape_xyz=(800, 800, 65),
        ),
        second3d=SECOND3DConfig(),
        fuser=None,
        semantic=SemanticEncoderConfig(),
        occ_head=OccHeadConfig(
            cascade_ratio=2, sample_from_voxel=False, sample_from_img=False,
            final_occ_size=occ_size,
        ),
        render=RenderConfig(
            N_samples=64, N_rand=2048, near_far_range=(0.2, 50.0),
        ),
    )
