"""The shipped config names, reproduced with the reference's exact knobs.

A copy of the two configs of coocc_tpu/config/configs.py that the
benchmark runs (a later configuration copies its own). `compute_dtype`
picks the model dtype where the JAX CLIs pick it.

Reference config files (projects/configs/coocc_nusc/):
  coocc_multi_r50_256x704.py, coocc_lidar.py
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
