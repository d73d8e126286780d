"""The tests' miniature config (a copy of the port's `tiny_config`), so
the reference runs a tiny cell on the CPU."""
from __future__ import annotations

from .base import (
    CoOccConfig, DataConfig, FuserConfig, GridConfig, ImageBackboneConfig,
    ImageNeckConfig, LSSConfig, OccHeadConfig, PtsBranchConfig, RenderConfig,
    SemanticEncoderConfig,
)


def tiny_config(use_camera=True, use_lidar=True, num_classes=17,
                cascade=True) -> CoOccConfig:
    """A miniature but structurally complete config for CPU tests."""
    pc_range = (-10.0, -10.0, -2.0, 10.0, 10.0, 2.0)
    occ_size = (40, 40, 8)
    lss_ds = (2, 2, 2)
    vx = tuple((pc_range[i + 3] - pc_range[i]) / occ_size[i] for i in range(3))
    grid = GridConfig(
        xbound=(pc_range[0], pc_range[3], vx[0] * lss_ds[0]),
        ybound=(pc_range[1], pc_range[4], vx[1] * lss_ds[1]),
        zbound=(pc_range[2], pc_range[5], vx[2] * lss_ds[2]),
        dbound=(1.0, 9.0, 0.5),  # D = 16
    )
    return CoOccConfig(
        name="tiny",
        model_type="COOCC_Ray" if use_camera else "COOCC_Ray_L",
        point_cloud_range=pc_range,
        occ_size=occ_size,
        lss_downsample=lss_ds,
        scale=16,
        use_camera=use_camera,
        use_lidar=use_lidar,
        data=DataConfig(input_size=(64, 192),
                        cams=("CAM_A", "CAM_B")),
        grid=grid,
        # depth=10 (1-block stages): the flagship R50's 4-stage structure
        # at ~1/8 the graph
        img_backbone=ImageBackboneConfig(depth=10) if use_camera else None,
        img_neck=ImageNeckConfig() if use_camera else None,
        lss=LSSConfig(downsample=16) if use_camera else None,
        pts=PtsBranchConfig(
            voxel_size=(0.125, 0.125, 0.125),
            sparse_shape_xyz=(160, 160, 32),
            max_voxels=4096, max_voxels_test=4096, max_points=8192,
        ) if use_lidar else None,
        # narrow window; the tiny grid fits inside it anyway
        fuser=FuserConfig(window_rx=4, window_ry=4, window_rz=7)
        if (use_camera and use_lidar) else None,
        semantic=SemanticEncoderConfig(
            block_inplanes=(32, 64, 128, 256), neck_out_channels=64,
            neck_with_cp=False),
        occ_head=OccHeadConfig(
            in_channels=(64, 64, 64, 64), out_channel=num_classes,
            cascade_ratio=2 if cascade else 1,
            sample_from_voxel=cascade, sample_from_img=cascade and use_camera,
            final_occ_size=occ_size, fine_topk=256, max_coarse_occupied=512,
            point_cloud_range=pc_range, input_size=(64, 192),
        ),
        render=RenderConfig(
            use_rendering=True,
            render_xbound=(pc_range[0], pc_range[3], 0.5),
            render_ybound=(pc_range[1], pc_range[4], 0.5),
            render_zbound=(pc_range[2], pc_range[5], 0.5),
        ),
    )
