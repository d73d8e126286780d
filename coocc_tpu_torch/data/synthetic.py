"""Synthetic sample generation: tiny configs and random batches.

A copy of coocc_tpu/data/synthetic.py: the same seed gives arrays
bit-identical to the reference's (tests/test_torch_data.py), so the two
packages can be fed one batch. The arrays are numpy; `Batch.to(device)`
(models/coocc_ray.py) moves them onto torch tensors. Geometry is consistent
(cameras on a ring looking outward, LiDAR points inside the pc range) so
splat, fusion and the cascade all see realistic occupancy.
"""
from __future__ import annotations

import numpy as np

from ..config.base import (
    CoOccConfig, DataConfig, FuserConfig, GridConfig, ImageBackboneConfig,
    ImageNeckConfig, LSSConfig, OccHeadConfig, PtsBranchConfig, RenderConfig,
    SemanticEncoderConfig,
)


def tiny_config(use_camera=True, use_lidar=True, num_classes=17,
                cascade=True, stereo=False) -> CoOccConfig:
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
        lss=LSSConfig(
            downsample=16, stereo=stereo,
            # dbound (1, 9, 0.5): four contiguous 2m ranges
            stereo_range_list=((1, 3), (3, 5), (5, 7), (7, 9)),
            stereo_em_iteration=1,
            stereo_num_groups=8) if use_camera else None,
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


def camera_ring(n_cams: int, rng: np.random.RandomState):
    """Outward-looking cameras evenly spaced on a ring (cam z = forward)."""
    rots, trans = [], []
    for i in range(n_cams):
        yaw = 2 * np.pi * i / n_cams
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        # camera frame: x right, y down, z forward; R maps cam -> ego
        R = np.stack([right, -up, fwd], axis=1)
        rots.append(R)
        trans.append(fwd * 0.5)
    return np.stack(rots).astype(np.float32), np.stack(trans).astype(np.float32)


def synthetic_batch(cfg: CoOccConfig, batch_size: int = 1, seed: int = 0):
    """Build a Batch of numpy arrays consistent with cfg's shapes."""
    from ..models.coocc_ray import Batch

    rng = np.random.RandomState(seed)
    B = batch_size
    kw = {}

    if cfg.use_camera:
        N = cfg.data.num_cams
        H, W = cfg.data.input_size
        kw["imgs"] = rng.rand(B, N, H, W, 3).astype(np.float32)
        rots, trans = camera_ring(N, rng)
        kw["rots"] = np.broadcast_to(rots, (B, N, 3, 3)).copy()
        kw["trans"] = np.broadcast_to(trans, (B, N, 3)).copy()
        intr = np.zeros((3, 3), np.float32)
        f = W  # wide-ish FOV
        intr[0, 0] = f * 0.6
        intr[1, 1] = f * 0.6
        intr[0, 2] = (W - 1) / 2
        intr[1, 2] = (H - 1) / 2
        intr[2, 2] = 1.0
        kw["intrins"] = np.broadcast_to(intr, (B, N, 3, 3)).copy()
        kw["post_rots"] = np.broadcast_to(np.eye(3, dtype=np.float32),
                                          (B, N, 3, 3)).copy()
        kw["post_trans"] = np.zeros((B, N, 3), np.float32)
        kw["bda"] = np.broadcast_to(np.eye(3, dtype=np.float32),
                                    (B, 3, 3)).copy()
        # z-buffer-like sparse LiDAR depth: ~2% pixel density with values
        # inside [d0, d1) so the downsampled patch-min lands in the depth-bin
        # range and the depth losses see real foreground (a dense near-zero
        # map makes every patch-min fall below d0 -> loss_depth == 0)
        depth = rng.uniform(cfg.grid.dbound[0], cfg.grid.dbound[1],
                            (B, N, H, W))
        depth = depth * (rng.rand(B, N, H, W) > 0.98)
        kw["gt_depths"] = depth.astype(np.float32)
        if cfg.lss is not None and cfg.lss.stereo:
            # previous keyframe: same ring, small forward ego motion
            kw["imgs_prev"] = rng.rand(B, N, H, W, 3).astype(np.float32)
            yaw = 0.02
            Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                           [np.sin(yaw), np.cos(yaw), 0],
                           [0, 0, 1]], np.float32)
            # key-cam -> prev-cam: R_prev^-1 @ (R_ego @ R_key), translation
            # from a 0.5 m ego step expressed in the prev camera frame
            step = np.array([0.5, 0.0, 0.0], np.float32)
            k2s_r = np.einsum("nij,jk,nkl->nil",
                              rots.transpose(0, 2, 1), Rz, rots)
            k2s_t = np.einsum("nij,j->ni", rots.transpose(0, 2, 1),
                              step)
            kw["k2s_rots"] = np.broadcast_to(
                k2s_r.astype(np.float32), (B, N, 3, 3)).copy()
            kw["k2s_trans"] = np.broadcast_to(
                k2s_t.astype(np.float32), (B, N, 3)).copy()
    else:
        # the lidar-only model still renders depth from gt_depths geometry
        N = cfg.data.num_cams
        H, W = cfg.data.input_size
        rots, trans = camera_ring(N, rng)
        kw["rots"] = np.broadcast_to(rots, (B, N, 3, 3)).copy()
        kw["trans"] = np.broadcast_to(trans, (B, N, 3)).copy()
        intr = np.zeros((3, 3), np.float32)
        intr[0, 0] = W * 0.6
        intr[1, 1] = W * 0.6
        intr[0, 2] = (W - 1) / 2
        intr[1, 2] = (H - 1) / 2
        intr[2, 2] = 1.0
        kw["intrins"] = np.broadcast_to(intr, (B, N, 3, 3)).copy()
        kw["post_rots"] = np.broadcast_to(np.eye(3, dtype=np.float32),
                                          (B, N, 3, 3)).copy()
        kw["post_trans"] = np.zeros((B, N, 3), np.float32)
        kw["bda"] = np.broadcast_to(np.eye(3, dtype=np.float32),
                                    (B, 3, 3)).copy()
        depth = rng.uniform(cfg.grid.dbound[0], cfg.grid.dbound[1],
                            (B, N, H, W))
        depth = depth * (rng.rand(B, N, H, W) > 0.98)
        kw["gt_depths"] = depth.astype(np.float32)

    if cfg.use_lidar:
        P = cfg.pts.max_points
        pcr = cfg.point_cloud_range
        n_real = int(P * 0.7)
        pts = np.zeros((B, P, 5), np.float32)
        pts[:, :n_real, 0] = rng.uniform(pcr[0], pcr[3], (B, n_real))
        pts[:, :n_real, 1] = rng.uniform(pcr[1], pcr[4], (B, n_real))
        pts[:, :n_real, 2] = rng.uniform(pcr[2], pcr[5], (B, n_real))
        pts[:, :n_real, 3:] = rng.rand(B, n_real, 2)
        mask = np.zeros((B, P), bool)
        mask[:, :n_real] = True
        kw["points"] = pts
        kw["points_mask"] = mask

    X, Y, Z = cfg.occ_size
    gt = rng.randint(0, cfg.num_classes, (B, X, Y, Z))
    gt = np.where(rng.rand(B, X, Y, Z) < 0.7, 0, gt)  # mostly free
    gt = np.where(rng.rand(B, X, Y, Z) < 0.02, 255, gt)  # some ignore
    kw["gt_occ"] = gt.astype(np.int32)

    # lidarseg points: (x, y, z, label)
    Q = 2048
    pcr = cfg.point_cloud_range
    po = np.zeros((B, Q, 4), np.float32)
    po[..., 0] = rng.uniform(pcr[0], pcr[3], (B, Q))
    po[..., 1] = rng.uniform(pcr[1], pcr[4], (B, Q))
    po[..., 2] = rng.uniform(pcr[2], pcr[5], (B, Q))
    po[..., 3] = rng.randint(1, cfg.num_classes, (B, Q))
    kw["points_occ"] = po
    kw["points_occ_mask"] = np.ones((B, Q), bool)
    return Batch(**kw)
