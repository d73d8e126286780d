"""Config system: plain frozen dataclasses (replacement for mmcv Config).

A field-for-field copy of coocc_tpu/config/base.py, so both packages read the
same configs (tests/test_torch_data.py pins the two equal). The reference
drives everything through mmcv python-dict configs with registry string
indirection (projects/configs/coocc_nusc/*.py); here the same knob surface is
expressed as typed dataclasses; the shipped config names are reproduced in
`coocc_tpu_torch.config.configs`.

Every dynamic structure in the reference (voxel counts, active-voxel lists,
fine-coordinate sets) becomes a fixed capacity + validity mask chosen from the
reference's own caps (max_voxels 90k/120k, fine_topk 15000).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


def _t(x):
    return tuple(x)


@dataclass(frozen=True)
class GridConfig:
    """LSS voxel grid bounds: [min, max, step] per axis + depth bins.

    Reference: grid_config in coocc_multi_r50_256x704.py:49-54.
    """
    xbound: Tuple[float, float, float] = (-50.0, 50.0, 1.0)
    ybound: Tuple[float, float, float] = (-50.0, 50.0, 1.0)
    zbound: Tuple[float, float, float] = (-5.0, 3.0, 1.0)
    dbound: Tuple[float, float, float] = (2.0, 58.0, 0.5)

    @property
    def dx(self) -> Tuple[float, float, float]:
        return (self.xbound[2], self.ybound[2], self.zbound[2])

    @property
    def bx(self) -> Tuple[float, float, float]:
        return tuple(b[0] + b[2] / 2.0 for b in (self.xbound, self.ybound, self.zbound))

    @property
    def nx(self) -> Tuple[int, int, int]:
        return tuple(
            int(round((b[1] - b[0]) / b[2]))
            for b in (self.xbound, self.ybound, self.zbound)
        )

    @property
    def num_depth_bins(self) -> int:
        lo, hi, step = self.dbound
        return int(round((hi - lo) / step))


@dataclass(frozen=True)
class DataConfig:
    """Camera/image data layout. Reference: data_config coocc_multi_r50_256x704.py:34-47."""
    cams: Tuple[str, ...] = (
        "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
        "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT",
    )
    input_size: Tuple[int, int] = (256, 704)  # (H, W)
    src_size: Tuple[int, int] = (900, 1600)
    resize: Tuple[float, float] = (0.0, 0.0)
    rot: Tuple[float, float] = (0.0, 0.0)
    flip: bool = False
    crop_h: Tuple[float, float] = (0.0, 0.0)
    resize_test: float = 0.0

    @property
    def num_cams(self) -> int:
        return len(self.cams)


@dataclass(frozen=True)
class ImageBackboneConfig:
    """2D image backbone. Reference config: coocc_multi_r50_256x704.py:97-106.

    type selects ResNet (the live configs) or SwinTransformer (the
    reference's registered alternative, swintransformer.py:465)."""
    type: str = "ResNet"                # "ResNet" | "SwinTransformer"
    depth: int = 50                     # 50 or 101 (ResNet)
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    frozen_stages: int = 0
    norm_eval: bool = False
    # Swin knobs (Swin-T defaults)
    embed_dims: int = 96
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7


@dataclass(frozen=True)
class ImageNeckConfig:
    """SECONDFPN over ResNet stages. Reference: coocc_multi_r50_256x704.py:107-111."""
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    upsample_strides: Tuple[float, ...] = (0.25, 0.5, 1.0, 2.0)
    out_channels: Tuple[int, ...] = (128, 128, 128, 128)


@dataclass(frozen=True)
class LSSConfig:
    """Lift-splat view transformer + camera-aware DepthNet.

    Reference: ViewTransformerLiftSplatShootVoxel (ViewTransformerLSSVoxel.py:15)
    over ViewTransformerLSSBEVDepth (ViewTransformerLSSBEVDepth.py:609).
    """
    numC_input: int = 512
    numC_Trans: int = 128
    downsample: int = 16                # image stride of the frustum features
    cam_channels: int = 27
    loss_depth_weight: float = 1.0
    loss_depth_type: str = "bce"        # 'bce' | 'kld'
    # --- temporal-stereo depth (BEVStereo path, nn/lss_stereo.py). The
    # reference registers ViewTransformerLSSBEVStereo but ships no config
    # using it (ViewTransformerLSSBEVDepth.py:938) — same here: stereo=True
    # swaps the mono DepthNet for LSSBEVStereo fed by the previous keyframe
    # (batch.imgs_prev + per-camera key->prev transforms from the dataset).
    stereo: bool = False
    stereo_downsample: int = 4          # image stride of the stereo features
    stereo_num_ranges: int = 4
    stereo_range_list: Tuple[Tuple[float, float], ...] = (
        (2, 8), (8, 16), (16, 28), (28, 58))
    stereo_em_iteration: int = 3
    stereo_num_samples: int = 3
    stereo_num_groups: int = 8


@dataclass(frozen=True)
class PtsBranchConfig:
    """LiDAR branch: voxelization + sparse(-equivalent) middle encoder.

    Reference: pts_voxel_layer / HardSimpleVFE / SparseLiDAREnc8x config at
    coocc_multi_r50_256x704.py:121-135. Shapes here are static capacities.
    """
    voxel_size: Tuple[float, float, float] = (0.125, 0.125, 0.125)
    max_num_points: int = 10
    max_voxels: int = 90000             # train cap (ref: (90000, 120000))
    max_voxels_test: int = 120000
    max_points: int = 350000            # static capacity for the padded point cloud
    num_point_features: int = 5         # x, y, z, intensity, dt
    encoder: str = "SparseLiDAREnc8x"   # | 'SparseLiDAREnc4x' | 'SparseEncoderHD'
    # Encoder implementation ('packed' / 'dense' / 'gather', same
    # parameters); 'auto' is 'packed' for SparseLiDAREnc8x and 'packed_hd'
    # for SparseEncoderHD. The port has each: 'packed'
    # (nn/sparse_enc_packed.py; ztap_levels, JAX's z-batch layout of the
    # same function, runs it too), 'dense' (nn/sparse_enc_dense.py),
    # 'packed_hd' (nn/sparse_enc_packed_hd.py) and 'gather' (the
    # gather-GEMM nn/sparse_enc.py and nn/sparse_encoder_hd.py).
    impl: str = "auto"
    ztap_levels: Tuple[int, ...] = ()
    input_channel: int = 4
    base_channel: int = 16
    out_channel: int = 128
    sparse_shape_xyz: Tuple[int, int, int] = (800, 800, 64)


@dataclass(frozen=True)
class SECOND3DConfig:
    """Dense LiDAR 3D backbone (lidar-only config). Reference: coocc_lidar.py:113-130."""
    in_channels: Tuple[int, ...] = (128, 128, 128)
    out_channels: Tuple[int, ...] = (128, 256, 512)
    layer_nums: Tuple[int, ...] = (5, 5, 5)
    layer_strides: Tuple[int, ...] = (1, 2, 4)
    is_cascade: bool = False
    fpn_out_channels: Tuple[int, ...] = (128, 128, 128)
    fpn_upsample_strides: Tuple[int, ...] = (1, 2, 4)
    fpn_extra_num_conv: int = 3


@dataclass(frozen=True)
class FuserConfig:
    """GSFusion bidirectional KNN fuser. Reference: BiFuser_N bifuser_n.py:14-174.

    The nearest keys come from a windowed search over the voxel grid
    (coocc_tpu_torch/ops/window_knn.py), keeping the reference's knum /
    dist_thresh semantics.
    """
    knum: int = 2
    in_channels: int = 128
    out_channels: int = 128
    dist_thresh: float = 13.3
    max_active_img: int = 65536         # capacity of nonzero image-voxel list
    max_active_pts: int = 65536         # capacity of nonzero lidar-voxel list
    # window-KNN search radii (voxels). The reference's KNN is global within
    # dist_thresh; a finite window misses far neighbours. Measured on
    # realistic occupancy at the flagship fuser grid
    # (tools/knn_window_missrate.py, 3 scenes): best-2 miss rate
    # (4,4,7) = 0.7% pts->img / 3.3% img->pts; (6,6,7) = 0.3% / 0.6%;
    # (8,8,7) = 0.03% / 0.13%. Default (6,6,7): keeps both directions <1%.
    window_rx: int = 6
    window_ry: int = 6
    window_rz: int = 7
    # per-direction override for the IMG-key search (nearest image voxels
    # for pts-active queries). Image coverage is the dense LSS frustum, so
    # its nearest neighbours sit much closer than sparse LiDAR's: (4,4,7)
    # measures 0.7% pts->img miss (vs 0.3% at (6,6,7)) at ~half the
    # window volume (1215 vs 2535 offsets). None = use window_r{x,y,z}.
    window_img_rx: int | None = 4
    window_img_ry: int | None = 4
    window_img_rz: int | None = 7


@dataclass(frozen=True)
class SemanticEncoderConfig:
    """CustomResNet3D + FPN3D. Reference: coocc_multi_r50_256x704.py:141-159."""
    depth: int = 18
    block_inplanes: Tuple[int, ...] = (128, 256, 512, 1024)
    block_strides: Tuple[int, ...] = (1, 2, 2, 2)
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    neck_out_channels: int = 256
    neck_with_cp: bool = True           # gradient checkpoint FPN3D convs


@dataclass(frozen=True)
class OccHeadConfig:
    """Occupancy head. Reference: OccHead occ_head.py:16-379 + config :160-180."""
    in_channels: Tuple[int, ...] = (256, 256, 256, 256)
    out_channel: int = 17
    num_level: int = 4
    soft_weights: bool = True
    cascade_ratio: int = 2
    sample_from_voxel: bool = True
    sample_from_img: bool = True
    final_occ_size: Tuple[int, int, int] = (200, 200, 16)
    fine_topk: int = 15000
    empty_idx: int = 0
    balance_cls_weight: bool = True
    data_type: str = "nus"              # 'nus' | 'kitti'
    loss_voxel_ce_weight: float = 1.0
    loss_voxel_sem_scal_weight: float = 1.0
    loss_voxel_geo_scal_weight: float = 1.0
    loss_voxel_lovasz_weight: float = 1.0
    # static capacity of the coarse-occupied list at eval (train uses fine_topk)
    max_coarse_occupied: int = 20000
    # geometry context the reference passes in at call time
    point_cloud_range: Tuple[float, ...] = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    input_size: Tuple[int, int] = (256, 704)


@dataclass(frozen=True)
class RenderConfig:
    """Volume-rendering regularizer. Reference: COOCC_Ray init coocc_ray.py:32-117
    and inline renderer :358-494; knobs at coocc_multi_r50_256x704.py:79-92."""
    use_rendering: bool = True
    test_rendering: bool = False
    N_samples: int = 64
    N_rand: int = 4096
    nerf_sample_view: int = 6
    near_far_range: Tuple[float, float] = (0.2, 100.0)
    # the inline renderer hardcodes this grid independent of the model grid
    # (reference: coocc_ray.py:372-376)
    render_xbound: Tuple[float, float, float] = (-50.0, 50.0, 1.0)
    render_ybound: Tuple[float, float, float] = (-50.0, 50.0, 1.0)
    render_zbound: Tuple[float, float, float] = (-5.0, 3.0, 1.0)


@dataclass(frozen=True)
class OptimConfig:
    """AdamW + step LR + clip. Reference: coocc_multi_r50_256x704.py:263-288."""
    lr: float = 1e-4
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    grad_clip_norm: float = 5.0
    lr_step_epochs: Tuple[int, ...] = (20, 23)
    lr_step_gamma: float = 0.1
    max_epochs: int = 24
    samples_per_device: int = 1
    norm_decay_mult: float = 0.0        # no weight decay on norm params


@dataclass(frozen=True)
class CoOccConfig:
    """Top-level model+data config mirroring one reference config file."""
    name: str = "coocc_multi_r50_256x704"
    model_type: str = "COOCC_Ray"       # | 'COOCC_Ray_L'
    num_classes: int = 17
    empty_idx: int = 0
    point_cloud_range: Tuple[float, ...] = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    occ_size: Tuple[int, int, int] = (200, 200, 16)
    lss_downsample: Tuple[int, int, int] = (2, 2, 2)
    scale: int = 16                     # frustum stride for the renderer
    loss_norm: bool = True
    use_camera: bool = True
    use_lidar: bool = True
    # GT label layout: 'surroundocc' = occ_path/samples/{token}.npy sparse
    # [x,y,z,cls] (ref LoadOccupancy loading.py:18-174); 'openoccupancy' =
    # occ_path/scene_{scene}/occupancy/{lidar_token}.npy sparse [z,y,x,cls]
    # with world<->voxel + BDA transform (ref LoadOccupancy2 :176-393)
    gt_format: str = "surroundocc"
    # static capacity for the padded lidarseg point cloud (points_occ)
    points_occ_capacity: int = 40000

    data: DataConfig = field(default_factory=DataConfig)
    grid: GridConfig = field(default_factory=GridConfig)
    img_backbone: Optional[ImageBackboneConfig] = field(default_factory=ImageBackboneConfig)
    img_neck: Optional[ImageNeckConfig] = field(default_factory=ImageNeckConfig)
    lss: Optional[LSSConfig] = field(default_factory=LSSConfig)
    pts: Optional[PtsBranchConfig] = field(default_factory=PtsBranchConfig)
    second3d: Optional[SECOND3DConfig] = None
    fuser: Optional[FuserConfig] = field(default_factory=FuserConfig)
    semantic: SemanticEncoderConfig = field(default_factory=SemanticEncoderConfig)
    occ_head: OccHeadConfig = field(default_factory=OccHeadConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)

    # numerics
    compute_dtype: str = "float32"      # 'bfloat16' for the fast path
    param_dtype: str = "float32"

    @property
    def voxel_size(self) -> Tuple[float, float, float]:
        pcr = self.point_cloud_range
        return tuple(
            (pcr[i + 3] - pcr[i]) / self.occ_size[i] for i in range(3)
        )

    @property
    def lss_grid_size(self) -> Tuple[int, int, int]:
        return tuple(
            self.occ_size[i] // self.lss_downsample[i] for i in range(3)
        )

    def replace(self, **kw) -> "CoOccConfig":
        return dataclasses.replace(self, **kw)


def frustum_feat_size(cfg: CoOccConfig) -> Tuple[int, int]:
    """(fH, fW) of the LSS frustum feature map."""
    h, w = cfg.data.input_size
    d = cfg.lss.downsample
    return h // d, w // d
