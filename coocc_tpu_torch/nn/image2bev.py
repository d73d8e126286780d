"""Deformable image2bev encoder stack (VoxFormer/BEVFormer-style).

Counterpart of coocc_tpu/nn/image2bev.py (the reference's image2bev
transformer: coocc/image2bev/modules/{encoder.py, deformable_self_attention.py,
deformable_cross_attention.py, transformer.py}): a BEV query grid refined
by alternating deformable self-attention on the BEV plane and deformable
cross-attention into the multi-camera feature pyramids. No `CoOccRay` route
reaches it, in either package (LSS is the live view transformer).

As in JAX: every query attends in every camera under a static hit mask,
the output summed over cameras and divided by the clamped hit count (the
reference's per-camera "rebatch" gathers only the hit queries, a dynamic
shape); the sampler `ms_deform_attn_2d` is a gather of each head's rows of
every level and a weighted sum (ops/ms_deform_attn.py:deform_sample), in
fp32. Feature maps come channels-first ([B, C, H, W] a level, [B, N, C, H,
W] over cameras); queries are [B, Q, C]. The flax scopes are the
attributes' names (`convert.module_state_dict_from_jax`), and `dtype` is
flax's: each Dense casts its input and weights to it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.constants import device_constant
from ..ops.ms_deform_attn import deform_sample, offset_heads
from .layers import LayerNorm, Linear, flax_apply, softmax

# flax.linen.LayerNorm's epsilon
LN_EPS = 1e-6


def ms_deform_attn_2d(value_levels: Sequence[torch.Tensor],
                      sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale 2D deformable attention core, as JAX's.

    value_levels: per-level [B, H_l, W_l, nH, c] head-split maps;
    sampling_locations [B, Q, nH, L, P, 2] normalized (x, y) in [0, 1];
    attention_weights [B, Q, nH, L, P] (softmax applied). Returns
    [B, Q, nH * c] fp32: bilinear taps (align_corners=False, zeros
    padding) of each head's c channels only, weighted and summed over
    points and levels."""
    B, Q, nH, L, P, _ = sampling_locations.shape
    c = value_levels[0].shape[-1]
    sizes = [tuple(v.shape[1:3]) for v in value_levels]

    def coords(lvl):
        H, W = sizes[lvl]
        loc = sampling_locations[:, :, :, lvl]
        # (y, x): the rows are (b, y, x, head)
        return [loc[..., 1] * H - 0.5, loc[..., 0] * W - 0.5]
    out = deform_sample([v.reshape(-1, c) for v in value_levels], sizes,
                        coords, attention_weights.float())
    return out.reshape(B, Q, nH * c)


def _grid_init_bias(num_heads: int, num_levels: int, num_points: int):
    """Directional sampling-offset bias (deformable-DETR init, JAX's
    `_grid_init_bias`): head h points along angle 2*pi*h/nH, the ring's
    radius growing with the point's index."""
    thetas = np.arange(num_heads, dtype=np.float32) * (
        2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


def _to_cl(f: torch.Tensor) -> torch.Tensor:
    """[..., C, H, W] -> [..., H, W, C]."""
    return f.movedim(-3, -1)


class MSDeformableAttention2D(nn.Module):
    """Per-camera deformable attention into an image pyramid (the
    reference's MSDeformableAttention3D: "3D" there means Z z-anchor
    reference points per query, sampled on 2-D image planes). No output
    projection or residual: DeformCrossAttention owns those."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 8,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points, self.dtype = (num_levels,
                                                        num_points, dtype)
        self.value_proj = Linear(embed_dims, embed_dims)
        self.sampling_offsets, self.attention_weights = offset_heads(
            embed_dims, num_heads * num_levels * num_points,
            _grid_init_bias(num_heads, num_levels, num_points))

    def forward(self, query, value_levels, reference_points):
        """query [B, Q, C]; value_levels: per-level [B, C, H, W];
        reference_points [B, Q, Z, 2] normalized (x, y), Z z-anchors a
        query (num_points a multiple of Z). Returns [B, Q, C] in query's
        dtype."""
        B, Q, C = query.shape
        nH, L, P = self.num_heads, self.num_levels, self.num_points
        Z = reference_points.shape[2]
        assert P % Z == 0, "num_points must be a multiple of num_Z_anchors"
        # one value projection shared by the levels
        values = [flax_apply(self.value_proj, _to_cl(v), self.dtype)
                  for v in value_levels]
        values = [v.reshape(B, v.shape[1], v.shape[2], nH, C // nH)
                  for v in values]
        off = flax_apply(self.sampling_offsets, query, self.dtype).reshape(
            B, Q, nH, L, P, 2)
        attn = softmax(flax_apply(self.attention_weights, query, self.dtype)
                       .reshape(B, Q, nH, L * P), -1).reshape(
                           B, Q, nH, L, P)
        # offsets over each level's (W, H); every P // Z consecutive points
        # cycle through the Z anchors (point p on anchor p % Z)
        norms = device_constant(np.asarray(
            [(v.shape[2], v.shape[1]) for v in values], np.float32),
            query.device)
        off = off / norms[None, None, None, :, None, :]
        off = off.reshape(B, Q, nH, L, P // Z, Z, 2)
        refs = reference_points[:, :, None, None, None, :, :]
        loc = (refs + off).reshape(B, Q, nH, L, P, 2)
        out = ms_deform_attn_2d(values, loc.float(), attn.float())
        return out.to(query.dtype)


class DeformSelfAttention(nn.Module):
    """BEV-plane deformable self-attention with a 2-slot temporal queue:
    slot 0 the history (prev_bev, or the query itself), slot 1 the current
    query. Offsets and weights come from [history ; current], the queue is
    folded into the batch, and the result averaged over it."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 num_bev_queue: int = 2,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.num_bev_queue, self.dtype = num_bev_queue, dtype
        K = num_bev_queue
        self.value_proj = Linear(embed_dims, embed_dims)
        self.sampling_offsets, self.attention_weights = offset_heads(
            2 * embed_dims,
            K * num_heads * num_levels * num_points,
            np.tile(_grid_init_bias(num_heads, num_levels, num_points), K))
        self.output_proj = Linear(embed_dims, embed_dims)

    def forward(self, query, reference_points, spatial_shape,
                query_pos=None, prev_bev=None):
        """query [B, Q, C]; reference_points [B, Q, 2] normalized;
        spatial_shape (H, W) of the BEV plane (Q = H * W, row-major);
        prev_bev [B, Q, C] or None."""
        B, Q, C = query.shape
        nH, L, P, K = (self.num_heads, self.num_levels, self.num_points,
                       self.num_bev_queue)
        H, W = spatial_shape
        identity = query
        if query_pos is not None:
            query = query + query_pos
        value = query if prev_bev is None else prev_bev
        stacked = torch.stack([value, query], 1)          # [B, K, Q, C]
        qcat = torch.cat([value, query], -1)              # [B, Q, 2C]
        vmaps = flax_apply(self.value_proj, stacked, self.dtype).reshape(
            B * K, H, W, nH, C // nH)
        off = flax_apply(self.sampling_offsets, qcat, self.dtype).reshape(
            B, Q, nH, K, L, P, 2)
        attn = softmax(flax_apply(self.attention_weights, qcat, self.dtype)
                       .reshape(B, Q, nH, K, L * P), -1).reshape(
                           B, Q, nH, K, L, P)
        # the queue folded into the batch (the reference's bs * 2)
        off = off.permute(0, 3, 1, 2, 4, 5, 6).reshape(B * K, Q, nH, L, P, 2)
        attn = attn.permute(0, 3, 1, 2, 4, 5).reshape(B * K, Q, nH, L, P)
        norm = device_constant(np.asarray([[W, H]], np.float32),
                               query.device)
        refs = reference_points[:, None].expand(B, K, Q, 2).reshape(
            B * K, Q, 2)
        loc = refs[:, :, None, None, None, :] + \
            off / norm[None, None, None, :, None, :]
        out = ms_deform_attn_2d([vmaps], loc.float(), attn.float())
        out = out.reshape(B, K, Q, C).mean(1)             # the queue's mean
        out = flax_apply(self.output_proj, out, self.dtype)
        return out.to(identity.dtype) + identity


class DeformCrossAttention(nn.Module):
    """Multi-camera deformable cross-attention under the static hit mask:
    every query attends in every camera (cameras folded into the batch),
    cameras its pillar never hits are zeroed, and the sum over cameras is
    divided by the hit count clamped at 1."""

    def __init__(self, embed_dims: int = 256, num_cams: int = 6,
                 num_levels: int = 4, num_heads: int = 8,
                 num_points: int = 8,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        self.embed_dims, self.num_cams, self.dtype = (embed_dims, num_cams,
                                                      dtype)
        self.deformable_attention = MSDeformableAttention2D(
            embed_dims, num_heads, num_levels, num_points, dtype)
        self.output_proj = Linear(embed_dims, embed_dims)

    def forward(self, query, mlvl_feats, reference_points_cam, bev_mask,
                query_pos=None):
        """query [B, Q, C]; mlvl_feats: per-level [B, N, C, H, W];
        reference_points_cam [B, N, Q, Z, 2]; bev_mask [B, N, Q, Z]."""
        B, Q, C = query.shape
        N = self.num_cams
        identity = query
        if query_pos is not None:
            query = query + query_pos
        qc = query[:, None].expand(B, N, Q, C).reshape(B * N, Q, C)
        refs = reference_points_cam.reshape(B * N, Q, -1, 2)
        feats = [f.reshape((B * N,) + f.shape[2:]) for f in mlvl_feats]
        out = self.deformable_attention(qc, feats, refs).reshape(B, N, Q, C)
        hit = bev_mask.sum(-1) > 0                        # [B, N, Q]
        out = (out * hit[..., None].to(out.dtype)).sum(1)
        count = hit.sum(1).to(out.dtype).clamp(min=1.0)
        out = out / count[..., None]
        out = flax_apply(self.output_proj, out, self.dtype)
        return out.to(identity.dtype) + identity


class VoxFormerLayer(nn.Module):
    """self_attn -> norm1 -> cross_attn -> norm2 -> ffn -> norm3 (the
    standard BEVFormer operation order); flax's LayerNorm, eps 1e-6."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points_cross: int = 8,
                 num_points_self: int = 4, feedforward_channels: int = 512,
                 num_cams: int = 6, use_self_attn: bool = True,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        self.use_self_attn, self.dtype = use_self_attn, dtype
        if use_self_attn:
            self.self_attn = DeformSelfAttention(
                embed_dims, num_heads, num_points=num_points_self,
                dtype=dtype)
            self.norm1 = LayerNorm(embed_dims, eps=LN_EPS)
        self.cross_attn = DeformCrossAttention(
            embed_dims, num_cams, num_levels, num_heads, num_points_cross,
            dtype)
        self.norm2 = LayerNorm(embed_dims, eps=LN_EPS)
        self.ffn_fc1 = Linear(embed_dims, feedforward_channels)
        self.ffn_fc2 = Linear(feedforward_channels, embed_dims)
        self.norm3 = LayerNorm(embed_dims, eps=LN_EPS)

    def forward(self, query, mlvl_feats, ref_2d, spatial_shape,
                reference_points_cam, bev_mask, query_pos=None,
                prev_bev=None):
        if self.use_self_attn:
            query = self.self_attn(query, ref_2d, spatial_shape,
                                   query_pos=query_pos, prev_bev=prev_bev)
            query = flax_apply(self.norm1, query, self.dtype)
        query = self.cross_attn(query, mlvl_feats, reference_points_cam,
                                bev_mask, query_pos=query_pos)
        query = flax_apply(self.norm2, query, self.dtype)
        y = torch.relu(flax_apply(self.ffn_fc1, query, self.dtype))
        y = flax_apply(self.ffn_fc2, y, self.dtype)
        return flax_apply(self.norm3, query + y, self.dtype)


def get_reference_points_3d(H: int, W: int, Z: float,
                            num_points_in_pillar: int) -> np.ndarray:
    """[P, H*W, 3] normalized pillar reference points (JAX's, numpy)."""
    zs = (np.linspace(0.5, Z - 0.5, num_points_in_pillar,
                      dtype=np.float32) / Z)[:, None, None] * np.ones(
        (num_points_in_pillar, H, W), np.float32)
    xs = (np.linspace(0.5, W - 0.5, W, dtype=np.float32) / W)[
        None, None, :] * np.ones((num_points_in_pillar, H, W), np.float32)
    ys = (np.linspace(0.5, H - 0.5, H, dtype=np.float32) / H)[
        None, :, None] * np.ones((num_points_in_pillar, H, W), np.float32)
    ref = np.stack([xs, ys, zs], -1)                     # [P, H, W, 3]
    return ref.reshape(num_points_in_pillar, H * W, 3)


def get_reference_points_2d(H: int, W: int) -> np.ndarray:
    """[H*W, 2] normalized BEV-plane reference points (JAX's, numpy)."""
    ys, xs = np.meshgrid(np.linspace(0.5, H - 0.5, H, dtype=np.float32),
                         np.linspace(0.5, W - 0.5, W, dtype=np.float32),
                         indexing="ij")
    return np.stack([xs.reshape(-1) / W, ys.reshape(-1) / H], -1)


def point_sampling(ref_3d: torch.Tensor, pc_range: Sequence[float],
                   lidar2img: torch.Tensor, img_shape: Tuple[int, int]):
    """Project normalized 3D pillar points into each camera.

    ref_3d [P, Q, 3] normalized; lidar2img [B, N, 4, 4]; img_shape
    (H_img, W_img). Returns reference_points_cam [B, N, Q, P, 2] in [0, 1]
    and bev_mask [B, N, Q, P]: in front of the camera (depth > 1e-5) and
    strictly inside the image."""
    dev = ref_3d.device
    pc = device_constant(np.asarray(pc_range, np.float32), dev)
    pts = ref_3d * (pc[3:6] - pc[0:3]) + pc[0:3]
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    cam = torch.einsum("bnij,pqj->bnpqi", lidar2img.float(), pts_h)
    eps = 1e-5
    depth = cam[..., 2:3]
    mask = depth[..., 0] > eps
    xy = cam[..., 0:2] / depth.clamp(min=eps)
    xy = xy / device_constant(np.asarray([img_shape[1], img_shape[0]],
                                         np.float32), dev)
    mask = (mask & (xy[..., 0] > 0.0) & (xy[..., 0] < 1.0)
            & (xy[..., 1] > 0.0) & (xy[..., 1] < 1.0))
    return xy.permute(0, 1, 3, 2, 4), mask.permute(0, 1, 3, 2)


class VoxFormerEncoder(nn.Module):
    """num_layers VoxFormerLayers over a BEV query grid."""

    def __init__(self, embed_dims: int = 256, num_layers: int = 3,
                 num_heads: int = 8, num_levels: int = 4,
                 num_points_in_pillar: int = 4, num_cams: int = 6,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2,
                                              51.2, 3.0),
                 feedforward_channels: int = 512, use_self_attn: bool = True,
                 return_intermediate: bool = False,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.num_points_in_pillar = num_points_in_pillar
        self.pc_range = tuple(pc_range)
        self.return_intermediate = return_intermediate
        for i in range(num_layers):
            self.add_module(f"layer{i}", VoxFormerLayer(
                embed_dims, num_heads, num_levels,
                feedforward_channels=feedforward_channels,
                num_cams=num_cams, use_self_attn=use_self_attn,
                dtype=dtype))

    def forward(self, bev_query, mlvl_feats, bev_h, bev_w, lidar2img,
                img_shape, bev_pos=None, prev_bev=None, ref_3d=None):
        """bev_query [B, Q, C] (Q = bev_h * bev_w unless a ref_3d subset
        is given); mlvl_feats: per-level [B, N, C, H, W]; lidar2img
        [B, N, 4, 4]; img_shape (H_img, W_img)."""
        B = bev_query.shape[0]
        dev = bev_query.device
        if ref_3d is None:
            ref_3d = device_constant(get_reference_points_3d(
                bev_h, bev_w, self.pc_range[5] - self.pc_range[2],
                self.num_points_in_pillar), dev)
        ref_2d = device_constant(get_reference_points_2d(bev_h, bev_w),
                                 dev)[None].expand(B, -1, -1)
        refs_cam, bev_mask = point_sampling(ref_3d, self.pc_range,
                                            lidar2img, img_shape)
        intermediate = []
        out = bev_query
        for i in range(self.num_layers):
            out = getattr(self, f"layer{i}")(
                out, mlvl_feats, ref_2d, (bev_h, bev_w), refs_cam, bev_mask,
                query_pos=bev_pos, prev_bev=prev_bev)
            intermediate.append(out)
        if self.return_intermediate:
            return torch.stack(intermediate)
        return out


class Image2BEVTransformer(nn.Module):
    """Learned BEV queries and positions, level and camera embeddings ->
    the encoder -> [B, bev_h * bev_w, embed_dims] (the reference's
    PerceptionTransformer): the full static query grid is refined."""

    def __init__(self, embed_dims: int = 256, num_layers: int = 3,
                 num_heads: int = 8, num_feature_levels: int = 4,
                 num_cams: int = 6, bev_h: int = 128, bev_w: int = 128,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2,
                                              51.2, 3.0),
                 use_cams_embeds: bool = True,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        Q = bev_h * bev_w
        self.bev_h, self.bev_w, self.dtype = bev_h, bev_w, dtype
        self.use_cams_embeds = use_cams_embeds
        # flax's normal(1.0) init
        self.bev_queries = nn.Parameter(torch.randn(Q, embed_dims))
        self.bev_pos = nn.Parameter(torch.randn(Q, embed_dims))
        self.level_embeds = nn.Parameter(torch.randn(num_feature_levels,
                                                     embed_dims))
        self.cams_embeds = nn.Parameter(torch.randn(num_cams, embed_dims))
        self.encoder = VoxFormerEncoder(
            embed_dims, num_layers, num_heads, num_feature_levels,
            num_cams=num_cams, pc_range=pc_range, dtype=dtype)

    def forward(self, mlvl_feats, lidar2img, img_shape, prev_bev=None):
        """mlvl_feats: per-level [B, N, C, H, W]; lidar2img [B, N, 4, 4];
        img_shape (H_img, W_img). Returns [B, bev_h * bev_w, C]."""
        B = mlvl_feats[0].shape[0]
        feats = []
        for lvl, f in enumerate(mlvl_feats):
            f = f + self.level_embeds[lvl].to(f.dtype)[:, None, None]
            if self.use_cams_embeds:
                f = f + self.cams_embeds.to(f.dtype)[None, :, :, None, None]
            feats.append(f)
        dt = self.dtype or torch.float32
        q = self.bev_queries[None].expand(B, -1, -1).to(dt)
        pos = self.bev_pos[None].expand(B, -1, -1).to(dt)
        return self.encoder(q, feats, self.bev_h, self.bev_w, lidar2img,
                            img_shape, bev_pos=pos, prev_bev=prev_bev)
