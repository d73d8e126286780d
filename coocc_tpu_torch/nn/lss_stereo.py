"""BEVStereo temporal-stereo depth: the stereo config's depth net.

Counterpart of coocc_tpu/nn/lss_stereo.py (reference
ViewTransformerLSSBEVStereo and DepthNetStereo,
ViewTransformerLSSBEVDepth.py:837-1441), which
`coocc_multi_r50_256x704_stereo` runs in place of the mono DepthNet:

  * DepthNetStereo: the camera-conditioned trunk of the mono DepthNet (SE
    gates, BasicBlocks, ASPP, DCN) with a context head, a mono depth head,
    and a head that upsamples x4 (two stride-2 transposed convs) to emit,
    per depth range, the Gaussian hypothesis (mu, sigma) and a range score
    at the stride of the stereo features;
  * homo_warp: the previous keyframe's stride-4 features warped onto depth
    planes of the key camera (a plane sweep), sampled bilinearly;
  * LSSBEVStereo: per range, EM refinement of (mu, sigma) against the
    group-correlation cost of key and warped features scored by a small
    similarity net (instantiated once, called num_ranges x em_iteration
    times), a Gaussian splat onto the range's depth bins, the stereo depth
    brought to the LSS stride and gated into the mono depth by a mask net.

NCHW in and out, like the mono DepthNet; the plane sweep and the cost
volume are channels-last ([BN, S, sH, sW, C]), as JAX computes them.

Weight names. The reference ships no stereo checkpoint and
coocc_tpu/train/convert_torch.py:convert_coocc_ray has no stereo names, so
the modules here take the flax scopes' names: `depth_net` (DepthNetStereo)
with reduce_conv, reduce_bn, bn, {context,depth}_mlp, {context,depth}_se,
context_conv, depth_block{0,1}, aspp, dcn, msr_block, msr_deconv{0,1},
msr_bn{0,1}, msr_pred, mono_block, mono_pred; beside it sim_fc{0,1,2},
sim_bn{0,1}, dds_conv{0,1}, dds_bn{0,1}, dds_pred, mask_conv0, mask_bn0,
mask_block{0,1}, mask_pred. The reused modules keep their own inner names
(ASPP's global_avg_pool.1 is flax's gap_conv; convert.py maps them).

Precision. In bf16 the port casts where JAX casts: the sampled depths
(k_list is an fp32 array, not a weak scalar) and so the warp, the cost
volume and the EM means are fp32, sigma and the scores bf16; the similarity
net, the downsampling convs and the mask net take the compute dtype at
their first layer (flax's promote_dtype); a Python constant in a bf16 op is
rounded to bf16 first (JAX's weak types: `weak`).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.grid_sample import grid_sample_2d
from .depthnet import ASPP, DCN, BasicBlock2D, Mlp, SELayer
from .layers import (BatchNorm, Conv2d, ConvTranspose2d, Linear, softmax,
                     weak)


def depth_sampling_k_list(sampling_range: int = 3,
                          num_samples: int = 3) -> np.ndarray:
    """The Gaussian-quantile offsets of the depth candidates (reference
    depth_sampling, :1012-1024): the midpoints of num_samples
    equal-probability slices of +-sampling_range sigma, the inverse normal
    CDF taken by bisection on the host, as JAX's (numpy, fp32)."""
    from math import erf
    p_total = erf(sampling_range / np.sqrt(2.0))
    idx = np.arange(0, num_samples + 1)
    p = (1 - p_total) / 2 + (idx / num_samples) * p_total

    def ndtri_host(q):
        lo, hi = -8.0, 8.0
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            if 0.5 * (1.0 + erf(mid / np.sqrt(2.0))) < q:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    k = np.array([ndtri_host(float(q)) for q in p])
    return ((k[1:] + k[:-1]) / 2).astype(np.float32)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)) in
    x's dtype (torch's softplus returns x itself above 20)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


class _SameDeconv(ConvTranspose2d):
    """flax ConvTranspose(3x3, stride 2, padding "SAME",
    transpose_kernel=True): torch's padding-free transposed conv cropped to
    its first 2H x 2W (torch's padding=1, output_padding=1 would take rows
    1..2H, a pixel off)."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, stride=2)

    def forward(self, x):
        H, W = x.shape[-2:]
        return super().forward(x)[..., :2 * H, :2 * W]


class DepthNetStereo(nn.Module):
    """[BN, Cin, fH, fW] + the 27-d camera vector -> (context [BN, ctx, fH,
    fW], mono depth logits [BN, D, fH, fW], mu, sigma and range-score
    logits [BN, R, 4fH, 4fW]). JAX lss_stereo.py:68-129."""

    def __init__(self, in_channels: int, mid_channels: int,
                 context_channels: int, depth_channels: int,
                 num_ranges: int = 4, cam_channels: int = 27):
        super().__init__()
        mid = mid_channels
        self.num_ranges = num_ranges
        self.bn = BatchNorm(cam_channels)
        self.reduce_conv = Conv2d(in_channels, mid, 3, 1, 1)
        self.reduce_bn = BatchNorm(mid)
        self.context_mlp = Mlp(cam_channels, mid, mid)
        self.context_se = SELayer(mid)
        self.context_conv = Conv2d(mid, context_channels, 1)
        self.depth_mlp = Mlp(cam_channels, mid, mid)
        self.depth_se = SELayer(mid)
        self.depth_block0 = BasicBlock2D(mid)
        self.depth_block1 = BasicBlock2D(mid)
        self.aspp = ASPP(mid, mid)
        self.dcn = DCN(mid, groups=4)
        self.msr_block = BasicBlock2D(mid)
        self.msr_deconv0 = _SameDeconv(mid)
        self.msr_bn0 = BatchNorm(mid)
        self.msr_deconv1 = _SameDeconv(mid)
        self.msr_bn1 = BatchNorm(mid)
        self.msr_pred = Conv2d(mid, 3 * num_ranges, 1)
        self.mono_block = BasicBlock2D(mid)
        self.mono_pred = Conv2d(mid, depth_channels, 1)

    def forward(self, x, mlp_input):
        mlp_input = self.bn(mlp_input).to(x.dtype)
        x = F.relu(self.reduce_bn(self.reduce_conv(x)))
        context = self.context_conv(
            self.context_se(x, self.context_mlp(mlp_input)))
        depth = self.depth_se(x, self.depth_mlp(mlp_input))
        depth = self.depth_block1(self.depth_block0(depth))
        depth_feat = self.dcn(self.aspp(depth))
        y = self.msr_block(depth_feat)
        y = F.relu(self.msr_bn0(self.msr_deconv0(y)))
        y = F.relu(self.msr_bn1(self.msr_deconv1(y)))
        msr = self.msr_pred(y)
        R = self.num_ranges
        mono_depth = self.mono_pred(self.mono_block(depth_feat))
        return (context, mono_depth, msr[:, :R], softplus(msr[:, R:2 * R]),
                msr[:, 2 * R:])


def homo_warp(src_feat: torch.Tensor, depth_sample: torch.Tensor,
              key_intrin: torch.Tensor, sweep_intrin: torch.Tensor,
              key2sweep_rot: torch.Tensor, key2sweep_tran: torch.Tensor,
              stereo_downsample: int = 4) -> torch.Tensor:
    """The previous sweep's stereo features warped onto depth planes of the
    key camera, per view (JAX `homo_warp` under vmap, :132-166):
    src_feat [BN, H, W, C] channels-last at stride `stereo_downsample`;
    depth_sample [BN, S, H, W] candidate depths; key_intrin, sweep_intrin,
    key2sweep_rot [BN, 3, 3]; key2sweep_tran [BN, 3] -> [BN, S, H, W, C].
    A point behind the sweep camera (depth < 1e-3) samples at 2.0, outside
    the grid, so it reads zeros. The intrinsics are inverted with
    `inv_ex`, which does not wait for the device."""
    BN, S, H, W = depth_sample.shape
    dev = depth_sample.device
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) \
        * stereo_downsample - 0.5
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) \
        * stereo_downsample - 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([gx, gy, torch.ones_like(gx)], -1)  # [H, W, 3]
    inv = torch.linalg.inv_ex(key_intrin).inverse
    cam = torch.einsum("nij,hwj->nhwi", inv, pix)
    cam = cam[:, None] * depth_sample[..., None]  # [BN, S, H, W, 3]
    swp = torch.einsum("nij,nshwj->nshwi", key2sweep_rot, cam) \
        + key2sweep_tran[:, None, None, None]
    proj = torch.einsum("nij,nshwj->nshwi", sweep_intrin, swp)
    d = proj[..., 2:3]
    uv = proj[..., :2] / torch.clamp(d, min=1e-3)
    su = (uv[..., 0] + 0.5) / stereo_downsample - 0.5
    sv = (uv[..., 1] + 0.5) / stereo_downsample - 0.5
    u = su / ((W - 1) / 2) - 1
    v = sv / ((H - 1) / 2) - 1
    behind = d[..., 0] < 1e-3
    out = torch.full_like(u, 2.0)
    grid = torch.stack([torch.where(behind, out, u),
                        torch.where(behind, out, v)], -1)
    return grid_sample_2d(src_feat, grid)


class LSSBEVStereo(nn.Module):
    """Temporal-stereo depth: [BN, Cin, fH, fW] key features, the key and
    previous frames' stride-4 features [BN, Cs, sH, sW], the camera vector
    and the key->previous camera rig -> (context [BN, ctx, fH, fW],
    depth_prob [BN, D, fH, fW]). JAX lss_stereo.py:169-289."""

    def __init__(self, in_channels: int, mid_channels: int,
                 context_channels: int, depth_channels: int,
                 dbound: Tuple[float, float, float],
                 range_list: Sequence[Tuple[float, float]],
                 em_iteration: int = 3, num_samples: int = 3,
                 num_groups: int = 8, stereo_downsample: int = 4):
        super().__init__()
        D = depth_channels
        self.dbound = tuple(dbound)
        self.range_list = tuple(tuple(r) for r in range_list)
        self.em_iteration = em_iteration
        self.num_samples = num_samples
        self.num_groups = num_groups
        self.stereo_downsample = stereo_downsample
        self.depth_net = DepthNetStereo(in_channels, mid_channels,
                                        context_channels, D,
                                        len(self.range_list))
        self.sim_fc0 = Linear(num_groups, 16)
        self.sim_bn0 = BatchNorm(16)
        self.sim_fc1 = Linear(16, 8)
        self.sim_bn1 = BatchNorm(8)
        self.sim_fc2 = Linear(8, 1)
        self.dds_conv0 = Conv2d(D, 256, 3, 2, 1)
        self.dds_bn0 = BatchNorm(256)
        self.dds_conv1 = Conv2d(256, 256, 3, 2, 1)
        self.dds_bn1 = BatchNorm(256)
        self.dds_pred = Conv2d(256, D, 1)
        self.mask_conv0 = Conv2d(2 * D, 64, 3, 1, 1)
        self.mask_bn0 = BatchNorm(64)
        self.mask_block0 = BasicBlock2D(64)
        self.mask_block1 = BasicBlock2D(64)
        self.mask_pred = Conv2d(64, 1, 1)
        self.register_buffer("k_list", torch.from_numpy(
            depth_sampling_k_list(3, num_samples)), persistent=False)
        self.register_buffer("d_coords", torch.from_numpy(
            dbound[0] + dbound[2] * np.arange(D, dtype=np.float32)),
            persistent=False)

    def similarity(self, cost: torch.Tensor) -> torch.Tensor:
        """The per-group correlations [..., G] -> a score [...]: the one
        similarity net every range and EM iteration calls (its BatchNorms
        normalize the last axis over all the others, and in training move
        their statistics at each call)."""
        lead = cost.shape[:-1]
        y = F.relu(self.sim_bn0(self.sim_fc0(cost.reshape(-1,
                                                          cost.shape[-1]))))
        y = F.relu(self.sim_bn1(self.sim_fc1(y)))
        return self.sim_fc2(y).reshape(lead)

    def forward(self, key_feat, sweep_stereo, key_stereo, mlp_input,
                key_intrin, sweep_intrin, key2sweep_rot, key2sweep_tran):
        cd = key_feat.dtype
        context, mono_depth, mu_all, sigma_all, range_hi = self.depth_net(
            key_feat, mlp_input)
        BN, Cs, sH, sW = key_stereo.shape
        G, S = self.num_groups, self.num_samples
        d0, _, dd = self.dbound
        # channels-last, as the plane sweep and the cost volume run
        sweep = sweep_stereo.permute(0, 2, 3, 1)
        ref = key_stereo.permute(0, 2, 3, 1).reshape(BN, 1, sH, sW, G,
                                                     Cs // G)
        range_score = softmax(range_hi, dim=1)  # [BN, R, 4fH, 4fW]
        stereo_depth = torch.zeros((BN, len(self.d_coords), sH, sW),
                                   dtype=torch.float32,
                                   device=key_feat.device)
        for r, (lo, hi) in enumerate(self.range_list):
            mu = torch.sigmoid(mu_all[:, r]) * weak(hi - lo, cd) \
                + weak(lo, cd)
            sigma = sigma_all[:, r] + weak(0.1, cd)
            mu, sigma = mu[:, :sH, :sW], sigma[:, :sH, :sW]
            for _ in range(self.em_iteration):
                # k_list is fp32: the samples, and all that reads them, too
                samples = torch.stack([mu.float() + sigma.float() * k
                                       for k in self.k_list], 1)
                warped = homo_warp(sweep, samples, key_intrin, sweep_intrin,
                                   key2sweep_rot, key2sweep_tran,
                                   self.stereo_downsample)
                cost = (ref * warped.reshape(BN, S, sH, sW, G, Cs // G)
                        ).mean(-1)  # [BN, S, sH, sW, G]
                score = softmax(self.similarity(cost.to(cd)), dim=1)
                center = score[:, S // 2]
                scale = torch.clamp(0.5 / (weak(1e-4, cd) + center),
                                    0.1, 10.0)
                sigma = torch.clamp(sigma * scale, 0.1, 10.0)
                mu = (samples * score).sum(1)
            mu = torch.clamp(mu, lo, hi)
            sigma = torch.clamp(sigma, min=1.0)  # JAX's min_sigma
            b_lo, n_bins = int((lo - d0) // dd), int((hi - lo) // dd)
            bins = self.d_coords[b_lo:b_lo + n_bins]
            g = torch.exp(-0.5 * ((bins[None, :, None, None] - mu[:, None])
                                  / torch.sqrt(sigma)[:, None]) ** 2)
            g = g / (sigma[:, None] * weak(math.sqrt(2 * math.pi), cd)
                     + weak(1e-6, cd))
            g = g * range_score[:, r:r + 1, :sH, :sW]
            stereo_depth[:, b_lo:b_lo + n_bins] += g

        # the stereo depth brought to the LSS stride (4 -> 16), gated into
        # the mono depth
        y = F.relu(self.dds_bn0(self.dds_conv0(stereo_depth.to(cd))))
        y = F.relu(self.dds_bn1(self.dds_conv1(y)))
        y = self.dds_pred(y)
        m = F.relu(self.mask_bn0(self.mask_conv0(
            torch.cat([mono_depth, y], dim=1))))
        m = self.mask_block1(self.mask_block0(m))
        depth = mono_depth + y * torch.sigmoid(self.mask_pred(m))
        return context, softmax(depth, dim=1)
