"""JAX variables -> the port's state_dict (reference checkpoint names).

The inverse of coocc_tpu/train/convert_torch.py:convert_coocc_ray, written
without importing it. The port's modules carry the reference Co-Occ
checkpoint's state_dict names, so one set of weights feeds both packages: a
Co-Occ `.pth` loads straight into the port, and JAX variables come across
through `state_dict_from_jax`.

Layouts (JAX -> torch):
  Conv2d / deconv2d / DCN  [kh, kw, I, O]      -> [O, I, kh, kw]
  Conv3d                   [k0, k1, k2, I, O]  -> [O, I, k0, k1, k2]
  Linear                   [I, O]              -> [O, I]
  spconv                   [27 taps (kx, ky, kz), I, O] -> [O, kz, ky, kx, I]
  BN                       scale/bias + batch_stats mean/var
                           -> weight/bias/running_mean/running_var
  GN                       scale/bias -> weight/bias
The renderer's sigma_head / rgb_head (off at eval) are skipped.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config.base import CoOccConfig
from .nn.resnet2d import RESNET_LAYERS


def _get(tree, path: str):
    node = tree
    for p in path.split("/"):
        node = node[p]
    return np.asarray(node)


def _has(tree, path: str) -> bool:
    node = tree
    for p in path.split("/"):
        if not isinstance(node, dict) or p not in node:
            return False
        node = node[p]
    return True


class _Writer:
    """Reads the JAX trees by '/'-path and writes torch tensors by name."""

    def __init__(self, variables):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, name, value):
        self.sd[name] = torch.from_numpy(np.array(value))  # owned copy

    def conv2d(self, t, f, inner="conv"):
        f = f"{f}/{inner}" if inner else f
        self.put(f"{t}.weight", _get(self.params, f"{f}/kernel")
                 .transpose(3, 2, 0, 1))
        if _has(self.params, f"{f}/bias"):
            self.put(f"{t}.bias", _get(self.params, f"{f}/bias"))

    def conv3d(self, t, f):
        self.put(f"{t}.weight", _get(self.params, f"{f}/conv/kernel")
                 .transpose(4, 3, 0, 1, 2))

    def dense(self, t, f, conv1x1=False):
        w = _get(self.params, f"{f}/kernel").T
        self.put(f"{t}.weight", w[:, :, None, None] if conv1x1 else w)
        self.put(f"{t}.bias", _get(self.params, f"{f}/bias"))

    def bn(self, t, f):
        self.put(f"{t}.weight", _get(self.params, f"{f}/scale"))
        self.put(f"{t}.bias", _get(self.params, f"{f}/bias"))
        self.put(f"{t}.running_mean", _get(self.stats, f"{f}/mean"))
        self.put(f"{t}.running_var", _get(self.stats, f"{f}/var"))

    def gn(self, t, f):
        self.put(f"{t}.weight", _get(self.params, f"{f}/scale"))
        self.put(f"{t}.bias", _get(self.params, f"{f}/bias"))

    def spconv(self, t, f):
        w = _get(self.params, f"{f}/weight")  # [27, I, O], kx-major taps
        w = w.reshape(3, 3, 3, *w.shape[1:])  # [kx, ky, kz, I, O]
        self.put(f"{t}.weight", w.transpose(4, 2, 1, 0, 3))


def _resnet(w: _Writer, t, f, depth):
    w.conv2d(f"{t}.conv1", f"{f}/conv1")
    w.bn(f"{t}.bn1", f"{f}/bn1/bn")
    for i, n in enumerate(RESNET_LAYERS[depth]):
        for j in range(n):
            tb, fb = f"{t}.layer{i + 1}.{j}", f"{f}/layer{i + 1}_{j}"
            for k in (1, 2, 3):
                if _has(w.params, f"{fb}/conv{k}"):
                    w.conv2d(f"{tb}.conv{k}", f"{fb}/conv{k}")
                    w.bn(f"{tb}.bn{k}", f"{fb}/bn{k}/bn")
            if _has(w.params, f"{fb}/downsample_conv"):
                w.conv2d(f"{tb}.downsample.0", f"{fb}/downsample_conv")
                w.bn(f"{tb}.downsample.1", f"{fb}/downsample_bn/bn")


def _second_fpn(w: _Writer, t, f, strides):
    for i, s in enumerate(strides):
        if s >= 1:
            w.conv2d(f"{t}.deblocks.{i}.0", f"{f}/deblock{i}_deconv", None)
        else:
            w.conv2d(f"{t}.deblocks.{i}.0", f"{f}/deblock{i}_conv")
        w.bn(f"{t}.deblocks.{i}.1", f"{f}/deblock{i}_bn/bn")


def _depthnet(w: _Writer, t, f):
    w.conv2d(f"{t}.reduce_conv.0", f"{f}/reduce_conv")
    w.bn(f"{t}.reduce_conv.1", f"{f}/reduce_bn/bn")
    w.conv2d(f"{t}.context_conv", f"{f}/context_conv")
    w.bn(f"{t}.bn", f"{f}/bn/bn")
    for mlp in ("depth_mlp", "context_mlp"):
        for fc in ("fc1", "fc2"):
            w.dense(f"{t}.{mlp}.{fc}", f"{f}/{mlp}/{fc}/linear")
    for se in ("depth_se", "context_se"):
        for c in ("conv_reduce", "conv_expand"):
            w.dense(f"{t}.{se}.{c}", f"{f}/{se}/{c}/linear", conv1x1=True)
    for i in range(3):
        tb, fb = f"{t}.depth_conv.{i}", f"{f}/depth_block{i}"
        for k in (1, 2):
            w.conv2d(f"{tb}.conv{k}", f"{fb}/conv{k}")
            w.bn(f"{tb}.bn{k}", f"{fb}/bn{k}/bn")
    ta, fa = f"{t}.depth_conv.3", f"{f}/aspp"
    for i in range(1, 5):
        w.conv2d(f"{ta}.aspp{i}.atrous_conv", f"{fa}/aspp{i}/atrous_conv")
        w.bn(f"{ta}.aspp{i}.bn", f"{fa}/aspp{i}/bn/bn")
    w.conv2d(f"{ta}.global_avg_pool.1", f"{fa}/gap_conv")
    w.bn(f"{ta}.global_avg_pool.2", f"{fa}/gap_bn/bn")
    w.conv2d(f"{ta}.conv1", f"{fa}/conv1")
    w.bn(f"{ta}.bn1", f"{fa}/bn1/bn")
    w.conv2d(f"{t}.depth_conv.4.conv_offset", f"{f}/dcn/conv_offset")
    w.put(f"{t}.depth_conv.4.weight",
          _get(w.params, f"{f}/dcn/weight").transpose(3, 2, 0, 1))
    w.conv2d(f"{t}.depth_conv.5", f"{f}/depth_pred")


def _sparse_enc8x(w: _Writer, t, f):
    w.spconv(f"{t}.conv_input.0", f"{f}/conv_input")
    w.gn(f"{t}.conv_input.1", f"{f}/gn_input/gn")
    for lvl in (1, 2, 3):
        tl = f"{t}.conv{lvl}"
        w.spconv(f"{tl}.0.0", f"{f}/down{lvl}")
        w.bn(f"{tl}.0.1", f"{f}/down{lvl}/norm/bn")
        for blk in (1, 2):
            tb, fb = f"{tl}.{blk}.net", f"{f}/res{lvl}_{blk - 1}"
            w.spconv(f"{tb}.0", f"{fb}/conv1")
            w.bn(f"{tb}.1", f"{fb}/norm1/bn")
            w.spconv(f"{tb}.3", f"{fb}/conv2")
            w.bn(f"{tb}.4", f"{fb}/norm2/bn")
    w.spconv(f"{t}.conv_out.0", f"{f}/conv_out")
    w.gn(f"{t}.conv_out.1", f"{f}/gn_out/gn")


def _bifuser(w: _Writer, t, f):
    w.dense(f"{t}.knn_enc.0", f"{f}/knn_enc/linear")
    w.conv3d(f"{t}.con_enc.0", f"{f}/con_enc0")
    w.bn(f"{t}.con_enc.1", f"{f}/con_bn0/bn")
    w.conv3d(f"{t}.con_enc.3", f"{f}/con_enc1")
    w.bn(f"{t}.con_enc.4", f"{f}/con_bn1/bn")


def _resnet3d(w: _Writer, t, f, layers):
    w.conv3d(f"{t}.input_proj.0", f"{f}/input_proj_conv")
    w.bn(f"{t}.input_proj.1", f"{f}/input_proj_bn/bn")
    for i, n in enumerate(layers):
        for j in range(n):
            tb, fb = f"{t}.layers.{i}.{j}", f"{f}/layer{i}_{j}"
            for k in (1, 2):
                w.conv3d(f"{tb}.conv{k}", f"{fb}/conv{k}")
                w.bn(f"{tb}.bn{k}", f"{fb}/bn{k}/bn")
            if _has(w.params, f"{fb}/downsample_conv"):
                w.conv3d(f"{tb}.downsample.0", f"{fb}/downsample_conv")
                w.bn(f"{tb}.downsample.1", f"{fb}/downsample_bn/bn")


def _fpn3d(w: _Writer, t, f, n_levels):
    for i in range(n_levels):
        for tn, fn in (("lateral_convs", "lateral"), ("fpn_convs", "fpn")):
            w.conv3d(f"{t}.{tn}.{i}.0.conv", f"{f}/{fn}{i}/conv")
            w.bn(f"{t}.{tn}.{i}.0.bn", f"{f}/{fn}{i}/bn/bn")


def _occ_head(w: _Writer, t, f, num_level):
    for i in range(num_level):
        w.conv3d(f"{t}.occ_convs.{i}.0", f"{f}/occ_conv{i}/conv")
        w.bn(f"{t}.occ_convs.{i}.1", f"{f}/occ_conv{i}/bn/bn")
    w.conv3d(f"{t}.occ_pred_conv.0", f"{f}/pred_conv0")
    w.bn(f"{t}.occ_pred_conv.1", f"{f}/pred_bn/bn")
    w.conv3d(f"{t}.occ_pred_conv.3", f"{f}/pred_conv1")
    if _has(w.params, f"{f}/soft_w_conv0"):
        w.conv3d(f"{t}.voxel_soft_weights.0", f"{f}/soft_w_conv0")
        w.bn(f"{t}.voxel_soft_weights.1", f"{f}/soft_w_bn/bn")
        w.conv3d(f"{t}.voxel_soft_weights.3", f"{f}/soft_w_conv1")
    if _has(w.params, f"{f}/fine_mlp_fc1"):
        w.dense(f"{t}.fine_mlp.0", f"{f}/fine_mlp_fc1/linear")
        w.gn(f"{t}.fine_mlp.1", f"{f}/fine_mlp_gn/gn")
        w.dense(f"{t}.fine_mlp.3", f"{f}/fine_mlp_fc2/linear")
    if _has(w.params, f"{f}/img_mlp_0_conv"):
        w.conv2d(f"{t}.img_mlp_0.0", f"{f}/img_mlp_0_conv", None)
        w.gn(f"{t}.img_mlp_0.1", f"{f}/img_mlp_0_gn/gn")
        w.dense(f"{t}.img_mlp.0", f"{f}/img_mlp_fc/linear")
        w.gn(f"{t}.img_mlp.1", f"{f}/img_mlp_gn/gn")


def state_dict_from_jax(variables_np: Dict[str, Any],
                        cfg: CoOccConfig) -> Dict[str, torch.Tensor]:
    """JAX {"params", "batch_stats"} trees (nested dicts of arrays) of a
    CoOccRay -> state_dict for coocc_tpu_torch.models.CoOccRay(cfg)."""
    from .nn.resnet3d import RESNET3D_LAYERS
    w = _Writer(variables_np)
    if cfg.use_camera:
        _resnet(w, "img_backbone", "img_backbone", cfg.img_backbone.depth)
        _second_fpn(w, "img_neck", "img_neck", cfg.img_neck.upsample_strides)
        _depthnet(w, "img_view_transformer.depth_net",
                  "img_view_transformer/depth_net")
    if cfg.use_lidar:
        _sparse_enc8x(w, "pts_middle_encoder", "pts_middle_encoder")
    if cfg.fuser is not None:
        _bifuser(w, "occ_fuser", "occ_fuser")
    _resnet3d(w, "semantic_encoder", "semantic_encoder",
              RESNET3D_LAYERS[cfg.semantic.depth])
    _fpn3d(w, "semantic_neck", "semantic_neck",
           len(cfg.semantic.block_inplanes))
    _occ_head(w, "pts_bbox_head", "pts_bbox_head", cfg.occ_head.num_level)
    return w.sd
