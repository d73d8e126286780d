"""JAX variables -> the port's state_dict (reference checkpoint names).

The inverse of coocc_tpu/train/convert_torch.py:convert_coocc_ray, written
without importing it. The port's modules carry the reference Co-Occ
checkpoint's state_dict names, so one set of weights feeds both packages: a
Co-Occ `.pth` loads straight into the port, and JAX variables come across
through `state_dict_from_jax`.

Layouts (JAX -> torch):
  Conv2d / deconv2d / DCN  [kh, kw, I, O]      -> [O, I, kh, kw]
  Conv3d                   [k0, k1, k2, I, O]  -> [O, I, k0, k1, k2]
  deconv3d                 [k0, k1, k2, O, I]  -> [I, O, k0, k1, k2]
  Linear                   [I, O]              -> [O, I]
  spconv                   [k^3 taps (kx, ky, kz), I, O] -> [O, kz, ky, kx, I]
  BN                       scale/bias + batch_stats mean/var
                           -> weight/bias/running_mean/running_var
  GN, LN                   scale/bias -> weight/bias
  Swin PatchMerging        position-major 4C (JAX) -> channel-major 4C
                           (the reference's Unfold order), `_swin`
The renderer's heads (renderer/sigma_head, renderer/rgb_head, which JAX
creates in training) become sigma_head / rgb_head, the names
convert_coocc_ray reads (convert_torch.py:518-521). The stereo depth net
(`lss.stereo`) has no reference names: its entries follow the flax scopes
(`_depthnet_stereo`), and `stereo_depth_net_to_jax` is their inverse.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from .config.base import CoOccConfig
from .nn.resnet2d import RESNET_LAYERS
from .nn.sparse_enc_packed_hd import ENCODER_CHANNELS
from .nn.swin import _rel_pos_index


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
    """Reads the JAX trees by '/'-path and writes torch tensors by name.
    `_Reader` has the same methods the other way round."""

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

    def conv3d(self, t, f, inner="conv", bias=False):
        f = f"{f}/{inner}" if inner else f
        self.put(f"{t}.weight", _get(self.params, f"{f}/kernel")
                 .transpose(4, 3, 0, 1, 2))
        if bias:
            self.put(f"{t}.bias", _get(self.params, f"{f}/bias"))

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

    def ln(self, t, f, perm=None):
        """A LayerNorm; `perm` reorders its features (PatchMerging's)."""
        for tn, fn in (("weight", "scale"), ("bias", "bias")):
            v = _get(self.params, f"{f}/{fn}")
            self.put(f"{t}.{tn}", v if perm is None else v[perm])

    def raw(self, t, f):
        self.put(t, _get(self.params, f))

    def spconv(self, t, f, name="weight"):
        w = _get(self.params, f"{f}/{name}")  # [k^3, I, O], kx-major taps
        k = round(w.shape[0] ** (1 / 3))
        w = w.reshape(k, k, k, *w.shape[1:])  # [kx, ky, kz, I, O]
        self.put(f"{t}.weight", w.transpose(4, 2, 1, 0, 3))

    def dcn(self, t, f):
        """The deformable conv's weight [3, 3, I/g, O] -> [O, I/g, 3, 3]."""
        self.put(f"{t}.weight", _get(self.params, f"{f}/weight")
                 .transpose(3, 2, 0, 1))


class _Reader:
    """A port state_dict -> JAX {"params", "batch_stats"} trees of numpy
    arrays, by the same calls as `_Writer` (the inverse of each layout)."""

    def __init__(self, sd):
        self.sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach")
                   else np.asarray(v) for k, v in sd.items()}
        self.tree = {"params": {}, "batch_stats": {}}

    def _set(self, col, path, value):
        node = self.tree[col]
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.array(value)

    def conv2d(self, t, f, inner="conv"):
        f = f"{f}/{inner}" if inner else f
        self._set("params", f"{f}/kernel",
                  self.sd[f"{t}.weight"].transpose(2, 3, 1, 0))
        if f"{t}.bias" in self.sd:
            self._set("params", f"{f}/bias", self.sd[f"{t}.bias"])

    def dense(self, t, f, conv1x1=False):
        w = self.sd[f"{t}.weight"]
        self._set("params", f"{f}/kernel", (w[:, :, 0, 0] if conv1x1
                                            else w).T)
        self._set("params", f"{f}/bias", self.sd[f"{t}.bias"])

    def bn(self, t, f):
        self._set("params", f"{f}/scale", self.sd[f"{t}.weight"])
        self._set("params", f"{f}/bias", self.sd[f"{t}.bias"])
        self._set("batch_stats", f"{f}/mean", self.sd[f"{t}.running_mean"])
        self._set("batch_stats", f"{f}/var", self.sd[f"{t}.running_var"])

    def dcn(self, t, f):
        self._set("params", f"{f}/weight",
                  self.sd[f"{t}.weight"].transpose(2, 3, 1, 0))

    def gn(self, t, f):
        self._set("params", f"{f}/scale", self.sd[f"{t}.weight"])
        self._set("params", f"{f}/bias", self.sd[f"{t}.bias"])

    def ln(self, t, f, perm=None):
        for tn, fn in (("weight", "scale"), ("bias", "bias")):
            v = self.sd[f"{t}.{tn}"]
            self._set("params", f"{f}/{fn}", v if perm is None else v[perm])

    def raw(self, t, f):
        self._set("params", f, self.sd[t])

    def spconv(self, t, f, name="weight"):
        w = self.sd[f"{t}.weight"]               # [O, kz, ky, kx, I]
        self._set("params", f"{f}/{name}", w.transpose(3, 2, 1, 4, 0)
                  .reshape(-1, w.shape[4], w.shape[0]))


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


def _merge_perm(c4: int, to_port: bool) -> np.ndarray:
    """PatchMerging's 4C features: JAX's position-major q = pos * C + c
    against the reference's channel-major r = c * 4 + pos (JAX's
    convert_swin reads feature r(q) = (q % C) * 4 + q // C into q). With
    `to_port` the inverse permutation (port feature r <- JAX's q)."""
    q = np.arange(c4)
    r = (q % (c4 // 4)) * 4 + q // (c4 // 4)
    return np.argsort(r) if to_port else r


def _swin_block(w, t, f, to_port):
    """A SwinBlock: the reference's names (attn.w_msa.*, ffn.layers.*)
    <-> JAX's scopes (attn/*, ffn_fc1, ffn_fc2)."""
    w.ln(f"{t}.norm1", f"{f}/norm1")
    w.raw(f"{t}.attn.w_msa.relative_position_bias_table",
          f"{f}/attn/relative_position_bias_table")
    w.dense(f"{t}.attn.w_msa.qkv", f"{f}/attn/qkv")
    w.dense(f"{t}.attn.w_msa.proj", f"{f}/attn/proj")
    w.ln(f"{t}.norm2", f"{f}/norm2")
    w.dense(f"{t}.ffn.layers.0.0", f"{f}/ffn_fc1")
    w.dense(f"{t}.ffn.layers.1", f"{f}/ffn_fc2")
    if to_port:
        # the reference's checkpoint carries the index as a buffer
        ws = round((1 + math.sqrt(_get(
            w.params, f"{f}/attn/relative_position_bias_table")
            .shape[0])) / 2)
        w.put(f"{t}.attn.w_msa.relative_position_index",
              _rel_pos_index(ws, ws))


def _swin(w, t, f, depths, out_indices, to_port):
    """The Swin backbone's reference names <-> JAX's scopes
    (convert_torch.py:287-326)."""
    w.conv2d(f"{t}.patch_embed.projection", f"{f}/patch_embed", None)
    w.ln(f"{t}.patch_embed.norm", f"{f}/patch_norm")
    for i, d in enumerate(depths):
        for j in range(d):
            _swin_block(w, f"{t}.stages.{i}.blocks.{j}",
                        f"{f}/stage{i}_block{j}", to_port)
        if i < len(depths) - 1:
            td, fd = f"{t}.stages.{i}.downsample", f"{f}/downsample{i}"
            if to_port:
                k = _get(w.params, f"{fd}/reduction/kernel")   # [4C, out]
                perm = _merge_perm(k.shape[0], True)
                w.put(f"{td}.reduction.weight", k.T[:, perm])
            else:
                k = w.sd[f"{td}.reduction.weight"]           # [out, 4C]
                perm = _merge_perm(k.shape[1], False)
                w._set("params", f"{fd}/reduction/kernel", k[:, perm].T)
            w.ln(f"{td}.norm", f"{fd}/norm", perm)
    for i in out_indices:
        w.ln(f"{t}.norm{i}", f"{f}/out_norm{i}")


def swin_to_jax(sd: Dict[str, Any], depths=(2, 2, 6, 2),
                out_indices=(0, 1, 2, 3),
                prefix: str = "img_backbone") -> Dict[str, Dict]:
    """The Swin backbone's entries of a port state_dict (under `prefix`)
    -> JAX's {"params": ...} subtree of a SwinTransformer scope, nested
    dicts of numpy arrays: JAX's convert_swin on the port's names (the
    PatchMerging permutation as it applies it), the inverse of
    state_dict_from_jax for the backbone."""
    r = _Reader(sd)
    _swin(r, prefix, "swin", depths, out_indices, False)
    return {"params": r.tree["params"]["swin"]}


def _efficientnet(w: _Writer, t, f, arch, out_indices):
    """EfficientNet: JAX's scopes -> the reference's names, the inverse of
    JAX's convert_efficientnet (convert_torch.py:329-370)."""
    from .nn.efficientnet import scaled_layers
    for si, stage in enumerate(scaled_layers(arch)):
        if si > max(out_indices):
            break
        for bi, (_, _, se, _, e, bt) in enumerate(stage):
            fb = f"{f}/stage{si}_block{bi}"
            if bt == -1:
                w.conv2d(f"{t}.layers.{si}.conv", fb)
                w.bn(f"{t}.layers.{si}.bn", f"{fb}/bn/bn")
                continue
            parts = [("conv1", "expand"), ("conv2", "project")] if bt == 1 \
                else [("expand_conv", "expand")] * (e != 1) + [
                    ("depthwise_conv", "dw"), ("linear_conv", "project")]
            tb = f"{t}.layers.{si}.{bi}"
            for tn, fn in parts:
                w.conv2d(f"{tb}.{tn}.conv", f"{fb}/{fn}")
                w.bn(f"{tb}.{tn}.bn", f"{fb}/{fn}/bn/bn")
            if bt == 0 and se > 0:
                for k in (1, 2):
                    w.conv2d(f"{tb}.se.conv{k}.conv", f"{fb}/se/fc{k}")


def _bottleneck_aspp(w: _Writer, t, f):
    for name in ("input", "output"):
        w.conv2d(f"{t}.{name}_conv", f"{f}/{name}_conv")
        w.gn(f"{t}.{name}_gn", f"{f}/{name}_gn/gn")
    _aspp(w, f"{t}.aspp", f"{f}/aspp")


def _dualpath(w: _Writer, t, f, m):
    w.conv3d(f"{t}.input_conv", f"{f}/input_conv")
    w.bn(f"{t}.input_bn", f"{f}/input_bn/bn")
    _swin_block(w, f"{t}.bev_encoder", f"{f}/bev_encoder", True)
    _bottleneck_aspp(w, f"{t}.aspp", f"{f}/aspp")
    w.conv3d(f"{t}.combine_coeff", f"{f}/combine_coeff", bias=True)
    if hasattr(m, "downsample_conv"):
        w.conv3d(f"{t}.downsample_conv", f"{f}/downsample_conv")
        w.bn(f"{t}.downsample_bn", f"{f}/downsample_bn/bn")


def _flax_scoped(w: _Writer, t, f, m) -> None:
    """A module whose attributes' names are its flax scopes
    (`_flax_scoped_types`): each Linear's kernel transposed, each
    LayerNorm's scale and bias, each raw parameter as it is."""
    for name, _ in m.named_parameters():
        path, _, leaf = name.rpartition(".")
        sub = m.get_submodule(path)
        scope = "/".join([f] + (path.split(".") if path else []))
        if isinstance(sub, torch.nn.Linear):
            v = _get(w.params, f"{scope}/kernel").T if leaf == "weight" \
                else _get(w.params, f"{scope}/bias")
        elif isinstance(sub, torch.nn.LayerNorm):
            v = _get(w.params, f"{scope}/"
                     f"{'scale' if leaf == 'weight' else 'bias'}")
        else:
            v = _get(w.params, f"{scope}/{leaf}")
        w.put(f"{t}.{name}", v)


def _flax_scoped_types():
    from .nn import image2bev, mask2former_occ
    from .ops import ms_deform_attn
    return (ms_deform_attn.MSDeformAttn3D, image2bev.MSDeformableAttention2D,
            image2bev.DeformSelfAttention, image2bev.DeformCrossAttention,
            image2bev.VoxFormerLayer, image2bev.VoxFormerEncoder,
            image2bev.Image2BEVTransformer,
            mask2former_occ.Mask2FormerOccHead)


def _module(w: _Writer, m) -> None:
    """The walker of port module `m` (its names "m.*", JAX's scope "m")."""
    from .nn import alt_fusers, alt_necks, efficientnet, moe, occnet, swin
    t = f = "m"
    if isinstance(m, _flax_scoped_types()):
        _flax_scoped(w, t, f, m)
    elif isinstance(m, swin.SwinTransformer):
        _swin(w, t, f, [len(s.blocks) for s in m.stages], m.out_indices,
              True)
    elif isinstance(m, efficientnet.EfficientNet):
        _efficientnet(w, t, f, m.arch, m.out_indices)
    elif isinstance(m, occnet.OccupancyEncoder):
        for stage in m.names:
            for name in stage:
                _dualpath(w, f"{t}.{name}", f"{f}/{name}",
                          getattr(m, name))
    elif isinstance(m, occnet.DualpathTransformerBlock):
        _dualpath(w, t, f, m)
    elif isinstance(m, occnet.BottleNeckASPP):
        _bottleneck_aspp(w, t, f)
    elif isinstance(m, alt_necks.SECONDFPN2):
        for i, s in enumerate(m.upsample_strides):
            _second_fpn(w, f"{t}.deblock{i}", f"{f}/deblock{i}", [s])
    elif isinstance(m, alt_necks.GeneralizedLSSFPN):
        for i in range(m.n):
            for name in (f"lateral{i}", f"fpn{i}"):
                w.conv2d(f"{t}.{name}.conv", f"{f}/{name}/conv")
                w.bn(f"{t}.{name}.bn", f"{f}/{name}/bn/bn")
    elif isinstance(m, alt_necks.FPNRender):
        for i in range(m.n):
            for name in (f"lateral{i}", f"fpn{i}"):
                w.conv2d(f"{t}.{name}", f"{f}/{name}")
    elif isinstance(m, alt_fusers.AddFuser):
        w.conv3d(f"{t}.gate_conv", f"{f}/gate_conv", bias=True)
        w.conv3d(f"{t}.out_conv", f"{f}/out_conv")
        w.bn(f"{t}.out_bn", f"{f}/out_bn/bn")
    elif isinstance(m, alt_fusers.AttnFuser):
        C = m.out_conv.in_channels // 2
        for name in ("query", "key", "value", "out"):
            k = _get(w.params, f"{f}/cross_attn/{name}/kernel")
            b = _get(w.params, f"{f}/cross_attn/{name}/bias")
            w.put(f"{t}.cross_attn.{name}.weight", k.reshape(C, C).T)
            w.put(f"{t}.cross_attn.{name}.bias", b.reshape(C))
        w.conv3d(f"{t}.out_conv", f"{f}/out_conv")
        w.bn(f"{t}.out_bn", f"{f}/out_bn/bn")
    elif isinstance(m, moe.MoE):
        for name in ("w_gate", "w_noise"):
            if getattr(m, name) is not None:
                w.put(f"{t}.{name}.weight",
                      _get(w.params, f"{f}/{name}/kernel").T)
        for fc in ("fc1", "fc2"):
            w.put(f"{t}.experts.{fc}.weight", _get(
                w.params, f"{f}/experts/{fc}/kernel").transpose(0, 2, 1))
            w.raw(f"{t}.experts.{fc}.bias", f"{f}/experts/{fc}/bias")
    else:
        raise TypeError(f"no JAX counterpart known for {type(m).__name__}")


def module_state_dict_from_jax(module: torch.nn.Module,
                               variables: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """JAX {"params", "batch_stats"} trees of one module -> the state_dict
    of the port's counterpart `module` (its structure read from it):
    SwinTransformer (the reference's names, the PatchMerging permutation),
    EfficientNet (the reference's names: the inverse of JAX's
    convert_efficientnet), OccupancyEncoder, DualpathTransformerBlock,
    BottleNeckASPP, SECONDFPN2, GeneralizedLSSFPN, FPNRender, AddFuser,
    AttnFuser and MoE (the flax scopes' names); MSDeformAttn3D,
    MSDeformableAttention2D, DeformSelfAttention, DeformCrossAttention,
    VoxFormerLayer, VoxFormerEncoder, Image2BEVTransformer and
    Mask2FormerOccHead (their attributes the flax scopes, `_flax_scoped`:
    Dense kernels [in, out] -> Linear weights [out, in], the raw
    parameters as they are)."""
    w = _Writer({k: {"m": v} for k, v in variables.items()})
    _module(w, module)
    return {k[2:]: v for k, v in w.sd.items()}


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
        _basic_block(w, f"{t}.depth_conv.{i}", f"{f}/depth_block{i}")
    _aspp(w, f"{t}.depth_conv.3", f"{f}/aspp")
    _dcn(w, f"{t}.depth_conv.4", f"{f}/dcn")
    w.conv2d(f"{t}.depth_conv.5", f"{f}/depth_pred")


def _basic_block(w, t, f):
    for k in (1, 2):
        w.conv2d(f"{t}.conv{k}", f"{f}/conv{k}")
        w.bn(f"{t}.bn{k}", f"{f}/bn{k}/bn")


def _aspp(w, t, f):
    for i in range(1, 5):
        w.conv2d(f"{t}.aspp{i}.atrous_conv", f"{f}/aspp{i}/atrous_conv")
        w.bn(f"{t}.aspp{i}.bn", f"{f}/aspp{i}/bn/bn")
    w.conv2d(f"{t}.global_avg_pool.1", f"{f}/gap_conv")
    w.bn(f"{t}.global_avg_pool.2", f"{f}/gap_bn/bn")
    w.conv2d(f"{t}.conv1", f"{f}/conv1")
    w.bn(f"{t}.bn1", f"{f}/bn1/bn")


def _dcn(w, t, f):
    w.conv2d(f"{t}.conv_offset", f"{f}/conv_offset")
    w.dcn(t, f)


def _depthnet_stereo(w, t, f):
    """LSSBEVStereo (nn/lss_stereo.py) <-> JAX's, by the flax scopes (the
    reference ships no stereo names): its DepthNetStereo under
    `depth_net`, the similarity net, the downsampling convs and the mask
    net beside it."""
    td, fd = f"{t}.depth_net", f"{f}/depth_net"
    w.bn(f"{td}.bn", f"{fd}/bn/bn")
    for name in ("reduce_conv", "context_conv", "msr_pred", "mono_pred"):
        w.conv2d(f"{td}.{name}", f"{fd}/{name}")
    for name in ("reduce_bn", "msr_bn0", "msr_bn1"):
        w.bn(f"{td}.{name}", f"{fd}/{name}/bn")
    for kind in ("context", "depth"):
        for fc in ("fc1", "fc2"):
            w.dense(f"{td}.{kind}_mlp.{fc}", f"{fd}/{kind}_mlp/{fc}/linear")
        for c in ("conv_reduce", "conv_expand"):
            w.dense(f"{td}.{kind}_se.{c}", f"{fd}/{kind}_se/{c}/linear",
                    conv1x1=True)
    for name in ("depth_block0", "depth_block1", "msr_block", "mono_block"):
        _basic_block(w, f"{td}.{name}", f"{fd}/{name}")
    _aspp(w, f"{td}.aspp", f"{fd}/aspp")
    _dcn(w, f"{td}.dcn", f"{fd}/dcn")
    for i in range(2):
        w.conv2d(f"{td}.msr_deconv{i}", f"{fd}/msr_deconv{i}", None)
    for i in range(3):
        w.dense(f"{t}.sim_fc{i}", f"{f}/sim_fc{i}/linear")
    for name in ("dds_conv0", "dds_conv1", "dds_pred", "mask_conv0",
                 "mask_pred"):
        w.conv2d(f"{t}.{name}", f"{f}/{name}")
    for name in ("sim_bn0", "sim_bn1", "dds_bn0", "dds_bn1", "mask_bn0"):
        w.bn(f"{t}.{name}", f"{f}/{name}/bn")
    for i in range(2):
        _basic_block(w, f"{t}.mask_block{i}", f"{f}/mask_block{i}")


def stereo_depth_net_to_jax(sd: Dict[str, Any],
                            prefix: str = "img_view_transformer.depth_net"
                            ) -> Dict[str, Dict]:
    """The stereo depth net's entries of a port state_dict (under
    `prefix`) -> JAX's {"params", "batch_stats"} subtrees of that
    LSSBEVStereo scope, nested dicts of numpy arrays (JAX's
    convert_coocc_ray has no stereo names; this is the inverse of
    state_dict_from_jax for the subtree)."""
    r = _Reader(sd)
    _depthnet_stereo(r, prefix, "depth_net")
    return {k: v["depth_net"] for k, v in r.tree.items()}


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


def _sparse_enc4x(w: _Writer, t, f):
    """JAX's SparseLiDAREnc4x scopes <-> the port's names
    (nn/sparse_enc.py): conv_input, gn_input, res1_{0,1} (conv1.{0,1}),
    down{2,3} and res{2,3}_{0,1} (conv{2,3}), conv_out, gn_out."""
    w.spconv(f"{t}.conv_input.0", f"{f}/conv_input")
    w.gn(f"{t}.conv_input.1", f"{f}/gn_input/gn")
    for lvl in (1, 2, 3):
        tl = f"{t}.conv{lvl}"
        if lvl > 1:
            w.spconv(f"{tl}.0.0", f"{f}/down{lvl}")
            w.bn(f"{tl}.0.1", f"{f}/down{lvl}/norm/bn")
        for blk in (0, 1):
            tb = f"{tl}.{blk + (lvl > 1)}.net"
            fb = f"{f}/res{lvl}_{blk}"
            w.spconv(f"{tb}.0", f"{fb}/conv1")
            w.bn(f"{tb}.1", f"{fb}/norm1/bn")
            w.spconv(f"{tb}.3", f"{fb}/conv2")
            w.bn(f"{tb}.4", f"{fb}/norm2/bn")
    w.spconv(f"{t}.conv_out.0", f"{f}/conv_out")
    w.gn(f"{t}.conv_out.1", f"{f}/gn_out/gn")


def sparse_enc4x_to_jax(sd: Dict[str, Any]) -> Dict[str, Dict]:
    """A port SparseLiDAREnc4x's state_dict -> JAX's {"params",
    "batch_stats"} trees of that module, nested dicts of numpy arrays: the
    inverse of state_dict_from_jax for the encoder (JAX's
    convert_coocc_ray sends Enc4x through its Enc8x names, which an Enc4x
    tree does not have)."""
    r = _Reader({f"enc.{k}": v for k, v in sd.items()})
    _sparse_enc4x(r, "enc", "enc")
    return {k: v["enc"] for k, v in r.tree.items()}


def _sparse_encoder_hd(w: _Writer, t, f):
    """JAX's PackedEncoderHD scopes -> the reference SparseEncoderHD's
    names (convert_torch.py:254-285)."""
    w.spconv(f"{t}.conv_input.0", f"{f}/conv_input")
    w.bn(f"{t}.conv_input.1", f"{f}/norm_input/bn")
    last = len(ENCODER_CHANNELS) - 1
    for i, blocks in enumerate(ENCODER_CHANNELS):
        for j in range(len(blocks)):
            tb = f"{t}.encoder_layers.encoder_layer{i + 1}.{j}"
            if j == len(blocks) - 1 and i != last:
                w.spconv(f"{tb}.0", f"{f}/stage{i}_down")
                w.bn(f"{tb}.1", f"{f}/stage{i}_down/norm/bn")
            else:
                for k in (1, 2):
                    fb = f"{f}/stage{i}_block{j}"
                    w.spconv(f"{tb}.conv{k}", f"{fb}/conv{k}")
                    w.bn(f"{tb}.norm{k}", f"{fb}/norm{k}/bn")
    w.spconv(f"{t}.conv_out.0", f, "conv_out_weight")
    w.bn(f"{t}.conv_out.1", f"{f}/norm_out/bn")


def _second3d(w: _Writer, t, f, layer_nums):
    for i, n in enumerate(layer_nums):
        for j in range(n + 1):
            w.conv3d(f"{t}.blocks.{i}.{3 * j}", f"{f}/block{i}_conv{j}")
            w.bn(f"{t}.blocks.{i}.{3 * j + 1}", f"{f}/block{i}_bn{j}/bn")


def _second3d_fpn(w: _Writer, t, f, strides, extra_num_conv):
    for i, s in enumerate(strides):
        if s > 1:
            w.conv3d(f"{t}.deblocks.{i}.0", f"{f}/deblock{i}_deconv", None)
        else:
            w.conv3d(f"{t}.deblocks.{i}.0", f"{f}/deblock{i}_conv")
        w.bn(f"{t}.deblocks.{i}.1", f"{f}/deblock{i}_bn/bn")
    for j in range(extra_num_conv):
        w.conv3d(f"{t}.extra_blocks.{3 * j}", f"{f}/extra{j}_conv")
        w.bn(f"{t}.extra_blocks.{3 * j + 1}", f"{f}/extra{j}_bn/bn")


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


def _nerf_mlp(w: _Writer, t, f, depth):
    for i in range(depth):
        w.dense(f"{t}.hidden_layers.{i}", f"{f}/hidden{i}")
    w.dense(f"{t}.output_layer", f"{f}/output")


def state_dict_from_jax(variables_np: Dict[str, Any],
                        cfg: CoOccConfig) -> Dict[str, torch.Tensor]:
    """JAX {"params", "batch_stats"} trees (nested dicts of arrays) of a
    CoOccRay -> state_dict for coocc_tpu_torch.models.CoOccRay(cfg)."""
    from .nn.resnet3d import RESNET3D_LAYERS
    w = _Writer(variables_np)
    if cfg.use_camera and cfg.img_backbone.type == "SwinTransformer":
        _swin(w, "img_backbone", "img_backbone",
              cfg.img_backbone.swin_depths, cfg.img_backbone.out_indices,
              True)
    elif cfg.use_camera:
        _resnet(w, "img_backbone", "img_backbone", cfg.img_backbone.depth)
    if cfg.use_camera:
        _second_fpn(w, "img_neck", "img_neck", cfg.img_neck.upsample_strides)
        (_depthnet_stereo if cfg.lss.stereo else _depthnet)(
            w, "img_view_transformer.depth_net",
            "img_view_transformer/depth_net")
    if cfg.use_lidar and cfg.pts.encoder == "SparseEncoderHD":
        _sparse_encoder_hd(w, "pts_middle_encoder", "pts_middle_encoder")
        if cfg.second3d is not None:
            s3 = cfg.second3d
            _second3d(w, "pts_backbone", "pts_backbone", s3.layer_nums)
            _second3d_fpn(w, "pts_neck", "pts_neck", s3.fpn_upsample_strides,
                          s3.fpn_extra_num_conv)
    elif cfg.use_lidar and cfg.pts.encoder == "SparseLiDAREnc4x":
        _sparse_enc4x(w, "pts_middle_encoder", "pts_middle_encoder")
    elif cfg.use_lidar:
        _sparse_enc8x(w, "pts_middle_encoder", "pts_middle_encoder")
    if cfg.fuser is not None:
        _bifuser(w, "occ_fuser", "occ_fuser")
    _resnet3d(w, "semantic_encoder", "semantic_encoder",
              RESNET3D_LAYERS[cfg.semantic.depth])
    _fpn3d(w, "semantic_neck", "semantic_neck",
           len(cfg.semantic.block_inplanes))
    _occ_head(w, "pts_bbox_head", "pts_bbox_head", cfg.occ_head.num_level)
    if cfg.render.use_rendering:
        _nerf_mlp(w, "sigma_head", "renderer/sigma_head", 1)
        if cfg.use_camera:
            _nerf_mlp(w, "rgb_head", "renderer/rgb_head", 3)
    return w.sd
