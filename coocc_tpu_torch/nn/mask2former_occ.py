"""Mask2Former occupancy head (capability-envelope component).

Counterpart of coocc_tpu/nn/mask2former_occ.py (the reference's
mask2former package, mask2former_nusc_occ.py and its positional encoding,
Hungarian assigner and dice loss): learnable queries decode per-query class
scores and 3D mask embeddings against a multi-scale voxel feature pyramid
through masked cross-attention; the occupancy volume is
softmax(cls)[..., :-1] x sigmoid(mask) (`format_results`). No `CoOccRay`
route reaches it.

The pyramid comes channels-first ([B, C, X, Y, Z] a level, the port's 3D
convs' layout); masks are [B, Q, X, Y, Z] and the composed `occ`
channels-last [B, X, Y, Z, num_classes], as JAX's. The decoder runs all
queries as one batched attention with an additive -1e9 mask and an fp32
softmax; the attention mask is the max-pooled mask prediction (integer
ratios). The training loss matches queries to ground-truth classes on the
host (scipy's Hungarian solver on JAX's numpy cost) and computes its terms
in torch fp32 on the predictions' device, so they carry a gradient.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.constants import device_constant
from ..ops.grid_sample import grid_sample_3d
from .image2bev import LN_EPS
from .layers import LayerNorm, Linear, flax_apply, softmax, weak


def sine_positional_encoding_3d(shape: Tuple[int, int, int], num_feats: int,
                                temperature: float = 10000.0,
                                normalize: bool = True,
                                scale: float = 2 * math.pi) -> np.ndarray:
    """[X, Y, Z, 3*num_feats] sine/cosine position embedding (numpy fp32,
    JAX's arithmetic): per axis the cumsum of ones normalized to
    [0, scale], even channels sin and odd cos (an odd num_feats too), the
    three axes concatenated (x | y | z)."""
    X, Y, Z = shape
    eps = np.float32(1e-6)

    def axis_embed(n):
        e = np.arange(1, n + 1, dtype=np.float32)
        if normalize:
            e = e / np.float32(n + eps) * np.float32(scale)
        return e

    dim_t = np.float32(temperature) ** (
        np.float32(2.0) * (np.arange(num_feats, dtype=np.float32) // 2)
        / np.float32(num_feats))

    def pos(e):
        p = e[:, None] / dim_t
        even = np.arange(num_feats) % 2 == 0
        return np.where(even[None], np.sin(p), np.cos(p)).astype(np.float32)

    px = np.broadcast_to(pos(axis_embed(X))[:, None, None, :],
                         (X, Y, Z, num_feats))
    py = np.broadcast_to(pos(axis_embed(Y))[None, :, None, :],
                         (X, Y, Z, num_feats))
    pz = np.broadcast_to(pos(axis_embed(Z))[None, None, :, :],
                         (X, Y, Z, num_feats))
    return np.concatenate([px, py, pz], axis=-1)


@functools.lru_cache(maxsize=16)
def _position_table(shape: Tuple[int, int, int], C: int,
                    device: str) -> torch.Tensor:
    """[1, X*Y*Z, C] fp32 on `device`: the sine encoding of C // 3
    features an axis, zero-padded to C channels, made once per (shape, C,
    device): at 100x100x8 the numpy table takes tens of ms of host time."""
    pe = sine_positional_encoding_3d(shape, C // 3)
    pe = np.pad(pe, ((0, 0),) * 3 + ((0, C - pe.shape[-1]),))
    return torch.from_numpy(pe.reshape(1, -1, C)).to(device)


class _MHA(nn.Module):
    """Multi-head attention with torch-style key masking: a blocked
    (True) logit becomes -1e9; the softmax in fp32."""

    def __init__(self, embed_dims: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dims, self.num_heads, self.dtype = (embed_dims,
                                                       num_heads, dtype)
        for name in ("q", "k", "v", "proj"):
            self.add_module(name, Linear(embed_dims, embed_dims))

    def forward(self, q, k, v, attn_mask=None):
        """q [B, Q, C]; k, v [B, S, C]; attn_mask [B, Q, S] bool (True =
        blocked). Returns [B, Q, C]."""
        C, H = self.embed_dims, self.num_heads
        hd = C // H
        qh = flax_apply(self.q, q, self.dtype)
        kh = flax_apply(self.k, k, self.dtype)
        vh = flax_apply(self.v, v, self.dtype)

        def split(x):
            return x.reshape(x.shape[0], -1, H, hd).transpose(1, 2)

        logits = torch.einsum("bhqd,bhsd->bhqs",
                              split(qh) * weak(hd ** -0.5, qh.dtype),
                              split(kh))
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask[:, None],
                                        weak(-1e9, logits.dtype))
        attn = softmax(logits.float(), -1)
        out = torch.einsum("bhqs,bhsd->bhqd", attn.to(vh.dtype), split(vh))
        out = out.transpose(1, 2).reshape(q.shape[0], -1, C)
        return flax_apply(self.proj, out, self.dtype)


class _FFN(nn.Module):
    def __init__(self, embed_dims: int, feedforward_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Linear(embed_dims, feedforward_channels)
        self.fc2 = Linear(feedforward_channels, embed_dims)

    def forward(self, x):
        y = torch.relu(flax_apply(self.fc1, x, self.dtype))
        return x + flax_apply(self.fc2, y, self.dtype)


def _maxpool_to(mask_pred: torch.Tensor, target) -> torch.Tensor:
    """[B, Q, X, Y, Z] -> [B, Q, x, y, z] max-pool by integer ratios."""
    B, Q, X, Y, Z = mask_pred.shape
    rx, ry, rz = X // target[0], Y // target[1], Z // target[2]
    m = mask_pred.reshape(B, Q, target[0], rx, target[1], ry, target[2], rz)
    return m.amax(dim=(3, 5, 7))


class Mask2FormerOccHead(nn.Module):
    """Query-based occupancy head over a voxel feature pyramid, as JAX's
    `Mask2FormerOccHead` (flax scopes as the attributes' names): the
    finest level gives the mask features, the next num_feat_levels levels
    (coarsest first) the decoder's memories, decoder layer i reading level
    i % num_feat_levels; a query whose mask blocks every key is unblocked;
    flax's LayerNorm (eps 1e-6)."""

    def __init__(self, feat_channels: int = 128, num_classes: int = 17,
                 num_queries: int = 100, num_heads: int = 8,
                 num_decoder_layers: int = 9, num_feat_levels: int = 3,
                 feedforward_channels: int = 1024,
                 in_channels: Optional[Sequence[int]] = None,
                 dtype: Optional[torch.dtype] = None):
        """in_channels: the memories' channels (coarsest first) where they
        differ from feat_channels (JAX's `input_proj{i}` Dense, created on
        first use in flax); None: all feat_channels."""
        super().__init__()
        C, L = feat_channels, num_feat_levels
        self.feat_channels, self.num_classes = C, num_classes
        self.num_queries, self.num_decoder_layers = (num_queries,
                                                     num_decoder_layers)
        self.num_feat_levels, self.dtype = L, dtype
        # flax's normal(1.0) init
        self.level_embed = nn.Parameter(torch.randn(L, C))
        self.query_feat = nn.Parameter(torch.randn(num_queries, C))
        self.query_embed = nn.Parameter(torch.randn(num_queries, C))
        for i, ci in enumerate(in_channels or (C,) * L):
            if ci != C:
                self.add_module(f"input_proj{i}", Linear(ci, C))
        self.post_norm = LayerNorm(C, eps=LN_EPS)
        self.cls_embed = Linear(C, num_classes + 1)
        for i in range(3):
            self.add_module(f"mask_embed{i}", Linear(C, C))
        for i in range(num_decoder_layers):
            self.add_module(f"layer{i}_cross", _MHA(C, num_heads, dtype))
            self.add_module(f"layer{i}_self", _MHA(C, num_heads, dtype))
            self.add_module(f"layer{i}_ffn",
                            _FFN(C, feedforward_channels, dtype))
            for k in range(3):
                self.add_module(f"layer{i}_norm{k}",
                                LayerNorm(C, eps=LN_EPS))

    def forward(self, voxel_feats: Sequence[torch.Tensor]):
        """voxel_feats: finest-first list of [B, C_l, X, Y, Z].

        Returns {"cls_preds": [B, Q, num_classes + 1] a stage,
        "mask_preds": [B, Q, X0, Y0, Z0] a stage (num_decoder_layers + 1
        stages), "occ": [B, X0, Y0, Z0, num_classes] the last stage's
        composed probabilities}."""
        C, L = self.feat_channels, self.num_feat_levels
        mask_features = voxel_feats[0]
        memories = list(voxel_feats[1:L + 1][::-1])
        assert len(memories) == L, \
            "need num_feat_levels+1 pyramid levels (finest + memories)"
        B = mask_features.shape[0]
        dev = mask_features.device
        inputs, poses, sizes = [], [], []
        for i, mem in enumerate(memories):
            Xi, Yi, Zi = mem.shape[2:]
            mem = mem.flatten(2).transpose(1, 2)          # [B, XYZ, C_l]
            if hasattr(self, f"input_proj{i}"):
                mem = flax_apply(getattr(self, f"input_proj{i}"), mem,
                            self.dtype)
            inputs.append(mem + self.level_embed[i].to(mem.dtype))
            poses.append(_position_table((Xi, Yi, Zi), C, str(dev)).to(
                mem.dtype))
            sizes.append((Xi, Yi, Zi))

        def forward_head(qf, target_size):
            d = flax_apply(self.post_norm, qf, self.dtype)
            cls_pred = flax_apply(self.cls_embed, d, self.dtype)
            me = d
            for i in range(3):
                me = flax_apply(getattr(self, f"mask_embed{i}"), me,
                                self.dtype)
                if i < 2:
                    me = torch.relu(me)
            mask_pred = torch.einsum("bqc,bcxyz->bqxyz", me,
                                     mask_features.to(me.dtype))
            with torch.no_grad():
                pooled = _maxpool_to(mask_pred.float(), target_size)
                attn = (torch.sigmoid(pooled) < 0.5).reshape(
                    B, self.num_queries, -1)          # True = blocked
                # un-block fully blocked queries (reference :704-705)
                attn = attn & ~attn.all(-1, keepdim=True)
            return cls_pred, mask_pred, attn

        q = self.query_feat[None].expand(B, -1, -1).to(mask_features.dtype)
        qe = self.query_embed[None].expand(B, -1, -1).to(mask_features.dtype)
        cls_pred, mask_pred, attn_mask = forward_head(q, sizes[0])
        cls_preds, mask_preds = [cls_pred], [mask_pred]
        for i in range(self.num_decoder_layers):
            lvl = i % L
            y = getattr(self, f"layer{i}_cross")(
                q + qe, inputs[lvl] + poses[lvl], inputs[lvl], attn_mask)
            q = flax_apply(getattr(self, f"layer{i}_norm0"), q + y,
                           self.dtype)
            y = getattr(self, f"layer{i}_self")(q + qe, q + qe, q)
            q = flax_apply(getattr(self, f"layer{i}_norm1"), q + y,
                           self.dtype)
            q = flax_apply(getattr(self, f"layer{i}_norm2"),
                           getattr(self, f"layer{i}_ffn")(q), self.dtype)
            cls_pred, mask_pred, attn_mask = forward_head(
                q, sizes[(i + 1) % L])
            cls_preds.append(cls_pred)
            mask_preds.append(mask_pred)
        return {"cls_preds": cls_preds, "mask_preds": mask_preds,
                "occ": format_results(cls_preds[-1], mask_preds[-1])}


def format_results(cls_pred: torch.Tensor,
                   mask_pred: torch.Tensor) -> torch.Tensor:
    """softmax(cls)[..., :-1] x sigmoid(mask) -> [B, X, Y, Z, num_classes]
    (fp32)."""
    cls_prob = cls_pred.float().softmax(-1)[..., :-1]
    mask_prob = torch.sigmoid(mask_pred.float())
    return torch.einsum("bqc,bqxyz->bxyzc", cls_prob, mask_prob)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    return np.asarray(a)


def format_panoptic_results(cls_pred, mask_pred, thing_indices):
    """Panoptic composition on the host (numpy, JAX's): each voxel takes
    its argmax query's class; a stuff class gives label * 1000, a thing
    voxel label * 1000 + an instance id a query. Returns (semantic, panoptic)
    int64 [B, X, Y, Z]."""
    cls_np = _host(cls_pred).astype(np.float32)
    mask_np = _host(mask_pred).astype(np.float32)
    sem_out, pan_out = [], []
    for b in range(cls_np.shape[0]):
        probs = np.exp(cls_np[b] - cls_np[b].max(-1, keepdims=True))
        probs = (probs / probs.sum(-1, keepdims=True))[..., :-1]
        labels = probs.argmax(-1)                      # [Q]
        vox_q = mask_np[b].argmax(0)                   # [X, Y, Z]
        sem = labels[vox_q]
        pan = np.zeros_like(sem, np.int64)
        instance_id = 1
        for label_id in np.unique(sem):
            label_mask = sem == label_id
            if int(label_id) not in thing_indices:
                pan[label_mask] = int(label_id) * 1000
                continue
            for q in np.unique(vox_q[label_mask]):
                pan[vox_q == q] = int(label_id) * 1000 + instance_id
                instance_id += 1
        sem_out.append(sem.astype(np.int64))
        pan_out.append(pan)
    return np.stack(sem_out), np.stack(pan_out)


def forward_lidarseg(cls_pred, mask_pred, points, *, pc_range,
                     padding_mode="border", point_labels=None,
                     num_classes=17):
    """Per-point class probabilities by trilinear sampling of the composed
    volume (align_corners=True): points a list of [N_i, >= 3] tensors,
    xyz in metres. The volume [X, Y, Z, C] is read as grid_sample's
    [D, H, W, C], so each point's grid is its (z, y, x) (the reference's
    [..., [2, 1, 0]] swap). Returns the softmax [sum N_i, num_classes] or,
    with point_labels (a list of [N_i] ints), {"point_mean_iou": float}
    over classes 1.. (a host copy of the predictions)."""
    vol = format_results(cls_pred, mask_pred)        # [B, X, Y, Z, C]
    dev = vol.device
    lo = device_constant(np.asarray(pc_range[:3], np.float32), dev)
    span = device_constant(np.asarray(pc_range[3:], np.float32), dev) - lo
    logits = []
    for b, pts in enumerate(points):
        p = (pts[:, :3].float() - lo) / span * 2 - 1
        logits.append(grid_sample_3d(vol[b:b + 1], p.flip(-1)[None],
                                     align_corners=True,
                                     padding_mode=padding_mode)[0])
    point_logits = torch.cat(logits, 0)              # [N, C]
    if point_labels is not None:
        pred = _host(point_logits[:, 1:].argmax(-1)) + 1
        gt = np.concatenate([_host(lab) for lab in point_labels]).astype(
            np.int64)
        k = (gt >= 0) & (gt < num_classes)
        hist = np.bincount(num_classes * gt[k] + pred[k],
                           minlength=num_classes ** 2
                           ).reshape(num_classes, num_classes)[1:, 1:]
        denom = hist.sum(1) + hist.sum(0) - np.diag(hist)
        iu = np.where(denom > 0, np.diag(hist) / np.maximum(denom, 1),
                      np.nan)
        return {"point_mean_iou": float(np.nanmean(iu))}
    return point_logits.softmax(-1)


def mask2former_occ_loss_all_layers(cls_preds, mask_preds, gt_occ, *,
                                    num_classes, ignore_index=255,
                                    bg_weight=0.1):
    """Deep supervision over every decoder stage: the last stage's terms
    keep their names, earlier ones are ``d{i}.``-prefixed, and
    ``loss_total`` sums them all."""
    out = {}
    total = 0.0
    n_stage = len(cls_preds)
    for i in range(n_stage):
        li = mask2former_occ_loss(cls_preds[i], mask_preds[i], gt_occ,
                                  num_classes=num_classes,
                                  ignore_index=ignore_index,
                                  bg_weight=bg_weight)
        prefix = "" if i == n_stage - 1 else f"d{i}."
        for k, v in li.items():
            out[prefix + k] = v
            total = total + v
    out["loss_total"] = total
    return out


def _dice(p, g, eps=1e-3):
    num = 2.0 * (p * g).sum(-1)
    den = p.sum(-1) + g.sum(-1)
    return 1.0 - (num + eps) / (den + eps)


def _match(cls_b, mask_b, gt_b, valid, labels, num_classes):
    """JAX's matching cost on the host (numpy, its dtypes) and scipy's
    Hungarian assignment -> (query indices, label indices, gt masks
    [G, XYZ] fp32)."""
    from scipy.optimize import linear_sum_assignment
    Q = cls_b.shape[0]
    G = len(labels)
    gt_masks = np.stack([(gt_b == c) & valid for c in labels])
    p = 1.0 / (1.0 + np.exp(-mask_b.reshape(Q, -1)))
    g = gt_masks.reshape(G, -1).astype(np.float32)
    cls_prob = np.exp(cls_b - cls_b.max(-1, keepdims=True))
    cls_prob = cls_prob / cls_prob.sum(-1, keepdims=True)
    cost_cls = -cls_prob[:, labels]                       # [Q, G]
    inter = p @ g.T
    cost_dice = 1.0 - (2 * inter + 1e-3) / (
        p.sum(-1)[:, None] + g.sum(-1)[None] + 1e-3)
    logit = mask_b.reshape(Q, -1)
    bce_pos = np.logaddexp(0, -logit) @ g.T
    bce_neg = np.logaddexp(0, logit) @ (
        valid.reshape(-1)[None].astype(np.float32) - g).T
    cost_mask = (bce_pos + bce_neg) / max(valid.sum(), 1)
    cost = cost_cls * 1.0 + cost_mask * 1.0 + cost_dice * 1.0
    qi, gi = linear_sum_assignment(cost)
    return qi, gi, g


def mask2former_occ_loss(cls_pred, mask_pred, gt_occ, *, num_classes,
                         ignore_index=255, bg_weight=0.1):
    """One stage's loss, as JAX's: queries matched to the ground truth's
    classes by the Hungarian assignment on the host, then cross-entropy
    (the background class weighted bg_weight), sigmoid BCE and dice of the
    matched masks over the valid voxels, in fp32 on cls_pred's device
    (differentiable in cls_pred and mask_pred).

    cls_pred [B, Q, num_classes + 1] logits; mask_pred [B, Q, X, Y, Z]
    logits; gt_occ [B, X, Y, Z] int labels (ignore_index ignored).
    Returns {"loss_cls", "loss_mask", "loss_dice"} scalar tensors."""
    B, Q = cls_pred.shape[:2]
    dev = cls_pred.device
    cls_np, mask_np, gt_np = _host(cls_pred), _host(mask_pred), _host(gt_occ)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    total_cls, total_mask, total_dice, n_match = zero, zero, zero, 0
    w = np.ones((num_classes + 1,), np.float32)
    w[num_classes] = bg_weight
    for b in range(B):
        valid = gt_np[b] != ignore_index
        labels = np.unique(gt_np[b][valid])
        tgt_cls = np.full((Q,), num_classes, np.int64)  # background
        if len(labels):
            qi, gi, g = _match(cls_np[b], mask_np[b], gt_np[b], valid,
                               labels, num_classes)
            tgt_cls[qi] = labels[gi]
            mp = mask_pred[b][torch.from_numpy(qi).to(dev)].reshape(
                len(qi), -1).float()
            gm = torch.from_numpy(g[gi]).to(dev)
            vm = torch.from_numpy(valid.reshape(-1).astype(np.float32)).to(
                dev)
            total_dice = total_dice + _dice(torch.sigmoid(mp) * vm, gm).sum()
            bce = mp.clamp(min=0) - mp * gm + torch.log1p(
                torch.exp(-mp.abs()))
            total_mask = total_mask + (bce * vm).sum() / vm.sum().clamp(
                min=1.0)
            n_match += len(qi)
        logp = torch.log_softmax(cls_pred[b].float(), -1)
        tgt = torch.from_numpy(tgt_cls).to(dev)
        wt = torch.from_numpy(w[tgt_cls]).to(dev)
        total_cls = total_cls - (logp[torch.arange(Q, device=dev), tgt]
                                 * wt).sum() / wt.sum()
    return {"loss_cls": total_cls / B, "loss_mask": total_mask / B,
            "loss_dice": total_dice / max(n_match, 1)}
