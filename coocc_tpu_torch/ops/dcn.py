"""Deformable convolution v1 as a bilinear gather + grouped contraction.

Counterpart of coocc_tpu/ops/dcn.py `deform_conv2d`, the mmcv DCN that
DepthNet's depth branch uses (ViewTransformerLSSBEVDepth.py:524-532). For
each of the K*K taps, the input is sampled at p + tap + offset_tap(p) with
bilinear interpolation; a corner outside the image contributes zero (mmcv
semantics). The taps are then contracted with the grouped weight.

Layout is torch's (as torchvision.ops.deform_conv2d): x [B, Cin, H, W],
offset [B, 2*Gd*K*K, Ho, Wo] holding (dy, dx) per tap, row-major taps,
weight [Cout, Cin/groups, K, K].
"""
from __future__ import annotations

import torch


def _bilinear_taps(x, py, px):
    """x [B, C, H, W]; py/px [B, T, P] pixel positions -> [B, C, T, P]."""
    B, C, H, W = x.shape
    flat = x.reshape(B, 1, C, H * W)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = py - y0
    wx = px - x0
    y0 = y0.long()
    x0 = x0.long()
    out = 0
    for dy, w_y in ((0, 1 - wy), (1, wy)):
        for dx, w_x in ((0, 1 - wx), (1, wx)):
            yi, xi = y0 + dy, x0 + dx
            inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))  # [B, T, P]
            v = torch.gather(flat.expand(B, idx.shape[1], C, H * W), 3,
                             idx[:, :, None, :].expand(-1, -1, C, -1))
            out = out + v * (w_y * w_x * inb)[:, :, None, :]
    return out.permute(0, 2, 1, 3)  # [B, C, T, P]


def deform_conv2d(x, offset, weight, *, padding=1, stride=1, groups=1,
                  bias=None):
    """DCNv1 forward with one offset group. Returns [B, Cout, Ho, Wo]."""
    B, Cin, H, W = x.shape
    Cout, cin_g, K, _ = weight.shape
    Ho = (H + 2 * padding - K) // stride + 1
    Wo = (W + 2 * padding - K) // stride + 1
    off = offset.reshape(B, K * K, 2, Ho * Wo)
    base_y = (torch.arange(Ho, device=x.device) * stride - padding)
    base_x = (torch.arange(Wo, device=x.device) * stride - padding)
    tap = torch.arange(K * K, device=x.device)
    py = (base_y[None, :, None] + (tap // K)[:, None, None]).expand(
        K * K, Ho, Wo).to(x.dtype)
    px = (base_x[None, None, :] + (tap % K)[:, None, None]).expand(
        K * K, Ho, Wo).to(x.dtype)
    py = py.reshape(K * K, Ho * Wo)[None] + off[:, :, 0]
    px = px.reshape(K * K, Ho * Wo)[None] + off[:, :, 1]
    cols = _bilinear_taps(x, py, px)  # [B, Cin, K*K, Ho*Wo]
    cols = cols.reshape(B, groups, cin_g, K * K, Ho * Wo)
    w = weight.reshape(groups, Cout // groups, cin_g, K * K)
    out = torch.einsum("bgctp,gdct->bgdp", cols, w).reshape(B, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out
