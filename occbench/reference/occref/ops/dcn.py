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

from .gather import gather_rows


def _bilinear_taps(x, py, px):
    """x [B, C, H, W]; py/px [B, T, P] pixel positions -> [B, C, T, P].
    Each corner's pixels are gathered as rows of the [B*H*W, C] table
    (ops/gather.py:gather_rows), so their gradient sums each pixel's
    cotangents in a fixed order: torch.gather's own backward (a
    scatter-add) sums with atomics on the card, and a train step did not
    repeat."""
    B, C, H, W = x.shape
    table = x.reshape(B, C, H * W).transpose(1, 2).reshape(B * H * W, C)
    base = (torch.arange(B, device=x.device) * (H * W))[:, None, None]
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
            v = gather_rows(table, base + idx).permute(0, 1, 3, 2)
            # the JAX order of the products: each rounds in x's dtype
            v = v * inb[:, :, None, :].to(x.dtype)
            out = out + v * w_y[:, :, None, :] * w_x[:, :, None, :]
    return out.permute(0, 2, 1, 3)  # [B, C, T, P]


def deform_conv2d(x, offset, weight, *, padding=1, stride=1, groups=1,
                  bias=None):
    """DCNv1 forward with one offset group. Returns [B, Cout, Ho, Wo] in
    x's dtype.

    Numerics of the JAX version in any dtype: the sample positions are
    x's dtype (base + offset, one rounding), the bilinear taps are formed
    in it, and the contraction with the weight (fp32, uncast) runs in fp32
    and rounds once to x's dtype."""
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
    w = weight.reshape(groups, Cout // groups, cin_g, K * K).float()
    out = torch.einsum("bgctp,gdct->bgdp", cols.float(), w).reshape(
        B, Cout, Ho, Wo).to(x.dtype)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out
