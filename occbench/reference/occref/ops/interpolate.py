"""Separable linear resizes (torch's F.interpolate bilinear / trilinear
semantics), built op for op as the JAX package builds them.

Counterpart of coocc_tpu/ops/interpolate.py, for the port's call sites:
the FPN3D top-down upsample (nn/fpn3d.py), the occupancy head's level blend
(nn/occ_head.py), the renderer's x16 bilinear upsample (models/renderer.py)
and the eval's logit upsample to the ground-truth grid
(evaluation/ssc_metrics.py). The spatial axes are given explicitly, so a
channels-first [B, C, X, Y, Z] tensor and a channels-last one resize alike.

An integer ratio r <= 16 with align_corners=False is r fixed-weight blends
x + f * (x[i +- 1] - x) of edge-shifted copies, in x's dtype, interleaved
along the axis (`_upsample_int_axis`): slices, concatenations and
elementwise ops, whose gradients PyTorch sums in a fixed order. Any other
ratio gathers the two neighbours along the axis and lerps with fp32
weights, which promotes a bf16 x to fp32 as JAX's promotion does; its
gather is ops/gather.py:gather_rows, whose gradient sums each source row's
cotangents in a fixed order too. F.interpolate's backward sums with
atomics on the card (`upsample_trilinear3d_backward`), so two train steps
from one state differed; and its forward rounds a bf16 input once where
JAX's rounds each op.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from .gather import gather_rows

MAX_INT_RATIO = 16   # the largest integer ratio taken by shifted blends


def _axis_weights(in_size: int, out_size: int, align_corners: bool,
                  device=None):
    """Source indices (lo, hi) (int64) and the fp32 lerp weight of `hi`
    for one axis."""
    out = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        src = torch.zeros(1, dtype=torch.float32, device=device) \
            if out_size == 1 else out * (in_size - 1) / (out_size - 1)
    else:
        src = ((out + 0.5) * (in_size / out_size) - 0.5).clamp(min=0.0)
    lo = src.floor().long().clamp(0, in_size - 1)
    hi = (lo + 1).clamp(0, in_size - 1)
    return lo, hi, src - lo


def _shift_edge(x: torch.Tensor, axis: int, delta: int) -> torch.Tensor:
    """x[i + delta] along `axis` (delta = +-1), the edge replicated (slices
    and a concatenation, no gather)."""
    n = x.shape[axis]
    if delta > 0:
        return torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                         axis)
    return torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)


def _upsample_int_axis(x: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    """Upsample `axis` by the integer r (align_corners=False): output
    phase p of cell i is x[i] + f * (x[i -+ 1] - x[i]), f = |(p + 0.5) / r
    - 0.5|, each op rounded to x's dtype (one op where f is a power of two,
    `_exact`), the r phases interleaved. Without a gradient to take the
    same ops write into the output (_upsample_int_axis_into)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _upsample_int_axis_into(x, axis, r)
    diffs = {-1: _shift_edge(x, axis, -1) - x, 1: _shift_edge(x, axis, 1) - x}
    phases = []
    for p in range(r):
        f = (p + 0.5) / r - 0.5
        if f == 0:
            phases.append(x)
        elif _exact(abs(f)):
            phases.append(torch.add(x, diffs[-1 if f < 0 else 1],
                                    alpha=abs(f)))
        else:
            phases.append(x + torch.tensor(abs(f), dtype=x.dtype)
                          * diffs[-1 if f < 0 else 1])
    shape = list(x.shape)
    shape[axis] *= r
    return torch.stack(phases, axis + 1).reshape(shape)


def _exact(c: float) -> bool:
    """Whether c is a power of two: c * d is then exact in any float
    format (short of underflow), so x + c * d rounded once (torch.add with
    alpha) equals JAX's product and sum rounded each."""
    return math.frexp(c)[0] == 0.5


def _upsample_int_axis_into(x: torch.Tensor, axis: int,
                            r: int) -> torch.Tensor:
    """_upsample_int_axis' values with fewer passes over memory: the two
    neighbour differences x[i -+ 1] - x[i] (the edge's x[i] - x[i]) once
    each, and each phase's product and sum written into its strided slice
    of the output; no shifted copies and no stack. The same ops in the same
    order, so the same bits. The served forwards take it: with the composed
    form alone coocc_lidar's served busy rose 1.36% over F.interpolate's
    (an H100, tools/served_busy.py; PERF.md §6), past the 1% rule."""
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis:axis + 1] = [n, r]
    out = x.new_empty(shape)
    diffs = {}
    for sign in (-1, 1):
        d = torch.empty_like(x)
        inner, edge = (1, 0) if sign < 0 else (0, n - 1)
        torch.sub(x.narrow(axis, 1 - inner, n - 1), x.narrow(axis, inner,
                                                             n - 1),
                  out=d.narrow(axis, inner, n - 1))
        e = x.narrow(axis, edge, 1)
        torch.sub(e, e, out=d.narrow(axis, edge, 1))
        diffs[sign] = d
    for p in range(r):
        f = (p + 0.5) / r - 0.5
        dst = out.select(axis + 1, p)
        if f == 0:
            dst.copy_(x)
            continue
        d = diffs[-1 if f < 0 else 1]
        if _exact(abs(f)):
            torch.add(x, d, alpha=abs(f), out=dst)
            continue
        torch.mul(d, torch.tensor(abs(f), dtype=x.dtype), out=dst)
        torch.add(x, dst, out=dst)
    shape = list(x.shape)
    shape[axis] *= r
    return out.reshape(shape)


def _take_axis(x: torch.Tensor, idx: torch.Tensor, axis: int):
    """x's rows idx along `axis` (gather_rows on the axis moved first)."""
    moved = x.movedim(axis, 0)
    rows = gather_rows(moved.reshape(moved.shape[0], -1), idx)
    return rows.reshape((len(idx),) + moved.shape[1:]).movedim(0, axis)


def _resize_axis(x: torch.Tensor, axis: int, out_size: int,
                 align_corners: bool = False) -> torch.Tensor:
    """One axis of resize_linear."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    axis %= x.ndim
    if not align_corners and out_size % in_size == 0 \
            and out_size // in_size <= MAX_INT_RATIO:
        return _upsample_int_axis(x, axis, out_size // in_size)
    lo, hi, w = _axis_weights(in_size, out_size, align_corners, x.device)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = w.reshape(shape)
    return _take_axis(x, lo, axis) * (1 - w) + _take_axis(x, hi, axis) * w


def resize_linear(x: torch.Tensor, out_sizes: Sequence[int],
                  spatial_axes: Sequence[int],
                  align_corners: bool = False) -> torch.Tensor:
    """Separable linear resize of `spatial_axes` to `out_sizes` (torch's
    F.interpolate semantics), one axis at a time in the order given."""
    for ax, s in zip(spatial_axes, out_sizes):
        x = _resize_axis(x, ax, int(s), align_corners)
    return x


def resize_trilinear_zxy(x: torch.Tensor, out_size,
                         align_corners: bool = False) -> torch.Tensor:
    """[B, C, X, Y, Z] -> [B, C, *out_size] (F.interpolate's
    mode="trilinear" on the port's channels-first layout), the axes resized
    in the order Z, X, Y: JAX's semantic FPN and occupancy head run in its
    z-batch layout [B, Z, X, Y, C] and resize its axes (1, 2, 3)
    (coocc_tpu/nn/fpn3d.py:57-59, occ_head.py:229-231). The order decides
    where a bf16 x is promoted and how each op rounds."""
    X, Y, Z = out_size
    n = x.ndim
    return resize_linear(x, (Z, X, Y), (n - 1, n - 3, n - 2), align_corners)


def resize_trilinear_chlast(x: torch.Tensor, out_size,
                            align_corners: bool = False) -> torch.Tensor:
    """[..., X, Y, Z, C] -> [..., *out_size, C]."""
    n = x.ndim
    return resize_linear(x, out_size, (n - 4, n - 3, n - 2), align_corners)


def resize_bilinear_chlast(x: torch.Tensor, out_size,
                           align_corners: bool = False) -> torch.Tensor:
    """[..., H, W, C] -> [..., *out_size, C]."""
    n = x.ndim
    return resize_linear(x, out_size, (n - 3, n - 2), align_corners)
