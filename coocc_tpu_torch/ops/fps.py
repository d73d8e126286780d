"""Furthest-point sampling, ball query and gather of points.

Counterpart of coocc_tpu/ops/fps.py (the reference's CUDA point ops of
mmdet3d's furthest_point_sample, ball_query and gather_points, which the
reference's FPS-cluster fuser used). No model of either package calls
them: the fuser computes the exact window KNN (ops/window_knn.py). Static
shapes and masks, as JAX's.
"""
from __future__ import annotations

import torch


def furthest_point_sample(points: torch.Tensor, mask: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """points [P, 3], mask [P] bool (padding is never picked) -> [S] int64
    indices: the first valid point, then each time the valid point
    furthest from those picked (squared distances in fp32; the first of
    equal ones); with no valid point, index 0 repeated."""
    P = points.shape[0]
    idx = torch.empty(num_samples, dtype=torch.int64, device=points.device)
    min_d2 = torch.full((P,), 1e10, dtype=torch.float32,
                        device=points.device)
    last = torch.argmax(mask.to(torch.int32))
    for s in range(num_samples):
        idx[s] = last
        diff = points - points[last]
        min_d2 = torch.minimum(min_d2, (diff * diff).sum(-1))
        last = torch.argmax(torch.where(mask, min_d2, -1.0))
    return idx


def ball_query(centers: torch.Tensor, points: torch.Tensor,
               mask: torch.Tensor, radius: float,
               num_samples: int) -> torch.Tensor:
    """centers [Q, 3], points [P, 3], mask [P] bool -> [Q, S] int64: the
    first `num_samples` valid points (in point order) strictly within
    `radius` of each center; the slots past those found repeat the first
    found, and a center with none gets 0 (the CUDA kernel's fill rule)."""
    d2 = ((centers[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    inside = (d2 < radius * radius) & mask[None, :]
    P = points.shape[0]
    order = torch.where(inside, torch.arange(P, device=points.device), P)
    k = min(num_samples, P)
    hits = torch.sort(order, dim=1).values[:, :k]
    if k < num_samples:
        hits = torch.cat([hits, hits.new_full((hits.shape[0],
                                               num_samples - k), P)], 1)
    valid = hits < P
    first = torch.where(valid[:, 0], hits[:, 0], 0)
    return torch.where(valid, hits, first[:, None])


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[P, C] features at int indices [...] -> [..., C]."""
    return points[idx]
