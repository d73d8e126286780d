"""FLoSP: features-line-of-sight projection.

Counterpart of coocc_tpu/nn/flosp.py (reference coocc/image2bev/
flosp.py:5-41, MonoScene-style): every voxel takes the 2D feature at its
projected pixel, voxels outside the field of view zeros. One gather at a
clamped index, as JAX's `take` (the reference concatenates a zero column
instead); in training its gradient goes through `ops/gather.py:
gather_rows`. No CoOccRay route reaches it, in JAX or here.
"""
from __future__ import annotations

import torch

from ..ops.gather import gather_rows


def flosp(x2d: torch.Tensor, projected_pix: torch.Tensor,
          fov_mask: torch.Tensor, scene_size) -> torch.Tensor:
    """x2d [C, H, W], projected_pix [V, 2] integer (pix_x, pix_y) per voxel
    of the row-major raster of scene_size (X, Y, Z), V = X*Y*Z, fov_mask
    [V] bool -> [C, X, Y, Z]: the features at the voxels' pixels, zeros
    where fov_mask is False or the pixel is off the image."""
    C, H, W = x2d.shape
    px, py = projected_pix[:, 0].long(), projected_pix[:, 1].long()
    inb = fov_mask & (px >= 0) & (px < W) & (py >= 0) & (py < H)
    lin = (py * W + px).clamp(0, H * W - 1)
    feat = gather_rows(x2d.reshape(C, H * W).T, lin) * inb[:, None]
    return feat.T.reshape(C, *scene_size)
