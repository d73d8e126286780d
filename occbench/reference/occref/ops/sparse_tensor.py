"""The sparse voxel tensor the HD encoder takes, and a strided conv's
output grid.

Counterpart of the part of coocc_tpu/ops/sparse_conv.py that the packed
HD encoder reads (its gather-GEMM engine serves encoders that are not in
the copy).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple


class SparseTensor(NamedTuple):
    """A fixed-capacity sparse voxel tensor: ids [B, A] sorted linear
    voxel ids (num_cells in the padding), features [B, A, C], mask [B, A]
    bool."""
    ids: object
    features: object
    mask: object


def _as3(v) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(int(x) for x in v)


def conv_output_shape(grid_size, kernel, stride,
                      padding) -> Tuple[int, int, int]:
    """The output grid of a conv with these kernel, stride and padding."""
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    return tuple((int(g) + 2 * p[i] - k[i]) // s[i] + 1
                 for i, g in enumerate(grid_size))
