"""Host constants (index tables, fixed 0/1 weights) on a device.

A copy from pageable host memory synchronizes the stream, so a constant
that a forward needs on every call is copied to each device once.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def device_constant(a: np.ndarray, device) -> torch.Tensor:
    """`a` as a tensor on `device`, copied once per (contents, device)."""
    a = np.ascontiguousarray(a)
    return _copy(a.tobytes(), a.dtype.str, a.shape, str(device))


@functools.lru_cache(maxsize=64)
def _copy(raw: bytes, dtype: str, shape, device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(raw, dtype).reshape(shape)
                            .copy()).to(device)
