"""Convolutions and matmuls in the input's dtype, summed in fp32.

`conv(fn, x, weight, bias, *args)` runs `fn` (F.conv2d, F.conv3d,
F.conv_transpose2d, F.conv_transpose3d, F.linear) with the weight and bias
cast to x's dtype: JAX's conv on bf16 operands with `preferred_element_type=fp32` and one
rounding. On the card cuDNN and cuBLAS compute bf16 that way. A bf16 call
takes the same products and sums through an fp32 call on the bf16 values,
rounded once, where the library's bf16 route fails us: on the CPU always
(torch's CPU bf16 conv3d returns NaN or wrong values at some of the model's
shapes, a stride-2 conv to a size-1 z axis), and on the card where the
caller asks for it (`via_fp32`; see `nn/layers.py:Conv2d`). The fp32 call
is that arithmetic exactly: a product of two bf16 values is exact in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch


def conv(fn, x: torch.Tensor, weight: torch.Tensor,
         bias: Optional[torch.Tensor] = None, *args,
         via_fp32: bool = False) -> torch.Tensor:
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if x.dtype == torch.float32 or (x.device.type != "cpu" and not via_fp32):
        return fn(x, w, b, *args)
    return fn(x.float(), w.float(), None if b is None else b.float(),
              *args).to(x.dtype)
