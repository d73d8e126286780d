"""The dense layers' FLOP of one forward, counted at their shapes.

Forward hooks on every convolution and linear module of a model (the
reference's, whose layers have the port's names and shapes) read the
shapes each call sees: a convolution costs 2 * (output elements) *
(input channels per group) * (kernel taps), a transposed one 2 * (input
elements) * (output channels per group) * taps, a linear layer 2 *
(output elements) * (input features). Modules under the prefixes in
`skip` (the sparse encoder, whose work sparse.py counts by its rulebook)
are left out, and so are the matrix products the model writes as
functions rather than modules: the count is a floor of the work.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch.nn as nn

CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
TCONVS = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)


class DenseFlops:
    """Counts while installed: `with DenseFlops(model, skip) as c:` then
    `c.flop`."""

    def __init__(self, model: nn.Module, skip: Iterable[str] = ()):
        self.model, self.skip = model, tuple(skip)
        self.flop, self.handles = 0, []

    def _hook(self, m, args, out):
        x = args[0]
        if isinstance(m, TCONVS):
            taps = math.prod(m.kernel_size)
            self.flop += 2 * x.numel() * (m.out_channels // m.groups) * taps
        elif isinstance(m, CONVS):
            taps = math.prod(m.kernel_size)
            self.flop += 2 * out.numel() * (m.in_channels // m.groups) * taps
        else:
            self.flop += 2 * out.numel() * m.in_features

    def __enter__(self):
        for name, m in self.model.named_modules():
            if any(name == s or name.startswith(s + ".") for s in self.skip):
                continue
            if isinstance(m, CONVS + TCONVS + (nn.Linear,)):
                self.handles.append(m.register_forward_hook(self._hook))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []
