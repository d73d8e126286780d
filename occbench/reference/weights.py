"""The benchmark's seeded weights, drawn on the device in two large calls.

The distribution is the port's `init_weights` (copied, not imported):
conv and linear weights N(0, 1/fan_in) with fan_in the size of one output
slice (a transposed conv's first axis instead), biases N(0, 0.01), norm
scales U[0.5, 1.5) and biases N(0, 0.1). BatchNorm running statistics
are the identity (mean 0, variance 1), not init_weights' N(0, 0.3) and
U[0.2, 1.7): statistics unrelated to the activations let them grow through
the image branch until bf16 flips its depth bins (PERF.md). The entries
are taken in name order, each from its slice of one normal and one
uniform draw of a torch.Generator seeded with the run's seed. The port and
the reference draw the same state from the same seed wherever their names
and shapes agree: `names_digest` pins that they do.

`empty_shift` adds one number to the state, for a model with a cascade:
delta / C on each of the C input rows of the coarse head's empty-class
output (reference/occupancy.py works delta out from the traffic).
"""
from __future__ import annotations

import functools
import hashlib
import math
from typing import Dict, List, Tuple

import torch

NORMS = ("BatchNorm", "BatchNorm1d", "BatchNorm2d", "BatchNorm3d",
         "GroupNorm", "LayerNorm")
TRANSPOSED = ("ConvTranspose2d", "ConvTranspose3d")
# the coarse head's last conv (bias-free) and the empty class's row of it
EMPTY_ROW = ("pts_bbox_head.occ_pred_conv.3.weight", 0)


def entries(model: torch.nn.Module) -> List[Tuple[str, torch.Tensor, str]]:
    """(name, tensor, kind) of every parameter and BatchNorm running
    statistic, in name order; kind says how it is drawn."""
    out = []
    for mname, m in model.named_modules():
        cls = type(m).__name__
        own = list(m.named_parameters(recurse=False))
        if cls in NORMS:
            own += [(n, b) for n, b in m.named_buffers(recurse=False)
                    if n in ("running_mean", "running_var")]
        for n, t in own:
            full = f"{mname}.{n}" if mname else n
            if cls in NORMS:
                kind = {"weight": "norm_scale", "bias": "norm_bias",
                        "running_mean": "run_mean",
                        "running_var": "run_var"}[n]
            elif n == "bias":
                kind = "bias"
            elif cls in TRANSPOSED:
                kind = "weight_t"
            else:
                kind = "weight"
            out.append((full, t, kind))
    return sorted(out, key=lambda e: e[0])


def names_digest(model: torch.nn.Module) -> str:
    """A digest of the names, shapes and kinds `draw` fills."""
    h = hashlib.sha256()
    for name, t, kind in entries(model):
        h.update(f"{name}:{tuple(t.shape)}:{kind};".encode())
    return h.hexdigest()[:16]


@torch.no_grad()
def draw(model: torch.nn.Module, seed: int,
         empty_shift: float = 0.0) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on the model's device} of the seed's weights,
    the empty class's row shifted by `empty_shift` (see above)."""
    ents = entries(model)
    device = ents[0][1].device
    total = sum(t.numel() for _, t, _ in ents)
    g = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=g, device=device)
    u = torch.rand(total, generator=g, device=device)
    out, off = {}, 0
    for name, t, kind in ents:
        n = t.numel()
        zs, us = z[off:off + n].view(t.shape), u[off:off + n].view(t.shape)
        off += n
        if kind == "norm_scale":
            v = us + 0.5
        elif kind == "norm_bias":
            v = zs * 0.1
        elif kind == "run_mean":
            v = torch.zeros_like(zs)
        elif kind == "run_var":
            v = torch.ones_like(us)
        elif kind == "bias":
            v = zs * 0.01
        elif kind == "weight_t":
            v = zs / math.sqrt(t.shape[0])
        else:
            v = zs / math.sqrt(t[0].numel())
        out[name] = v.float()
    if empty_shift:
        name, row = EMPTY_ROW
        w = out[name]
        w[row] += empty_shift / w[row].numel()
    return out


@torch.no_grad()
def load(model: torch.nn.Module, seed: int,
         empty_shift: float = 0.0) -> torch.nn.Module:
    """Fill `model`'s parameters and running statistics with the seed's
    weights."""
    state = draw(model, seed, empty_shift)
    for name, t, _ in entries(model):
        t.copy_(state[name])
    return model


def loader(empty_shift: float = 0.0):
    """The init function (model, seed) the port's build_model takes."""
    return functools.partial(load, empty_shift=empty_shift)
