"""Entry point: the flagship eval forward with seeded random weights.

The twin of `__graft_entry__.entry()`: `entry()` builds CoOccRay for
coocc_multi_r50_256x704 (fp32, B=1) with random weights drawn from a seeded
`torch.Generator` and a synthetic batch, and returns `(fn, args)` with
`fn(*args)` the eval forward.
"""
from __future__ import annotations

import math

import torch

from .config import get_config
from .config.base import CoOccConfig
from .data.synthetic import synthetic_batch
from .models.coocc_ray import CoOccRay
from .nn.layers import BatchNorm

FLAGSHIP = "coocc_multi_r50_256x704"


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device without a card raises (no
    silent CPU fallback)."""
    device = torch.device(device)
    if device.type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           "torch.cuda.is_available() is False")
    return device


@torch.no_grad()
def init_weights(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded random weights: conv/linear weights ~ N(0, 1/fan_in) (lecun
    normal), biases ~ N(0, 0.01); norm affines and BN statistics random
    around identity, so every norm, including the LiDAR stem GroupNorm whose
    bias is the whole level-0 signal, does real work."""
    g = torch.Generator().manual_seed(seed)

    def normal(shape, std, mean=0.0):
        return torch.randn(shape, generator=g) * std + mean

    for m in model.modules():
        if isinstance(m, (BatchNorm, torch.nn.GroupNorm)):
            C = m.weight.shape[0]
            m.weight.copy_(torch.rand(C, generator=g) + 0.5)
            m.bias.copy_(normal(C, 0.1))
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(normal(C, 0.3))
                m.running_var.copy_(torch.rand(C, generator=g) * 1.5 + 0.2)
            continue
        for name, p in m.named_parameters(recurse=False):
            if name == "bias":
                p.copy_(normal(p.shape, 0.01))
            elif isinstance(m, torch.nn.ConvTranspose2d):
                # [Cin, Cout, k, k] with stride k: each output sees Cin taps
                p.copy_(normal(p.shape, 1 / math.sqrt(p.shape[0])))
            else:
                # every other weight has its output axis first
                p.copy_(normal(p.shape, 1 / math.sqrt(p[0].numel())))
    return model


def build_model(cfg: CoOccConfig, device="cuda", seed: int = 0) -> CoOccRay:
    device = resolve_device(device)
    return init_weights(CoOccRay(cfg), seed).eval().to(device)


def entry(device="cuda"):
    """-> (fn, args): fn(*args) is the flagship eval forward on the
    synthetic batch of seed 0, with random weights of seed 0."""
    cfg = get_config(FLAGSHIP)
    model = build_model(cfg, device, seed=0)
    return model, (synthetic_batch(cfg, batch_size=1, seed=0).to(device),)
