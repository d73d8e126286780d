"""Entry points: the flagship eval forward and train steps with seeded
random weights.

The twin of `__graft_entry__.entry()`: `entry()` builds CoOccRay for
coocc_multi_r50_256x704 (fp32, B=1, as the JAX entry is) with random
weights drawn from a seeded `torch.Generator` and a synthetic batch, and
returns `(fn, args)` with `fn(*args)` the eval forward. `served_model`
builds the model the CLI serves, in the config's `compute_dtype`.
`train_steps` trains it on synthetic batches in the config's
`compute_dtype`, as `tools/train.py --synthetic` does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .config import get_config
from .config.base import CoOccConfig
from .data.synthetic import synthetic_batch
from .models.coocc_ray import CoOccRay
from .nn.layers import BatchNorm
from .parallel.train_step import train_step
from .train.state import make_optimizer

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


def build_model(cfg: CoOccConfig, device="cuda", seed: int = 0,
                dtype: Optional[torch.dtype] = None) -> CoOccRay:
    """CoOccRay(cfg, dtype) with the seeded random weights, in eval mode, on
    `device`; the weights are drawn in fp32 and stay fp32."""
    device = resolve_device(device)
    return init_weights(CoOccRay(cfg, dtype), seed).eval().to(device)


def compute_dtype(cfg: CoOccConfig) -> Optional[torch.dtype]:
    """The config's compute dtype as the JAX CLIs map it
    (tools/test.py:76-78, tools/train.py:116-118)."""
    return {"bfloat16": torch.bfloat16, "float32": None}[cfg.compute_dtype]


def served_model(cfg: CoOccConfig, device="cuda") -> CoOccRay:
    """The model `python -m coocc_tpu_torch` answers with: weights of seed
    0, in the config's compute dtype."""
    return build_model(cfg, device, seed=0, dtype=compute_dtype(cfg))


class Trainer:
    """A model in training (seeded weights, the config's compute dtype),
    its optimizer (train/state.py) and the generator its dropout and
    cascade priorities draw from. `step(batch)` is one train step."""

    def __init__(self, cfg: CoOccConfig, device="cuda", seed: int = 0):
        device = resolve_device(device)
        self.model = build_model(cfg, device, seed,
                                 compute_dtype(cfg)).train()
        self.optimizer = make_optimizer(self.model, cfg.optim)
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def step(self, batch):
        return train_step(self.model, self.optimizer, batch, self.generator)


def train_steps(cfg: CoOccConfig, steps: int, device="cuda", seed: int = 0):
    """`steps` train steps of a new Trainer(cfg, device, seed) on the
    synthetic batches of seeds 0..steps-1 (B=1). -> (trainer, [each step's
    metrics])."""
    trainer = Trainer(cfg, device, seed)
    device = next(trainer.model.parameters()).device
    metrics = [trainer.step(synthetic_batch(cfg, batch_size=1, seed=i)
                            .to(device)) for i in range(steps)]
    return trainer, metrics


def entry(device="cuda"):
    """-> (fn, args): fn(*args) is the flagship eval forward on the
    synthetic batch of seed 0, with random weights of seed 0."""
    cfg = get_config(FLAGSHIP)
    model = build_model(cfg, device, seed=0)
    return model, (synthetic_batch(cfg, batch_size=1, seed=0).to(device),)
