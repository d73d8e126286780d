"""Entry points: the flagship eval forward and train steps with seeded
random weights.

The twin of `__graft_entry__.entry()`: `entry()` builds CoOccRay for
coocc_multi_r50_256x704 (fp32, B=1, as the JAX entry is) with random
weights drawn from a seeded `torch.Generator` and a synthetic batch, and
returns `(fn, args)` with `fn(*args)` the eval forward. `served_model`
builds the model the CLI serves, in the config's `compute_dtype`.
`train_steps` trains it on synthetic batches in the config's
`compute_dtype`; `data_parallel_train_steps` does so over several
processes, one a device (the twin of `__graft_entry__.dryrun_multichip`).
`init_flax` draws the weights the JAX package starts a run from (flax's
initializers), which the train and test CLIs use.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from .config import get_config
from .config.base import CoOccConfig
from .data.synthetic import synthetic_batch, tiny_config
from .models.coocc_ray import CoOccRay
from .nn.layers import BatchNorm
from .parallel.distributed import spawn_ranks
from .parallel.mesh import Mesh, make_mesh, shard_batch
from .parallel.train_step import rank_seed, train_step
from .train.state import make_optimizer

FLAGSHIP = "coocc_multi_r50_256x704"


def config_by_name(name: str) -> CoOccConfig:
    """A registered config, or 'tiny' (the tests' miniature), as the JAX
    package's tools/train.py and tools/test.py name them."""
    return tiny_config() if name == "tiny" else get_config(name)


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
            elif isinstance(m, (torch.nn.ConvTranspose2d,
                                torch.nn.ConvTranspose3d)):
                # [Cin, Cout, *k] with stride k: each output sees Cin taps
                p.copy_(normal(p.shape, 1 / math.sqrt(p.shape[0])))
            else:
                # every other weight has its output axis first
                p.copy_(normal(p.shape, 1 / math.sqrt(p[0].numel())))
    return model


# the std of a standard normal truncated to [-2, 2]: flax divides by it so
# that a truncated draw keeps the variance it asks for
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, g: torch.Generator) -> torch.Tensor:
    """A standard normal truncated to [-2, 2]: the draws outside redrawn
    until none is (the same distribution as torch's inverse-CDF
    trunc_normal_, at a third of its time on the CPU)."""
    x = torch.randn(shape, generator=g)
    flat = x.view(-1)
    idx = (flat.abs() > 2).nonzero().squeeze(1)
    while idx.numel():
        v = torch.randn(idx.numel(), generator=g)
        keep = v.abs() <= 2
        flat[idx[keep]] = v[keep]
        idx = idx[~keep]
    return x


@torch.no_grad()
def init_flax(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """The weights the JAX package's `jit_init` gives a CoOccRay (flax's
    initializers; coocc_tpu/utils/init_utils.py, as JAX's `train()` and
    `tools/test.py` without a checkpoint start), drawn from a seeded
    torch.Generator: every conv and dense kernel lecun_normal (a normal
    truncated at 2 sigma with variance 1 / fan_in), the spconv weights
    (SpConvWeight) a plain normal of variance 2 / fan_in (JAX's `_kaiming`)
    and the DCN weight a truncated one of variance 2 / fan_in (flax's
    `kaiming_normal`); biases 0, BatchNorm and GroupNorm scales 1 and
    biases 0, BatchNorm running means 0 and variances 1. fan_in is the
    kernel's size over one output channel in flax's layout: the input
    channels (per group) times the taps (for the HD encoder's 1x1x1
    conv_out the input channels, as JAX's `_kaiming`), for a
    ConvTranspose2d or ConvTranspose3d (flax's `transpose_kernel`) the
    output channels times the taps; each is the port's
    weight[0].numel()."""
    from .nn.depthnet import DCN
    from .nn.sparse_enc_dense import SpConvWeight
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (BatchNorm, torch.nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            continue
        for name, p in m.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
                continue
            std = math.sqrt((2.0 if isinstance(m, (DCN, SpConvWeight))
                             else 1.0) / p[0].numel())
            if isinstance(m, SpConvWeight):
                p.copy_(torch.randn(p.shape, generator=g) * std)
            else:
                p.copy_(_truncated_normal(p.shape, g) * (std / _TRUNC_STD))
    return model


def build_model(cfg: CoOccConfig, device="cuda", seed: int = 0,
                dtype: Optional[torch.dtype] = None,
                init=init_weights) -> CoOccRay:
    """CoOccRay(cfg, dtype) with the weights `init(model, seed)` draws
    (init_weights, or init_flax), in eval mode, on `device`; the weights
    are drawn in fp32 and stay fp32. For the card the model is built
    there: its modules' default initializers, which `init` overwrites
    (parameters and BatchNorm statistics alike), take seconds of host
    time for a full-width model on the CPU; the buffers made from numpy
    are the same. A part of a config the port does not run (a LiDAR impl,
    a backbone) raises NotImplementedError before the device is
    resolved."""
    on_card = torch.device(device).type == "cuda" and \
        torch.cuda.is_available()
    with torch.device(device) if on_card else contextlib.nullcontext():
        model = CoOccRay(cfg, dtype)
    device = resolve_device(device)
    return init(model, seed).eval().to(device)


def compute_dtype(cfg: CoOccConfig) -> Optional[torch.dtype]:
    """The config's compute dtype as the JAX CLIs map it
    (tools/test.py:76-78, tools/train.py:116-118)."""
    return {"bfloat16": torch.bfloat16, "float32": None}[cfg.compute_dtype]


def served_model(cfg: CoOccConfig, device="cuda") -> CoOccRay:
    """The model `python -m coocc_tpu_torch` answers with: weights of seed
    0, in the config's compute dtype."""
    return build_model(cfg, device, seed=0, dtype=compute_dtype(cfg))


class Trainer:
    """A model in training (the config's compute dtype, weights that
    `init(model, seed)` draws), its optimizer (train/state.py, its LR
    schedule counting `steps_per_epoch` updates an epoch) and the
    generator its dropout and cascade priorities draw from, seeded with
    `seed`. `step(batch)` is one train step. With `mesh` (parallel/
    mesh.py) it is this rank's replica on the mesh's device: its generator
    seeded with rank_seed(seed, rank), each step data-parallel over the
    mesh's group on this rank's rows of the global batch."""

    def __init__(self, cfg: CoOccConfig, device="cuda", seed: int = 0, *,
                 steps_per_epoch: int, init=init_weights,
                 mesh: Optional[Mesh] = None):
        device = resolve_device(device if mesh is None else mesh.device)
        self.model = build_model(cfg, device, seed, compute_dtype(cfg),
                                 init).train()
        self.optimizer = make_optimizer(self.model, cfg.optim,
                                        steps_per_epoch)
        self.group = None if mesh is None else mesh.group
        self.generator = torch.Generator(device=device).manual_seed(
            rank_seed(seed, 0 if mesh is None else mesh.rank))

    def step(self, batch):
        return train_step(self.model, self.optimizer, batch, self.generator,
                          self.group)


def train_steps(cfg: CoOccConfig, steps: int, device="cuda", seed: int = 0):
    """`steps` train steps, one epoch, of a new Trainer(cfg, device, seed,
    steps) on the synthetic batches of seeds 0..steps-1 (B=1). -> (trainer,
    [each step's metrics])."""
    trainer = Trainer(cfg, device, seed, steps_per_epoch=steps)
    device = next(trainer.model.parameters()).device
    metrics = [trainer.step(synthetic_batch(cfg, batch_size=1, seed=i)
                            .to(device)) for i in range(steps)]
    return trainer, metrics


def _data_parallel_rank(cfg: CoOccConfig, steps: int, device_type: str,
                        seed: int):
    mesh = make_mesh(device_type=device_type)
    trainer = Trainer(cfg, seed=seed, steps_per_epoch=steps, mesh=mesh)
    metrics = []
    for i in range(steps):
        batch = shard_batch(synthetic_batch(cfg, batch_size=mesh.world,
                                            seed=i), mesh.rank, mesh.world)
        m = trainer.step(batch.to(mesh.device))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def data_parallel_train_steps(cfg: CoOccConfig, steps: int, world: int,
                              backend: str, device="cuda", seed: int = 0):
    """`steps` data-parallel train steps, one epoch, in `world` processes
    of this host joined by `backend` ("nccl" between cards, "gloo" on the
    CPU or for ranks that share a card): each rank a Trainer(cfg, seed)
    replica on its device (parallel/mesh.py), step i on its row of
    synthetic_batch(cfg, batch_size=world, seed=i), as JAX's mesh step
    takes the global batch. -> each rank's metrics of each step, as
    floats (equal across ranks: the loss terms are the ranks' mean)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        device_type = "cpu"
    else:
        resolve_device(dev)
        device_type = "cuda"
    return spawn_ranks(_data_parallel_rank, world, backend,
                       (cfg, steps, device_type, seed))


def entry(device="cuda"):
    """-> (fn, args): fn(*args) is the flagship eval forward on the
    synthetic batch of seed 0, with random weights of seed 0."""
    cfg = get_config(FLAGSHIP)
    model = build_model(cfg, device, seed=0)
    return model, (synthetic_batch(cfg, batch_size=1, seed=0).to(device),)
