"""What the benchmark takes from the program under test, the port
coocc_tpu_torch: its registered configurations, its model builder and
Trainer, and its Batch. Nothing else of the port is read."""
from __future__ import annotations

from typing import Any

from .reference import weights


def _field(cfg: Any, dotted: str):
    for part in dotted.split("."):
        cfg = getattr(cfg, part)
    return cfg


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def config(config_file: dict):
    """The port's registered config that the configuration's file names,
    after checking that every size the file states is the one the port
    runs (a RuntimeError names the first that is not)."""
    from coocc_tpu_torch.entry import config_by_name
    cfg = config_by_name(config_file["port_config"])
    for key, want in config_file["published"].items():
        have = _field(cfg, key)
        if not _same(have, want):
            raise RuntimeError(f"{config_file['port_config']}: {key} is "
                               f"{have!r} in the port, {want!r} in the "
                               "benchmark's configuration file")
    if cfg.compute_dtype != config_file["dtype"]:
        raise RuntimeError(f"the port computes {cfg.compute_dtype}, the "
                           f"configuration states {config_file['dtype']}")
    return cfg


def served_model(cfg, seed: int, device, empty_shift: float = 0.0):
    """The eval model the port serves, in the config's compute dtype, with
    the benchmark's weights of `seed` (build_model's init; `empty_shift`
    as reference/weights.py)."""
    from coocc_tpu_torch.entry import build_model, compute_dtype
    return build_model(cfg, device, seed, compute_dtype(cfg),
                       init=weights.loader(empty_shift))


def trainer(cfg, seed: int, device, steps_per_epoch: int,
            empty_shift: float = 0.0):
    """The port's Trainer with the benchmark's weights of `seed`."""
    from coocc_tpu_torch.entry import Trainer
    return Trainer(cfg, device, seed, steps_per_epoch=steps_per_epoch,
                   init=weights.loader(empty_shift))


def batch(frame: dict, device, non_blocking: bool = True):
    """A frame's tensors copied to `device` as the port's Batch."""
    from coocc_tpu_torch.models.coocc_ray import Batch
    return Batch(**{k: v.to(device, non_blocking=non_blocking)
                    for k, v in frame.items()})
