"""The reference's eval forward over frames, in fp32 with TF32 off."""
from __future__ import annotations

from typing import Dict, List

import torch

from . import weights
from .occref.config import get_config
from .occref.config.tiny import tiny_config
from .occref.models.coocc_ray import Batch, CoOccRay

OUTPUTS = ("occ", "fine_logits", "fine_coords", "fine_valid")


def fp32_strict():
    """fp32 products in fp32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build(config_name: str, seed: int, device,
          empty_shift: float = 0.0) -> CoOccRay:
    """The reference CoOccRay of the registered config, fp32, with the
    seed's weights (`empty_shift`: weights.draw's), in eval mode, on
    `device`."""
    cfg = tiny_config() if config_name == "tiny" else \
        get_config(config_name)
    with torch.device(device):
        model = CoOccRay(cfg, None)
    # buffers made from numpy (the frustum) are made on the host
    return weights.load(model.to(device), seed, empty_shift).eval()


def forward(model: CoOccRay, frame: Dict[str, torch.Tensor], device,
            counter=None) -> Dict[str, torch.Tensor]:
    """One frame's outputs (the OUTPUTS the model gives), on the host."""
    batch = Batch(**{k: v.to(device) for k, v in frame.items()})
    with torch.no_grad():
        if counter is not None:
            with counter:
                out = model(batch)
        else:
            out = model(batch)
    return {k: out[k].detach().cpu() for k in OUTPUTS if k in out}


def run(config_name: str, seed: int, frames: List[Dict[str, torch.Tensor]],
        device, counter_factory=None, empty_shift: float = 0.0):
    """-> (the reference's outputs of each frame, the counter installed
    on the first frame's forward or None, the digest of the state's names
    and shapes)."""
    fp32_strict()
    model = build(config_name, seed, device, empty_shift)
    digest = weights.names_digest(model)
    counter = None if counter_factory is None else counter_factory(model)
    outs = [forward(model, f, device, counter if i == 0 else None)
            for i, f in enumerate(frames)]
    del model
    return outs, counter, digest
