"""The cascade's load, set from the traffic.

A model with a cascade refines the coarse cells whose top class is not the
empty one (up to its capacity). Random weights put that share anywhere
from none of the cells to all of them, by seed. So the benchmark sets it:
the coarse cells that hold a LiDAR return of the pool's first frame are
the share the model calls occupied on that frame. `shift` works out the
one number that does so (the empty-class shift of reference/weights.py)
with the fp32 reference on that frame, in eval mode for a served model and
with BatchNorm on the frame's own statistics for a trained one; both sides
are then given the same weights. `counts` reads the load off a forward's
outputs.
"""
from __future__ import annotations

import gc
from typing import Dict, Optional

import torch

from . import weights
from .occref.config import get_config
from .occref.config.tiny import tiny_config
from .occref.models.coocc_ray import Batch, CoOccRay
from .occref.nn.layers import Dropout


def ref_config(config_name: str):
    return tiny_config() if config_name == "tiny" else \
        get_config(config_name)


def has_cascade(cfg) -> bool:
    """The head's own test (nn/occ_head.py: OccHead.cascade)."""
    h = cfg.occ_head
    return h.cascade_ratio != 1 and (h.sample_from_voxel
                                     or h.sample_from_img)


def coarse_grid(cfg):
    r = cfg.occ_head.cascade_ratio
    return tuple(s // r for s in cfg.occ_head.final_occ_size)


def lidar_cells(cfg, frame: Dict[str, torch.Tensor]) -> int:
    """The coarse cells that hold at least one of the frame's valid LiDAR
    points."""
    pts = frame["points"][0][frame["points_mask"][0].bool()][:, :3].float()
    pcr = torch.tensor(cfg.point_cloud_range, dtype=torch.float32,
                       device=pts.device)
    dims = torch.tensor(coarse_grid(cfg), device=pts.device)
    idx = ((pts - pcr[:3]) / (pcr[3:] - pcr[:3]) * dims).floor().long()
    idx = torch.minimum(idx.clamp(min=0), dims - 1)
    lin = (idx[:, 0] * dims[1] + idx[:, 1]) * dims[2] + idx[:, 2]
    return int(lin.unique().numel())


@torch.no_grad()
def shift(config_name: str, seed: int, frame: Dict[str, torch.Tensor],
          device, train: bool) -> Optional[dict]:
    """{"shift": delta, "target_cells": K} such that the seed's weights with
    the empty class's row shifted by delta call exactly the K coarse cells
    occupied on `frame` in the fp32 reference; None for a model without a
    cascade."""
    cfg = ref_config(config_name)
    if not has_cascade(cfg):
        return None
    target = lidar_cells(cfg, frame)
    with torch.device(device):
        model = CoOccRay(cfg, None)
    weights.load(model.to(device), seed)
    model.eval()
    if train:
        # BatchNorm on the frame's own statistics, as a train step runs it;
        # dropout left out (the step draws it from its own generator)
        model.train()
        for m in model.modules():
            if isinstance(m, Dropout):
                m.eval()
    last = model.pts_bbox_head.occ_pred_conv[-1]
    seen = {}
    hook = last.register_forward_hook(
        lambda _m, args, out: seen.update(a=args[0], logits=out))
    batch = Batch(**{k: v.to(device) for k, v in frame.items()})
    model(batch, stop_at="coarse")
    hook.remove()
    a, logits = seen["a"][0].double(), seen["logits"][0].double()
    e = cfg.occ_head.empty_idx
    others = torch.cat([logits[:e], logits[e + 1:]]).amax(0)
    margin = (logits[e] - others).reshape(-1)      # occupied where < 0
    abar = a.mean(0).reshape(-1)    # the shift moves the margin by d*abar
    inf = torch.full_like(margin, float("inf"))
    # a cell is occupied after the shift d where d < r
    r = torch.where(abar > 0, -margin / abar.clamp(min=1e-300),
                    torch.where(margin < 0, inf, -inf))
    r = r.sort(descending=True).values
    k = min(max(target, 1), r.numel() - 1)
    hi, lo = float(r[k - 1]), float(r[k])
    if hi == float("inf"):
        delta = lo + 1.0
    elif lo == float("-inf"):
        delta = hi - 1.0
    else:
        delta = 0.5 * (hi + lo)
    del model, seen, a, logits
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"shift": delta, "target_cells": target}


def counts(out: Dict[str, torch.Tensor], ratio: int, empty_idx: int = 0
           ) -> Dict[str, int]:
    """A forward's coarse cells whose top class is not empty, and the coarse
    cells its cascade refined (valid children / ratio^3)."""
    res = {"occupied": int((out["occ"][0].float().argmax(-1) != empty_idx)
                           .sum())}
    if "fine_valid" in out:
        res["refined"] = int(out["fine_valid"][0].sum()) // ratio ** 3
    return res
