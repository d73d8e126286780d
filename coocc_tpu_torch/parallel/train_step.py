"""The single-device train and eval steps.

Counterpart of coocc_tpu/parallel/train_step.py `make_train_step` and
`make_eval_step` with mesh=None. The train step: the training forward
(BatchNorm on batch statistics, which it moves; dropout and the cascade's
priorities drawn from `generator`), the losses, the gradient of their sum,
and the optimizer's update (clip, AdamW, LR schedule; train/state.py). The
eval step: the eval forward (running statistics, no gradient) and its
confusion matrices (`eval_hists`), with the rendered views where the
config renders in eval (render.test_rendering). Data parallelism is not
ported.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..evaluation.ssc_metrics import (lidarseg_hist, occupancy_hists,
                                      scatter_fine_into_pred)
from ..models.losses import compute_losses
from ..nn.layers import Dropout
from ..nn.occ_head import forward_lidarseg


def train_step(model, optimizer, batch, generator: torch.Generator
               ) -> Dict[str, torch.Tensor]:
    """One update of `model` (a CoOccRay) on `batch`; `generator` lives on
    the batch's device. -> {"loss_total", every loss term, "grad_norm"}, as
    detached scalars on the device (no host sync)."""
    model.train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    B = batch.gt_occ.shape[0]
    n = math.prod(model.cfg.lss_grid_size)  # the coarse cells
    prio = torch.rand((B, n), generator=generator,
                      device=batch.gt_occ.device)
    outs = model(batch, fine_priorities=prio)
    losses = compute_losses(outs, batch, model.cfg)
    total = sum(v for k, v in losses.items() if k.startswith("loss"))
    optimizer.zero_grad()
    total.backward()
    norm = optimizer.step()
    return {"loss_total": total.detach(),
            **{k: v.detach() for k, v in losses.items()},
            "grad_norm": norm}


def eval_hists(outs, batch, cfg) -> Dict[str, torch.Tensor]:
    """The confusion matrices of one eval forward's outputs `outs` on
    `batch` (JAX make_eval_step's, after its forward): SC_hist / SSC_hist;
    their _visible pair over batch.visible_mask where it is set (the
    OpenOccupancy protocol, reference coocc_ray_lidar.py:700-707);
    SC_hist_fine / SSC_hist_fine from the cascade's fine logits scattered
    into the full grid (coocc_ray.py:545-554); lidarseg_hist where
    batch.points_occ is set (occ_head.py:339-379, coocc_ray.py:556-560).
    int64 tensors on the outputs' device."""
    occ = outs["occ"]
    sc, ssc = occupancy_hists(occ, batch.gt_occ, cfg.num_classes,
                              cfg.empty_idx)
    res = {"SC_hist": sc, "SSC_hist": ssc}
    if batch.visible_mask is not None:
        sc, ssc = occupancy_hists(occ, batch.gt_occ, cfg.num_classes,
                                  cfg.empty_idx,
                                  extra_mask=batch.visible_mask)
        res["SC_hist_visible"], res["SSC_hist_visible"] = sc, ssc
    if "fine_logits" in outs:
        pred_f = scatter_fine_into_pred(
            outs["fine_logits"], outs["fine_coords"], outs["fine_valid"],
            cfg.occ_head.final_occ_size, cfg.empty_idx)
        sc, ssc = occupancy_hists(pred_f, batch.gt_occ, cfg.num_classes,
                                  cfg.empty_idx)
        res["SC_hist_fine"], res["SSC_hist_fine"] = sc, ssc
    if batch.points_occ is not None:
        logits = forward_lidarseg(occ, batch.points_occ,
                                  batch.points_occ_mask,
                                  cfg.point_cloud_range)
        res["lidarseg_hist"] = lidarseg_hist(
            logits, batch.points_occ[..., -1].long(), batch.points_occ_mask,
            cfg.num_classes)
    return res


def eval_step(model, batch, cfg, return_logits: bool = True
              ) -> Dict[str, torch.Tensor]:
    """The eval forward of `model` (a CoOccRay) on `batch` in model.eval()
    without gradients, and its hists (eval_hists) -> the hists,
    fine_overflow, the rendered render_depth and render_rgb where the
    forward renders (render.test_rendering; render_rgb with the camera
    branch) and, with return_logits, occ_logits and the fine outputs (JAX
    make_eval_step's result)."""
    model.eval()
    with torch.no_grad():
        outs = model(batch)
        res = eval_hists(outs, batch, cfg)
    for k in ("render_depth", "render_rgb"):
        if k in outs:
            res[k] = outs[k]
    if "fine_overflow" in outs:
        res["fine_overflow"] = outs["fine_overflow"]
    if return_logits:
        res["occ_logits"] = outs["occ"]
        for k in ("fine_logits", "fine_coords", "fine_valid"):
            if k in outs:
                res[k] = outs[k]
    return res
