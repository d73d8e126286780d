"""The train and eval steps, on one device or data-parallel.

Counterpart of coocc_tpu/parallel/train_step.py `make_train_step` and
`make_eval_step`. The train step: the training forward (BatchNorm on batch
statistics, which it moves; dropout and the cascade's priorities drawn from
`generator`), the losses, the gradient of their sum, and the optimizer's
update (clip, AdamW, LR schedule; train/state.py). The eval step: the eval
forward (running statistics, no gradient) and its confusion matrices
(`eval_hists`), with the rendered views where the config renders in eval
(render.test_rendering).

Data parallelism (JAX's mesh path, `shard_map` over the data axis,
:66-134): one process per device, each on its rank's rows of the global
batch (parallel/mesh.py), with `group` the run's process group. Each rank
draws its priorities and dropout from its own generator (`rank_seed`, the
counterpart of fold_in(rng, axis_index)), runs the forward under
`bn_sync_group` (SyncBN: every BatchNorm's batch statistics are the
group's; the packed encoders' masked BatchNorms stay rank-local, as JAX's
`_PackedBNCore` does), then the losses and the backward; the gradients are
averaged over the ranks in one all-reduce of one flat fp32 buffer
(`average_gradients`, JAX's pmean), the loss terms too, and every
BatchNorm's running statistics (`average_bn_statistics`: JAX pmeans the
moved batch_stats, which makes the rank-local packed ones equal). The clip
and AdamW then run on equal gradients, so every rank takes the same
update. No DDP wrapper: its default broadcast_buffers copies rank 0's
running statistics where JAX averages them, and its unused-parameter check
raises on the parameters that get no gradient (the LiDAR stem's spconv
weight); the explicit all-reduce after backward() is JAX's explicit pmean.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..evaluation.ssc_metrics import (lidarseg_hist, occupancy_hists,
                                      scatter_fine_into_pred)
from ..models.losses import compute_losses
from ..nn.layers import BatchNorm, Dropout, bn_sync_group
from ..nn.occ_head import forward_lidarseg
from .distributed import allgather_metrics, group_mean_

HISTS = ("SC_hist", "SSC_hist", "SC_hist_visible", "SSC_hist_visible",
         "SC_hist_fine", "SSC_hist_fine", "lidarseg_hist")


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s generator in a run seeded with `seed`:
    `seed` itself on rank 0 (so a run of one rank draws what the
    single-device step draws), a hash of (seed, rank) on the others."""
    if rank == 0:
        return seed
    h = hashlib.sha256(f"{seed}/{rank}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def draw_priorities(model, batch, generator: torch.Generator
                    ) -> torch.Tensor:
    """The cascade's priorities [B, coarse cells] of one step, uniform in
    [0, 1) from `generator` (JAX's uniform(fold_in(rng, 2)))."""
    B = batch.gt_occ.shape[0]
    n = math.prod(model.cfg.lss_grid_size)  # the coarse cells
    return torch.rand((B, n), generator=generator,
                      device=batch.gt_occ.device)


def _mean_over_ranks_(tensors: List[torch.Tensor], group) -> int:
    """Each tensor (one dtype) replaced by its mean over the group's ranks,
    through one all-reduce of their flat concatenation. -> the bytes
    reduced."""
    flat = group_mean_(_flatten_dense_tensors(tensors), group)
    for t, f in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(f)
    return flat.numel() * flat.element_size()


def average_gradients(params: List[torch.nn.Parameter], group) -> int:
    """Every parameter's .grad (a zero one where the backward gave none,
    as the optimizer gives it) replaced by its mean over the ranks: JAX's
    pmean of the gradients (:91-93). -> the bytes all-reduced."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return _mean_over_ranks_([p.grad for p in params], group)


def average_bn_statistics(model, group) -> int:
    """Every BatchNorm's running mean and variance replaced by their mean
    over the ranks (JAX pmeans the moved batch_stats, :113-116): the
    SyncBN ones are equal already, the packed encoders' rank-local ones
    become their mean. -> the bytes all-reduced."""
    stats = [t for m in model.modules() if isinstance(m, BatchNorm)
             for t in (m.running_mean, m.running_var)]
    return _mean_over_ranks_(stats, group) if stats else 0


def train_step(model, optimizer, batch, generator: torch.Generator,
               group=None) -> Dict[str, torch.Tensor]:
    """One update of `model` (a CoOccRay) on `batch`; `generator` lives on
    the batch's device. With `group`, a data-parallel step of this rank
    (batch its rows, generator its own; see the module note). -> {
    "loss_total", every loss term (the ranks' mean), "grad_norm"}, as
    detached scalars on the device (no host sync)."""
    model.train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    prio = draw_priorities(model, batch, generator)
    metrics = loss_and_grads(model, optimizer, batch, prio, group)
    metrics["grad_norm"] = optimizer.step()
    return metrics


def loss_and_grads(model, optimizer, batch, prio: torch.Tensor, group=None
                   ) -> Dict[str, torch.Tensor]:
    """The training forward of `model` on `batch` with the cascade's
    priorities `prio` (BatchNorms synced over `group` where it is given),
    the losses and the gradient of their sum in each parameter's .grad;
    with `group`, the gradients, the loss terms and the BatchNorms' running
    statistics averaged over the ranks. -> {"loss_total", every loss term},
    detached."""
    with bn_sync_group(group):
        outs = model(batch, fine_priorities=prio)
    losses = compute_losses(outs, batch, model.cfg)
    total = sum(v for k, v in losses.items() if k.startswith("loss"))
    optimizer.zero_grad()
    total.backward()
    metrics = {"loss_total": total.detach(),
               **{k: v.detach() for k, v in losses.items()}}
    if group is not None:
        average_gradients(optimizer.params, group)
        values = torch.stack([v.float() for v in metrics.values()])
        _mean_over_ranks_([values], group)
        metrics = {k: v.to(metrics[k].dtype)
                   for k, v in zip(metrics, values)}
        average_bn_statistics(model, group)
    return metrics


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


def eval_step(model, batch, cfg, return_logits: bool = True, group=None
              ) -> Dict[str, torch.Tensor]:
    """The eval forward of `model` (a CoOccRay) on `batch` in model.eval()
    without gradients, and its hists (eval_hists) -> the hists,
    fine_overflow, the rendered render_depth and render_rgb where the
    forward renders (render.test_rendering; render_rgb with the camera
    branch) and, with return_logits, occ_logits and the fine outputs (JAX
    make_eval_step's result). With `group` (data-parallel, batch this
    rank's rows) the hists are summed over the ranks, as JAX's mesh eval
    sums them over the global batch; the per-sample outputs stay this
    rank's rows."""
    model.eval()
    with torch.no_grad():
        outs = model(batch)
        res = eval_hists(outs, batch, cfg)
    if group is not None:
        for k in HISTS:
            if k in res:
                res[k] = allgather_metrics(res[k], group)
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
