"""The epoch loop with its eval hook and save-best checkpoints.

Counterpart of coocc_tpu/train/loop.py `evaluate` and `train` (reference
custom_train_detector, apis/mmdet_train.py:29-199 + mmcv's
EpochBasedRunner + OccDistEvalHook, eval_hooks.py:27-87): iterate epochs,
take the train step (parallel/train_step.py), log the losses every
`log_interval` steps, evaluate each epoch, checkpoint with
save_best='SSC_mIoU'. Data-parallel (a Mesh of parallel/mesh.py: one
process per device, each given its rank's rows by the caller's iterators):
every rank steps (parallel/train_step.py with the mesh's group), the eval
hists are summed over the ranks at the end (parallel/distributed.py:
allgather_metrics, JAX's `_all_proc_sum`, train/loop.py:29-37) and the
rendered views' scores gathered, so every
rank holds the run's summary; rank 0 alone logs the metrics and writes the
checkpoints while the others wait at a barrier; on resume every rank
restores the same checkpoint.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config.base import CoOccConfig
from ..entry import Trainer, init_flax
from ..evaluation.formatting import cm_to_ious
from ..evaluation.render_metrics import (compute_psnr, compute_ssim,
                                         save_rendered_img)
from ..evaluation.ssc_metrics import ssc_summary
from ..parallel.distributed import (allgather_metrics, is_main_process,
                                    world_size)
from ..parallel.mesh import Mesh
from ..parallel.train_step import HISTS, eval_step
from .checkpoint import CheckpointManager
from .observe import MetricsLogger, dump_run_metadata

log = logging.getLogger("coocc_tpu_torch")


def sum_eval_hists(model, cfg: CoOccConfig, data_iter: Iterable,
                   max_steps: Optional[int] = None,
                   render_dir: Optional[str] = None,
                   group=None) -> Dict[str, np.ndarray]:
    """The eval step over `data_iter` (at most max_steps batches, each a
    Batch on the model's device) -> each hist the step returns, summed on
    the host in int64, and where the step renders rgb (the config's
    render.test_rendering) "render_PSNR" and "render_SSIM": each view's
    against the batch's image (JAX train/loop.py:72-89), with render_dir
    each view's [render | image | depth] PNG there (PIL). Logs each
    batch's eval time (host clock, from the step's start until its hists
    and views are on the host) and JAX's warning when the cascade's
    capacity dropped occupied cells. With `group` (data_iter this rank's
    rows) the hists are summed over the ranks, the views' scores gathered
    (rank order) and the dropped cells' maximum taken over them."""
    sums: Dict[str, np.ndarray] = {}
    views = {"render_PSNR": [], "render_SSIM": []}
    overflow = n = 0
    ms = []
    for batch in data_iter:
        t0 = time.perf_counter()
        out = eval_step(model, batch, cfg, return_logits=False)
        for k in HISTS:
            if k in out:
                h = out[k].cpu().numpy().astype(np.int64)
                sums[k] = sums[k] + h if k in sums else h
        if "render_rgb" in out and batch.imgs is not None:
            rgb = out["render_rgb"].float().cpu().numpy()
            dep = out["render_depth"].float().cpu().numpy()
            gt = batch.imgs.float().cpu().numpy()
            for b in range(rgb.shape[0]):
                for v in range(rgb.shape[1]):
                    views["render_PSNR"].append(compute_psnr(rgb[b, v],
                                                             gt[b, v]))
                    views["render_SSIM"].append(compute_ssim(rgb[b, v],
                                                             gt[b, v]))
                    if render_dir is not None:
                        save_rendered_img(rgb[b, v], gt[b, v], dep[b, v],
                                          os.path.join(
                                              render_dir,
                                              f"render_{n}_{b}_cam{v}.png"))
        ms.append((time.perf_counter() - t0) * 1e3)
        if "fine_overflow" in out:
            overflow = max(overflow, int(out["fine_overflow"].max()))
        n += 1
        if max_steps is not None and n >= max_steps:
            break
    log.info("eval: %d batches, ms a batch %s", n,
             [round(t, 3) for t in ms])
    if world_size(group) > 1:
        device = next(model.parameters()).device
        sums = {k: allgather_metrics(v, group, device)
                for k, v in sums.items()}
        for k, v in views.items():
            parts = [None] * world_size(group)
            dist.all_gather_object(parts, v, group=group)
            views[k] = [x for part in parts for x in part]
        top = torch.tensor(overflow, device=device)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        overflow = int(top)
    if overflow > 0:
        log.warning(
            "cascade eval capacity exceeded by up to %d occupied coarse "
            "cells (max_coarse_occupied=%d) — fine refinement silently "
            "truncated; raise cfg.occ_head.max_coarse_occupied", overflow,
            cfg.occ_head.max_coarse_occupied)
    sums.update({k: np.asarray(v) for k, v in views.items() if v})
    return sums


def summarize(sums: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Summed hists -> JAX evaluate's summary: ssc_summary's keys, and
    SSC_mIoU / SC_IoU of the _visible and _fine hists, lidarseg_mIoU, and
    the mean render_PSNR and render_SSIM over the views, where those are
    there."""
    summary = ssc_summary(sums["SC_hist"], sums["SSC_hist"])
    for tag in ("visible", "fine"):
        if f"SSC_hist_{tag}" in sums:
            s = ssc_summary(sums[f"SC_hist_{tag}"], sums[f"SSC_hist_{tag}"])
            summary[f"SSC_mIoU_{tag}"] = s["SSC_mIoU"]
            summary[f"SC_IoU_{tag}"] = s["SC_IoU"]
    if "lidarseg_hist" in sums:
        summary["lidarseg_mIoU"] = float(
            np.nanmean(cm_to_ious(sums["lidarseg_hist"])[1:]))
    for k in ("render_PSNR", "render_SSIM"):
        if k in sums:
            summary[k] = float(np.mean(sums[k]))
    return summary


def evaluate(model, cfg: CoOccConfig, data_iter: Iterable,
             max_steps: Optional[int] = None,
             render_dir: Optional[str] = None, group=None) -> Dict[str, float]:
    """The eval over data_iter (the model in eval mode, running
    statistics) -> the summary of its summed hists (and rendered views'
    scores; sum_eval_hists, over the group's ranks where one is given)."""
    return summarize(sum_eval_hists(model, cfg, data_iter, max_steps,
                                    render_dir, group))


def train(cfg: CoOccConfig, train_iter_fn: Callable[[], Iterable],
          val_iter_fn: Optional[Callable[[], Iterable]] = None,
          steps_per_epoch: int = 1000, work_dir: str = "work_dirs/run",
          resume: bool = False, seed: int = 0, log_interval: int = 50,
          eval_max_steps: Optional[int] = None, device="cuda",
          mesh: Optional[Mesh] = None) -> Trainer:
    """cfg.optim.max_epochs epochs of steps_per_epoch train steps on the
    batches train_iter_fn() yields (on `device`), from the weights
    init_flax draws with `seed`; after each epoch the eval over
    val_iter_fn() (at most eval_max_steps batches) and a checkpoint in
    work_dir. With resume, the run continues after the last checkpoint's
    epoch from its weights, BN statistics, AdamW moments and LR count. The
    generator of dropout and the cascade's priorities starts from `seed`
    on every start, resumed or not (JAX keeps no RNG in its checkpoint).
    With `mesh` (its device in place of `device`) the run is data-parallel
    (the module note). -> the Trainer (model, optimizer, generator)."""
    trainer = Trainer(cfg, device, seed, steps_per_epoch=steps_per_epoch,
                      init=init_flax, mesh=mesh)
    model, optimizer = trainer.model, trainer.optimizer
    device = next(model.parameters()).device
    group = None if mesh is None else mesh.group
    main = is_main_process()

    ckpt = CheckpointManager(work_dir, max_keep=1)
    start_epoch = 0
    if resume:
        tree, epoch = ckpt.restore(map_location=device)
        if tree is not None:
            model.load_state_dict(tree["model"])
            optimizer.load_state_dict(tree["optimizer"])
            start_epoch = tree["epoch"] + 1
            log.info("resumed from epoch %d", epoch)

    mlog = None
    if main:
        dump_run_metadata(work_dir, cfg)
        mlog = MetricsLogger(work_dir)

    for epoch in range(start_epoch, cfg.optim.max_epochs):
        t0 = time.time()
        running: Dict[str, float] = {}
        for i, batch in enumerate(train_iter_fn()):
            if i >= steps_per_epoch:
                break
            metrics = trainer.step(batch)
            values = {k: float(v) for k, v in metrics.items()}
            if (i + 1) % log_interval == 0 and main:
                log.info("epoch %d iter %d: %s", epoch, i + 1,
                         {k: round(v, 4) for k, v in values.items()})
                mlog.log("train", epoch=epoch, iter=i + 1, **values)
            running = {k: running.get(k, 0.0) + v for k, v in values.items()}

        n_it = max(min(i + 1, steps_per_epoch), 1)
        if main:
            log.info("epoch %d done in %.1fs", epoch, time.time() - t0)
            mlog.log("epoch", epoch=epoch, time_s=time.time() - t0,
                     **{k: v / n_it for k, v in running.items()})

        metrics_out = None
        if val_iter_fn is not None:
            metrics_out = evaluate(model, cfg, val_iter_fn(),
                                   max_steps=eval_max_steps, group=group)
            model.train()
            if main:
                log.info("epoch %d eval: SC IoU %.4f SSC mIoU %.4f", epoch,
                         metrics_out["SC_IoU"], metrics_out["SSC_mIoU"])
                mlog.log("val", epoch=epoch, **metrics_out)

        if main:
            ckpt.save({"model": model.state_dict(),
                       "optimizer": optimizer.state_dict(), "epoch": epoch},
                      epoch, metrics=metrics_out)
        if group is not None:
            dist.barrier(group)
    if main:
        mlog.close()
    return trainer
