"""Evaluate a model and print the SC/SSC table:

    python -m coocc_tpu_torch.test coocc_multi_r50_256x704 work_dirs/smoke \
        --synthetic --max-steps 2
    python -m coocc_tpu_torch.test coocc_lidar --synthetic --max-steps 2
    python -m coocc_tpu_torch.test coocc_multi_r50_256x704_stereo \
        --synthetic --max-steps 2
    python -m coocc_tpu_torch.test tiny work_dirs/tiny --synthetic \
        --device cpu --max-steps 1
    python -m coocc_tpu_torch.test coocc_multi_r50_256x704 --synthetic \
        --test-rendering --max-steps 2
    python -m coocc_tpu_torch.test coocc_multi_r50_256x704 work_dirs/smoke \
        --synthetic --devices 2 --max-steps 2

The twin of tools/test.py (B=1 a device), in the config's compute_dtype.
`checkpoint` is a work dir of the train CLI (its last epoch), a reference
`.pth` (its state_dict carries the port's parameter names; parameters it
lacks are warned about and keep flax's initial values), or left out
(flax's initial weights of seed 0, entry.init_flax). --synthetic evaluates
the synthetic batches of seeds 2000.. (2 without --max-steps); --pred-save
dumps each sample's predicted and ground-truth classes as npz.
--test-rendering renders every view in eval and adds the views' mean PSNR
and SSIM to the table; --render-dir (which implies it) also writes each
view's [render | image | depth] PNG there, which needs PIL. The table
names SemanticKITTI's classes for a 20-class config, nuScenes' otherwise.
Runs on the card unless `--device cpu` is given, and raises when there is
none. `--devices N` evaluates data-parallel in N processes of this host,
as the train CLI runs them (`--dist-backend`): batch i is
synthetic_batch(cfg, batch_size=N, seed=2000 + i), rank r takes sample
r, and the hists are summed over the ranks before rank 0 prints the
table. Not ported: the nuScenes loader (--synthetic is required),
--show-dir and --save-by-scene.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config.base import CoOccConfig
from ..config.nuscenes import NUSC_CLASS_NAMES
from ..config.semantic_kitti import KITTI_CLASS_NAMES, NUM_KITTI_CLASSES
from ..entry import (build_model, compute_dtype, config_by_name, init_flax,
                     resolve_device)
from ..evaluation.formatting import print_ssc_table
from ..evaluation.savers import save_output_nuscenes
from ..parallel.distributed import BACKENDS, launch
from ..parallel.train_step import eval_step
from ..train.__main__ import dist_backend, global_batches, rank_setup
from ..train.checkpoint import CheckpointManager
from ..train.loop import sum_eval_hists, summarize

log = logging.getLogger("coocc_tpu_torch")


def load_model(cfg: CoOccConfig, checkpoint: Optional[str], device):
    """CoOccRay(cfg) in its compute dtype with flax's initial weights of
    seed 0, then the checkpoint's (a work dir's last epoch, or a .pth's
    state_dict) where one is given."""
    model = build_model(cfg, device, seed=0, dtype=compute_dtype(cfg),
                        init=init_flax)
    if checkpoint is None:
        return model
    if checkpoint.endswith(".pth"):
        ckpt = torch.load(checkpoint, map_location="cpu")
        missing, unexpected = model.load_state_dict(
            ckpt.get("state_dict", ckpt), strict=False)
        if missing:
            log.warning("checkpoint missing %d parameter leaves, e.g. %s",
                        len(missing), missing[:5])
        if unexpected:
            log.info("checkpoint entries the model does not have, ignored: "
                     "%d, e.g. %s", len(unexpected), unexpected[:5])
        return model
    if not os.path.isdir(checkpoint):
        raise FileNotFoundError(f"no work dir or .pth at {checkpoint}")
    # read on the host: the optimizer's moments (two thirds of the file)
    # never reach the card, and load_state_dict copies the weights there
    tree, epoch = CheckpointManager(checkpoint).restore(map_location="cpu")
    if tree is None:
        raise FileNotFoundError(f"{checkpoint} holds no checkpoint")
    model.load_state_dict(tree["model"])
    log.info("loaded epoch %d of %s", epoch, checkpoint)
    return model


def save_predictions(model, cfg: CoOccConfig, data_iter: Iterable,
                     out_dir: str, max_steps: Optional[int] = None,
                     row0: int = 0):
    """Per sample: the coarse argmax and the ground truth as npz
    (tools/test.py's --pred-save loop), named by the batch and the
    sample's row in the global batch (row0: this rank's first)."""
    for i, batch in enumerate(data_iter):
        if max_steps and i >= max_steps:
            break
        out = eval_step(model, batch, cfg)
        pred = out["occ_logits"].argmax(dim=-1).cpu().numpy()
        for b in range(pred.shape[0]):
            save_output_nuscenes(pred[b], out_dir, f"sample_{i}_{row0 + b}",
                                 gt_voxels=batch.gt_occ[b].cpu().numpy())


def evaluate_checkpoint(cfg: CoOccConfig, checkpoint: Optional[str],
                        data_iter_fn: Callable[[], Iterable], device="cuda",
                        max_steps: Optional[int] = None,
                        pred_save: Optional[str] = None,
                        render_dir: Optional[str] = None, group=None
                        ) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """load_model, the optional prediction dumps, then the eval over
    data_iter_fn() (render_dir and group: sum_eval_hists'; with a group,
    data_iter_fn() gives this rank's one row of each global batch) -> (the
    summary, the summed hists)."""
    model = load_model(cfg, checkpoint, device)
    if pred_save:
        save_predictions(model, cfg, data_iter_fn(), pred_save, max_steps,
                         0 if group is None else dist.get_rank(group))
    sums = sum_eval_hists(model, cfg, data_iter_fn(), max_steps, render_dir,
                          group)
    return summarize(sums), sums


def _run(args, cfg):
    """This process's part of the eval: the whole of it, or one rank's."""
    mesh, device, rank, world = rank_setup(resolve_device(args.device))

    def val_iter():
        return global_batches(cfg, range(2000, 2000 + (args.max_steps or 2)),
                              rank, world, device)

    summary, _ = evaluate_checkpoint(cfg, args.checkpoint, val_iter, device,
                                     args.max_steps, args.pred_save,
                                     args.render_dir,
                                     None if mesh is None else mesh.group)
    if rank == 0:
        print_ssc_table(summary, KITTI_CLASS_NAMES
                        if cfg.num_classes == NUM_KITTI_CLASSES
                        else NUSC_CLASS_NAMES)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m coocc_tpu_torch.test")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None,
                    help="work dir of the train CLI (its last epoch) or a "
                    "reference .pth; flax's initial weights if omitted")
    ap.add_argument("--synthetic", action="store_true", required=True,
                    help="synthetic batches (no dataset loader is ported)")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--pred-save", default=None,
                    help="directory for per-sample npz prediction dumps")
    ap.add_argument("--test-rendering", action="store_true",
                    help="render rgb/depth in eval and report PSNR/SSIM "
                    "(reference: test_rendering=True, coocc_ray.py:562-637)")
    ap.add_argument("--render-dir", default=None,
                    help="write [render | image | depth] PNGs here (needs "
                    "PIL; implies --test-rendering)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=None,
                    help="data-parallel over N processes of this host, "
                    "one a device")
    ap.add_argument("--dist-backend", choices=BACKENDS, default=None,
                    help="nccl (the card's default) or gloo (the CPU's; "
                    "also ranks that share a card)")
    args = ap.parse_args(argv)

    cfg = config_by_name(args.config)
    if args.test_rendering or args.render_dir:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, use_rendering=True, test_rendering=True))
    launch(_run, (args, cfg), args.devices or 1,
           dist_backend(args, resolve_device(args.device)))


if __name__ == "__main__":
    main()
