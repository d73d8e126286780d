"""Evaluate a model and print the SC/SSC table:

    python -m coocc_tpu_torch.test coocc_multi_r50_256x704 work_dirs/smoke \
        --synthetic --max-steps 2
    python -m coocc_tpu_torch.test tiny work_dirs/tiny --synthetic \
        --device cpu --max-steps 1

The twin of tools/test.py (one device, B=1), in the config's compute_dtype.
`checkpoint` is a work dir of the train CLI (its last epoch), a reference
`.pth` (its state_dict carries the port's parameter names; parameters it
lacks are warned about and keep flax's initial values), or left out
(flax's initial weights of seed 0, entry.init_flax). --synthetic evaluates
the synthetic batches of seeds 2000.. (2 without --max-steps); --pred-save
dumps each sample's predicted and ground-truth classes as npz. Runs on the
card unless `--device cpu` is given, and raises when there is none. Not
ported: the nuScenes loader (--synthetic is required), eval-time rendering,
--show-dir and --save-by-scene.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..config.base import CoOccConfig
from ..config.nuscenes import NUSC_CLASS_NAMES
from ..data.synthetic import synthetic_batch
from ..entry import (build_model, compute_dtype, config_by_name, init_flax,
                     resolve_device)
from ..evaluation.formatting import print_ssc_table
from ..evaluation.savers import save_output_nuscenes
from ..parallel.train_step import eval_step
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
                     out_dir: str, max_steps: Optional[int] = None):
    """Per sample: the coarse argmax and the ground truth as npz
    (tools/test.py's --pred-save loop)."""
    for i, batch in enumerate(data_iter):
        if max_steps and i >= max_steps:
            break
        out = eval_step(model, batch, cfg)
        pred = out["occ_logits"].argmax(dim=-1).cpu().numpy()
        for b in range(pred.shape[0]):
            save_output_nuscenes(pred[b], out_dir, f"sample_{i}_{b}",
                                 gt_voxels=batch.gt_occ[b].cpu().numpy())


def evaluate_checkpoint(cfg: CoOccConfig, checkpoint: Optional[str],
                        data_iter_fn: Callable[[], Iterable], device="cuda",
                        max_steps: Optional[int] = None,
                        pred_save: Optional[str] = None
                        ) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """load_model, the optional prediction dumps, then the eval over
    data_iter_fn() -> (the summary, the summed hists)."""
    model = load_model(cfg, checkpoint, device)
    if pred_save:
        save_predictions(model, cfg, data_iter_fn(), pred_save, max_steps)
    sums = sum_eval_hists(model, cfg, data_iter_fn(), max_steps)
    return summarize(sums), sums


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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    cfg = config_by_name(args.config)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def val_iter():
        for i in range(args.max_steps or 2):
            yield synthetic_batch(cfg, batch_size=1, seed=2000 + i).to(device)

    summary, _ = evaluate_checkpoint(cfg, args.checkpoint, val_iter, device,
                                     args.max_steps, args.pred_save)
    print_ssc_table(summary, NUSC_CLASS_NAMES)


if __name__ == "__main__":
    main()
