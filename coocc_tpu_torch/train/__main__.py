"""Train a model through the epoch loop (train/loop.py):

    python -m coocc_tpu_torch.train coocc_multi_r50_256x704 --synthetic \
        --steps-per-epoch 2 --max-epochs 1 --work-dir work_dirs/smoke
    python -m coocc_tpu_torch.train tiny --synthetic --device cpu \
        --steps-per-epoch 1 --max-epochs 1 --work-dir work_dirs/tiny

The twin of tools/train.py (one device, B=1): flax's initial weights
(entry.init_flax), the config's compute_dtype (bf16 for the flagship), each
epoch's steps on the synthetic batches of seeds 0..steps-1, the eval hook
on seeds 1000 and 1001 (4 batches at most), a checkpoint per epoch with
save-best in --work-dir (ckpt_meta.json, metrics.jsonl, config.json,
env.json). `--resume-from <work dir>` continues its last epoch. Runs on the
card unless `--device cpu` is given, and raises when there is none. The
nuScenes loader is not ported: --synthetic is required.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import logging
import os

import torch

from ..data.synthetic import synthetic_batch
from ..entry import config_by_name, resolve_device
from .loop import train


def apply_overrides(cfg, options):
    """key=value overrides of top-level config fields (tools/train.py's
    --cfg-options); a value is a Python literal or else a string."""
    for opt in options:
        k, v = opt.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        cfg = dataclasses.replace(cfg, **{k: v})
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m coocc_tpu_torch.train")
    ap.add_argument("config", help="config name, e.g. coocc_multi_r50_256x704,"
                    " or 'tiny' for the synthetic miniature config")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--resume-from", default=None,
                    help="work dir to resume from (its last epoch)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic", action="store_true", required=True,
                    help="synthetic batches (no dataset loader is ported)")
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--max-epochs", type=int, default=None)
    ap.add_argument("--cfg-options", nargs="*", default=[],
                    help="key=value overrides on the top-level config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    cfg = apply_overrides(config_by_name(args.config), args.cfg_options)
    if args.max_epochs is not None:
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
            cfg.optim, max_epochs=args.max_epochs))
    if args.work_dir and args.resume_from \
            and os.path.abspath(args.work_dir) != \
            os.path.abspath(args.resume_from):
        ap.error("--resume-from continues in its own work dir: give "
                 "--work-dir the same directory or leave it out")
    work_dir = args.work_dir or args.resume_from or os.path.join(
        "work_dirs", cfg.name)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name()} (compute dtype "
              f"{cfg.compute_dtype}, TF32 off)", flush=True)
    steps = args.steps_per_epoch

    def train_iter():
        for i in range(steps):
            yield synthetic_batch(cfg, batch_size=1, seed=i).to(device)

    def val_iter():
        for i in range(2):
            yield synthetic_batch(cfg, batch_size=1, seed=1000 + i).to(device)

    train(cfg, train_iter, val_iter, steps_per_epoch=steps,
          work_dir=work_dir, resume=args.resume_from is not None,
          seed=args.seed, eval_max_steps=4, device=device)
    print(f"work dir: {os.path.abspath(work_dir)}")


if __name__ == "__main__":
    main()
