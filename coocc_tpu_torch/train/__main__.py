"""Train a model through the epoch loop (train/loop.py):

    python -m coocc_tpu_torch.train coocc_multi_r50_256x704 --synthetic \
        --steps-per-epoch 2 --max-epochs 1 --work-dir work_dirs/smoke
    python -m coocc_tpu_torch.train coocc_multi_r50_256x704_stereo \
        --synthetic --steps-per-epoch 2 --max-epochs 1
    python -m coocc_tpu_torch.train tiny --synthetic --device cpu \
        --steps-per-epoch 1 --max-epochs 1 --work-dir work_dirs/tiny
    python -m coocc_tpu_torch.train coocc_multi_r50_256x704 --synthetic \
        --devices 2 --steps-per-epoch 2 --max-epochs 1

The twin of tools/train.py (B=1 a device): flax's initial weights
(entry.init_flax), the config's compute_dtype (bf16 for the flagship), each
epoch's steps on the synthetic batches of seeds 0..steps-1, the eval hook
on seeds 1000 and 1001 (4 batches at most), a checkpoint per epoch with
save-best in --work-dir (ckpt_meta.json, metrics.jsonl, config.json,
env.json). `--resume-from <work dir>` continues its last epoch. Runs on the
card unless `--device cpu` is given, and raises when there is none. The
nuScenes loader is not ported: --synthetic is required.

Data-parallel (train/loop.py, parallel/train_step.py): `--devices N`
starts N processes on this host, one a card (rank r on card r; under
`--dist-backend gloo` ranks past the host's cards share them, which NCCL
refuses), joined through a file store. Across hosts each process is one
rank: `--dist-coordinator host:port --dist-num-processes N
--dist-process-id r`, or torchrun's environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK). The backend is
`--dist-backend`: nccl on the card and gloo on the CPU unless given, and
logged. With N ranks, step i's global batch is synthetic_batch(cfg,
batch_size=N, seed=i) and rank r takes sample r (tools/train.py:99-109);
rank 0 writes the logs and checkpoints.
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
from ..parallel.distributed import BACKENDS, launch, world_size
from ..parallel.mesh import make_mesh, shard_batch
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


def dist_backend(args, device: torch.device) -> str:
    """--dist-backend, or by the device's type: nccl on a card, gloo on
    the CPU."""
    return args.dist_backend or ("gloo" if device.type == "cpu" else "nccl")


def rank_setup(device: torch.device):
    """This process's (mesh or None, device, rank, world): the mesh of a
    data-parallel run (its rank's device), else `device` alone. Logging on
    rank 0 only; TF32 off on a card."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    mesh = make_mesh(device_type=device.type) if world_size() > 1 else None
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    if mesh is not None:
        device = mesh.device
        if rank == 0:
            print(f"data-parallel: {world} ranks, backend "
                  f"{torch.distributed.get_backend()}", flush=True)
        else:
            logging.getLogger().setLevel(logging.WARNING)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return mesh, device, rank, world


def global_batches(cfg, seeds, rank: int, world: int, device):
    """The synthetic global batches of `seeds` (B = world), each as rank
    `rank`'s rows on `device`."""
    for s in seeds:
        b = synthetic_batch(cfg, batch_size=world, seed=s)
        yield shard_batch(b, rank, world).to(device)


def _run(args, cfg, work_dir):
    """This process's part of the run: the whole of it, or one rank's."""
    mesh, device, rank, world = rank_setup(resolve_device(args.device))
    if device.type == "cuda" and rank == 0:
        print(f"device: {torch.cuda.get_device_name()} (compute dtype "
              f"{cfg.compute_dtype}, TF32 off)", flush=True)
    steps = args.steps_per_epoch

    def train_iter():
        return global_batches(cfg, range(steps), rank, world, device)

    def val_iter():
        return global_batches(cfg, (1000, 1001), rank, world, device)

    train(cfg, train_iter, val_iter, steps_per_epoch=steps,
          work_dir=work_dir, resume=args.resume_from is not None,
          seed=args.seed, eval_max_steps=4, device=device, mesh=mesh)
    if rank == 0:
        print(f"work dir: {os.path.abspath(work_dir)}")


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
    ap.add_argument("--devices", type=int, default=None,
                    help="data-parallel over N processes of this host, "
                    "one a device")
    # one rank of a run across hosts (tools/dist_train.sh)
    ap.add_argument("--dist-coordinator", default=None,
                    help="host:port of rank 0's store (or a tcp:// or "
                    "file:// URL)")
    ap.add_argument("--dist-num-processes", type=int, default=None)
    ap.add_argument("--dist-process-id", type=int, default=None)
    ap.add_argument("--dist-backend", choices=BACKENDS, default=None,
                    help="nccl (the card's default) or gloo (the CPU's; "
                    "also ranks that share a card)")
    args = ap.parse_args(argv)

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
    launch(_run, (args, cfg, work_dir), args.devices or 1,
           dist_backend(args, resolve_device(args.device)),
           args.dist_coordinator, args.dist_num_processes,
           args.dist_process_id)


if __name__ == "__main__":
    main()
