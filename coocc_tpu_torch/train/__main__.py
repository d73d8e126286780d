"""Train a model through the epoch loop (train/loop.py):

    python -m coocc_tpu_torch.train coocc_lidar --data-root data/nuscenes \
        --ann-file data/nuscenes_infos_temporal_train.pkl \
        --val-ann-file data/nuscenes_infos_temporal_val.pkl \
        --occ-path data/nuscenes_occ --max-epochs 1
    python -m coocc_tpu_torch.train coocc_multi_r50_256x704 --synthetic \
        --steps-per-epoch 2 --max-epochs 1 --work-dir work_dirs/smoke
    python -m coocc_tpu_torch.train coocc_multi_r50_256x704_stereo \
        --synthetic --steps-per-epoch 2 --max-epochs 1
    python -m coocc_tpu_torch.train tiny --synthetic --device cpu \
        --steps-per-epoch 1 --max-epochs 1 --work-dir work_dirs/tiny
    python -m coocc_tpu_torch.train coocc_multi_r50_256x704 --synthetic \
        --devices 2 --steps-per-epoch 2 --max-epochs 1

The twin of tools/train.py (B=1 a device): flax's initial weights
(entry.init_flax), the config's compute_dtype (bf16 for the flagship), a
checkpoint per epoch with save-best in --work-dir (ckpt_meta.json,
metrics.jsonl, config.json, env.json). `--resume-from <work dir>`
continues its last epoch. Runs on the card unless `--device cpu` is given,
and raises when there is none.

The source of the batches is chosen explicitly: `--data-root` (JAX's
default data/nuscenes, given by name) reads a nuScenes tree through the
port's loader (data/nuscenes_dataset.py, data/loader.py: --ann-file and
--val-ann-file, the info pickles, and --occ-path, the occupancy ground
truth, with JAX's defaults; worker threads decode ahead of the step and the
loop copies each batch onto the card), the steps per epoch the training
set's length over the global batch unless --steps-per-epoch is given, the
eval hook over the whole validation set; `--synthetic` takes each epoch's
steps on the synthetic batches of seeds 0..steps-1 (10 unless given) and
the eval hook on seeds 1000 and 1001. Neither or both is an error. A
config without cameras (coocc_lidar) reads no image and imports no PIL;
the camera configs' images need PIL. The run logs a `data:` line at its
end: the source, whether the data path used PIL, and whether PIL is in
the process (TensorBoard's dependencies may import it).

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
rank 0 writes the logs and checkpoints. On a data root each rank reads its
own rows (data/loader.py:group_shard_indices, the reference's
DistributedGroupSampler with one sample a rank).
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import logging
import os
import sys

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


def on_device(batches, device):
    """Each numpy Batch of `batches` copied onto `device` as it is taken
    (on the caller's thread, after the loader's next())."""
    for b in batches:
        yield b.to(device)


def data_line(args) -> str:
    """The run's `data:` line: the batches' source, whether the data path
    used PIL (data/pipelines/image_loading.py:pil_image) and whether PIL
    is imported in this process (another library may import it)."""
    from ..data.pipelines.image_loading import pil_image
    src = "synthetic" if args.synthetic else f"data root {args.data_root}"
    return (f"data: {src}; PIL used by the data path: "
            f"{pil_image.calls > 0}; PIL in the process: "
            f"{'PIL' in sys.modules}")


def _run(args, cfg, work_dir):
    """This process's part of the run: the whole of it, or one rank's."""
    mesh, device, rank, world = rank_setup(resolve_device(args.device))
    if device.type == "cuda" and rank == 0:
        print(f"device: {torch.cuda.get_device_name()} (compute dtype "
              f"{cfg.compute_dtype}, TF32 off)", flush=True)
    if args.synthetic:
        steps = args.steps_per_epoch or 10

        def train_iter():
            return global_batches(cfg, range(steps), rank, world, device)

        def val_iter():
            return global_batches(cfg, (1000, 1001), rank, world, device)
        eval_max_steps = 4
    else:
        from ..data.nuscenes_dataset import build_loaders
        train_np, val_np, steps = build_loaders(
            cfg, args.data_root, args.ann_file, args.val_ann_file,
            args.occ_path, batch_size=1, seed=args.seed,
            process_index=rank, process_count=world)
        steps = args.steps_per_epoch or steps
        if steps < 1:
            raise ValueError(f"{args.ann_file} holds fewer samples than one "
                             f"global batch ({world})")

        def train_iter():
            return on_device(train_np(), device)

        def val_iter():
            return on_device(val_np(), device)
        eval_max_steps = None

    train(cfg, train_iter, val_iter, steps_per_epoch=steps,
          work_dir=work_dir, resume=args.resume_from is not None,
          seed=args.seed, eval_max_steps=eval_max_steps, device=device,
          mesh=mesh)
    if rank == 0:
        logging.getLogger("coocc_tpu_torch").info(data_line(args))
        print(f"work dir: {os.path.abspath(work_dir)}")


def add_data_args(ap, train: bool):
    """The batches' source: --synthetic, or a nuScenes tree (JAX's flags
    and defaults, tools/train.py:30-33, tools/test.py:26-28)."""
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic batches (data/synthetic.py)")
    ap.add_argument("--data-root", default=None,
                    help="a nuScenes tree (JAX's default: data/nuscenes); "
                    "give it or --synthetic")
    if train:
        ap.add_argument("--ann-file",
                        default="data/nuscenes_infos_temporal_train.pkl")
        ap.add_argument("--val-ann-file",
                        default="data/nuscenes_infos_temporal_val.pkl")
    else:
        ap.add_argument("--ann-file",
                        default="data/nuscenes_infos_temporal_val.pkl")
    ap.add_argument("--occ-path", default="data/nuscenes_occ")


def check_data_args(ap, args):
    """Exactly one source, chosen by name: --synthetic or --data-root (an
    existing directory)."""
    if args.synthetic == (args.data_root is not None):
        ap.error("choose the batches' source: --synthetic, or --data-root "
                 "<nuScenes tree> (JAX's default is data/nuscenes)"
                 if not args.synthetic else
                 "--synthetic and --data-root exclude each other")
    if args.data_root is not None and not os.path.isdir(args.data_root):
        ap.error(f"--data-root {args.data_root}: no such directory")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m coocc_tpu_torch.train")
    ap.add_argument("config", help="config name, e.g. coocc_multi_r50_256x704,"
                    " or 'tiny' for the synthetic miniature config")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--resume-from", default=None,
                    help="work dir to resume from (its last epoch)")
    ap.add_argument("--seed", type=int, default=0)
    add_data_args(ap, train=True)
    ap.add_argument("--steps-per-epoch", type=int, default=None,
                    help="steps per epoch (default: the training set's "
                    "length over the global batch, or 10 synthetic ones)")
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
    check_data_args(ap, args)

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
