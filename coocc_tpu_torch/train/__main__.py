"""Train on synthetic batches:

    python -m coocc_tpu_torch.train coocc_multi_r50_256x704 --synthetic --steps 3

The step loop of `tools/train.py --synthetic` (B=1, one device): seeded
random weights, the config's compute_dtype (bf16 for the flagship), step i
on the synthetic batch of seed i. Prints each step's time and losses. Runs
on the card unless `--device cpu` is given, and raises when there is none.
The epoch loop, checkpoints and eval hooks of tools/train.py are not
ported.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..config import get_config
from ..data.synthetic import synthetic_batch
from ..entry import FLAGSHIP, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m coocc_tpu_torch.train")
    # the port trains the flagship config so far
    ap.add_argument("config", nargs="?", default=FLAGSHIP, choices=[FLAGSHIP])
    ap.add_argument("--synthetic", action="store_true", required=True,
                    help="synthetic batches (no dataset loader is ported)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.config)
    trainer = Trainer(cfg, args.device, args.seed)
    device = next(trainer.model.parameters()).device
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name()} (compute dtype "
              f"{cfg.compute_dtype}, TF32 off)")
    for i in range(args.steps):
        batch = synthetic_batch(cfg, batch_size=1, seed=i).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        values = {k: float(v) for k, v in metrics.items()}
        ms = (time.perf_counter() - t0) * 1e3
        print(f"step {i}: {ms:.1f} ms  " + "  ".join(
            f"{k}={v:.6g}" for k, v in values.items()))


if __name__ == "__main__":
    main()
