"""Answer synthetic requests with the eval forward on the card:

    python -m coocc_tpu_torch coocc_multi_r50_256x704 --requests 3

Request i uses the synthetic batch of seed i; the weights are random (seed
0). Raises when there is no CUDA card.
"""
from __future__ import annotations

import argparse
import time

import torch

from .config import get_config
from .data.synthetic import synthetic_batch
from .entry import FLAGSHIP, build_model


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m coocc_tpu_torch")
    # the port runs the flagship config so far
    ap.add_argument("config", nargs="?", default=FLAGSHIP, choices=[FLAGSHIP])
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args(argv)

    cfg = get_config(args.config)
    model = build_model(cfg, "cuda", seed=0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name()} (fp32, TF32 off)")
    for i in range(args.requests):
        batch = synthetic_batch(cfg, batch_size=1, seed=i).to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        print(f"request {i}: {ms:.1f} ms  {shapes}  "
              f"fine_valid={int(out['fine_valid'].sum())}")


if __name__ == "__main__":
    main()
