"""Answer synthetic requests with the eval forward on the card:

    python -m coocc_tpu_torch coocc_multi_r50_256x704 --requests 3
    python -m coocc_tpu_torch coocc_multi_r101_openoccupancy --requests 3
    python -m coocc_tpu_torch coocc_lidar --requests 3
    python -m coocc_tpu_torch coocc_multi_r50_256x704_stereo --requests 3

The twin of `tools/test.py --synthetic`: the model computes in the config's
`compute_dtype` (bf16 for every shipped config), as tools/test.py:76-78
maps it. Request i uses the synthetic batch of seed i; the weights are
random (seed 0). Any registered config name is taken. coocc_kitti builds,
and its forward raises ValueError past its pts prefix: its LiDAR grid is
not its fuser's, and JAX's model fails there too (models/coocc_ray.py).
Raises when there is no CUDA card.
"""
from __future__ import annotations

import argparse
import time

import torch

from .config import get_config, list_configs
from .data.synthetic import synthetic_batch
from .entry import FLAGSHIP, served_model


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m coocc_tpu_torch")
    ap.add_argument("config", nargs="?", default=FLAGSHIP,
                    choices=list_configs())
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args(argv)

    cfg = get_config(args.config)
    model = served_model(cfg, "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name()} (compute dtype "
          f"{str(model.dtype)[6:]}, TF32 off)")
    for i in range(args.requests):
        batch = synthetic_batch(cfg, batch_size=1, seed=i).to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        # a model without the cascade (coocc_lidar) returns occ alone
        fine = f"  fine_valid={int(out['fine_valid'].sum())}" \
            if "fine_valid" in out else ""
        print(f"request {i}: {ms:.1f} ms  {shapes}{fine}")


if __name__ == "__main__":
    main()
