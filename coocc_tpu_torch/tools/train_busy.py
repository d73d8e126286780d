"""Device busy time and peak memory of the bf16 train step, config by config:

    python -m coocc_tpu_torch.tools.train_busy [config ...] [--steps 3]

For each config (default: the flagship, OpenOccupancy and coocc_lidar, the
three whose LiDAR encoder runs K2 and its backward), the trainer
`entry.train_steps` builds (seed-0 weights, AdamW, the config's compute
dtype) takes a warm-up step on the synthetic batch of seed 0, then
`--steps` steps (seeds 0, 1, ...) with the peak memory counter reset
before them: the host's wall ms a step (median), the peak GiB, then one
more step under torch.profiler (the device's activity only): its busy ms
(every kernel's device time, summed: one stream) and the part of it in
kernels whose names hold "subm_ext" (K2 and its backward). Prints the
card's name and power limit, then one JSON line per config. It reads only
entry.train_steps, entry.init_weights and data.synthetic.synthetic_batch,
so a copy of it times an older tree of the port in the same call. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from ..config import get_config
from ..data.synthetic import synthetic_batch
from ..entry import init_weights, train_steps
from ..ops._build import load_all_kernel_libraries

TRAINED = ("coocc_multi_r50_256x704", "coocc_multi_r101_openoccupancy",
           "coocc_lidar")


def profiled(step, batch) -> tuple:
    """(device busy ms, busy ms of the "subm_ext" kernels) of step(batch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    busy = k2 = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            k2 += ms if "subm_ext" in e.name else 0.0
    return busy, k2


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m coocc_tpu_torch.tools.train_busy")
    ap.add_argument("configs", nargs="*", default=list(TRAINED))
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_all_kernel_libraries()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    for name in args.configs:
        cfg = get_config(name)
        trainer, _ = train_steps(cfg, 1, "cuda", init=init_weights)
        batches = [synthetic_batch(cfg, batch_size=1, seed=s).to("cuda")
                   for s in range(args.steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for b in batches:
            t0 = time.perf_counter()
            trainer.step(b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy, k2 = profiled(trainer.step, batches[0])
        print(json.dumps({"config": name, "step_ms": statistics.median(ms),
                          "busy_ms": busy, "subm_ext_busy_ms": k2,
                          "peak_gib": peak, "steps": args.steps}),
              flush=True)
        del trainer, batches
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
