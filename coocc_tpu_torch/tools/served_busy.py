"""Device busy time of the served eval forward, config by config:

    python -m coocc_tpu_torch.tools.served_busy [config ...] [--requests 3]

For each config (default: SERVED, every shipped config whose whole forward
runs), the model `python -m coocc_tpu_torch` serves (entry.served_model:
seed-0 weights in the config's compute dtype) takes a warm-up request on
the synthetic batch of seed 0, then `--requests` requests (seeds 0, 1, ...,
on the card before the clock starts) under torch.profiler, the device's
activity only, as chip_smoke.py's served phases time them: the busy ms a
request (every kernel's device time, summed: one stream) and the host's
wall ms a request. Prints the card's name and power limit, then one JSON
line per config. It reads only entry.served_model and
data.synthetic.synthetic_batch, so a copy of it times an older tree of the
port in the same call. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..config import get_config
from ..data.synthetic import synthetic_batch
from ..entry import served_model
from ..ops._build import load_all_kernel_libraries

SERVED = ("coocc_multi_r50_256x704", "coocc_multi_r101_openoccupancy",
          "coocc_multi_r101_896x1600", "coocc_cam_r101_896x1600",
          "coocc_lidar", "coocc_multi_r50_256x704_stereo")


def busy_ms(model, requests) -> tuple:
    """(device busy ms, host wall ms) a request over `requests`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in requests:
            model(b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    return busy / len(requests), wall / len(requests)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m coocc_tpu_torch.tools.served_busy")
    ap.add_argument("configs", nargs="*", default=list(SERVED))
    ap.add_argument("--requests", type=int, default=3)
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
        model = served_model(cfg, "cuda")
        requests = [synthetic_batch(cfg, batch_size=1, seed=s).to("cuda")
                    for s in range(args.requests)]
        model(requests[0])                                   # warm-up
        busy, wall = busy_ms(model, requests)
        print(json.dumps({"config": name, "busy_ms": busy, "wall_ms": wall,
                          "requests": args.requests}), flush=True)
        del model, requests
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
