"""Where a served model's host time goes, on the card:

    python -m coocc_tpu_torch.tools.host_profile [config] [--impl IMPL]

Builds the config (the flagship by default) as `python -m coocc_tpu_torch`
serves it (its config's compute dtype, seeded random weights; `--impl`
sets pts.impl, the LiDAR encoder's route: gather, dense, packed,
packed_hd), warms it up, then prints for one request each:
  * the synchronizing calls (file:line in the port), from
    torch.cuda.set_sync_debug_mode: each stalls the host until the device
    has caught up;
  * the kernel launches and ATen ops, and the host's own time
    (torch.profiler);
  * per `stop_at` prefix, when the host returns from the forward and when
    the device is done: where the two are close, the host sets the pace.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time
import warnings

import torch

from ..config import get_config, list_configs
from ..data.synthetic import synthetic_batch
from ..entry import FLAGSHIP, served_model
from ..models.coocc_ray import STAGES
from ..ops._build import load_all_kernel_libraries

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


def sync_sites(model, batch) -> collections.Counter:
    """The synchronizing calls of one forward of `model` on `batch` (each
    stalls the host until the device has caught up), by file:line in the
    port (torch.cuda.set_sync_debug_mode)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return collections.Counter(
        f"{w.filename.split('coocc_tpu_torch/')[-1]}:{w.lineno}"
        for w in caught if "synchronizing" in str(w.message))


def main(argv=None):
    from torch.profiler import ProfilerActivity, profile
    ap = argparse.ArgumentParser(
        prog="python -m coocc_tpu_torch.tools.host_profile")
    ap.add_argument("config", nargs="?", default=FLAGSHIP,
                    choices=list_configs())
    ap.add_argument("--impl", default=None,
                    help="pts.impl, the LiDAR encoder's route")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_all_kernel_libraries()
    cfg = get_config(args.config)
    if args.impl:
        cfg = dataclasses.replace(cfg, pts=dataclasses.replace(
            cfg.pts, impl=args.impl))
    model = served_model(cfg, "cuda")
    requests = [synthetic_batch(cfg, batch_size=1, seed=s).to("cuda")
                for s in range(3)]
    enc = type(model.pts_middle_encoder).__name__ if cfg.use_lidar \
        else None
    print(f"{torch.cuda.get_device_name()}: {args.config}, compute dtype "
          f"{str(model.dtype)[6:]}, LiDAR encoder {enc}")
    with torch.no_grad():
        model(requests[0])
        where = sync_sites(model, requests[1])
        print(f"synchronizing calls in one forward: {sum(where.values())}")
        for loc, n in sorted(where.items()):
            print(f"  {n} x coocc_tpu_torch/{loc}")

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(requests[2])
            torch.cuda.synchronize()
        events = prof.key_averages()
        launches = sum(e.count for e in events if e.key in LAUNCHES)
        aten = sum(e.count for e in events if e.key.startswith("aten::"))
        host = sum(e.self_cpu_time_total for e in events) / 1e3
        print(f"one forward: {launches} kernel launches, {aten} ATen ops, "
              f"{host:.3f} ms of host time (profiled)")

        for stop in STAGES + (None,):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(requests[2], stop_at=stop)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print(f"prefix {stop or 'full':6s}: the host returns after "
                  f"{(t1 - t0) * 1e3:8.3f} ms, the device is done after "
                  f"{(t2 - t0) * 1e3:8.3f} ms")


if __name__ == "__main__":
    main()
