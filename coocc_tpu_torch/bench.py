"""Benchmark: inference frames/sec on one CUDA card.

    python -m coocc_tpu_torch.bench
    BENCH_CONFIG=coocc_multi_r101_openoccupancy python -m coocc_tpu_torch.bench
    BENCH_CONFIG=coocc_lidar python -m coocc_tpu_torch.bench
    BENCH_CONFIG=coocc_multi_r50_256x704_stereo python -m coocc_tpu_torch.bench

The twin of the JAX package's `bench.py`, with its knobs: BENCH_CONFIG (the
flagship coocc_multi_r50_256x704 by default; coocc_kitti's forward raises
ValueError past its pts prefix, as JAX's fails at its fuser), BENCH_DTYPE
(bf16, the default, or fp32), BENCH_BATCH (1) and BENCH_ITERS (5). The
weights are random (seed 0). One warm-up forward on the batch of seed 0,
then one distinct pre-staged synthetic batch per timed rep (seeds
1..BENCH_ITERS), each forward between two `torch.cuda.synchronize()` calls
and ending in a reduction of every output (so no output can be skipped),
host clock; the median gives frames/sec = BENCH_BATCH / median seconds.

Prints ONE JSON line: {"metric", "value", "unit", "dtype", "device": {"name",
"power_limit"}}. There is no `vs_baseline`: bench.py's 10 frames/sec target
is a TPU one. Raises when there is no CUDA card.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import torch

from .config import get_config
from .data.synthetic import synthetic_batch
from .entry import FLAGSHIP, build_model

DTYPES = {"bf16": torch.bfloat16, "fp32": None}


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (f.strip() for f in line.split(","))
    return {"name": name, "power_limit": limit}


def reduce_outputs(outs) -> torch.Tensor:
    """Sum of |v| over every output, as bench.py reduces its leaves."""
    return sum(v.float().abs().sum() for v in outs.values())


def main():
    cfg_name = os.environ.get("BENCH_CONFIG", FLAGSHIP)
    dtype_name = os.environ.get("BENCH_DTYPE", "bf16")
    dtype = DTYPES[dtype_name]
    B = int(os.environ.get("BENCH_BATCH", "1"))
    reps = int(os.environ.get("BENCH_ITERS", "5"))
    cfg = get_config(cfg_name)
    model = build_model(cfg, "cuda", seed=0, dtype=dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = [synthetic_batch(cfg, batch_size=B, seed=s).to("cuda")
               for s in range(reps + 1)]
    float(reduce_outputs(model(batches[0])))  # warm-up
    ts = []
    for b in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(reduce_outputs(model(b)))
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    print(json.dumps({
        "metric": f"{cfg_name} inference frames/sec/card",
        "value": B / statistics.median(ts),
        "unit": "frames/sec",
        "dtype": dtype_name,
        "device": card(),
    }), flush=True)


if __name__ == "__main__":
    main()
