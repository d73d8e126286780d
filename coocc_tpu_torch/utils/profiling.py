"""Profiling and tracing utilities.

Counterpart of coocc_tpu/utils/profiling.py (the reference's per-stage wall
timers with a device sync, record_time/time_stats and logging_latencies,
and its get_flops): `StageTimer` synchronizes the device of the result it
is given before it reads the clock, `trace` records a torch.profiler
chrome trace, `flops_and_bytes` counts a call's FLOPs
(torch.utils.flop_counter) and its peak device allocation, and
`parameter_count` sums a module's parameters.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict

import numpy as np
import torch


def _sync(result) -> None:
    """Wait for the devices of the tensors in `result` (nested lists,
    tuples and dicts too): a CUDA tensor synchronizes its device."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _sync(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _sync(v)


class StageTimer:
    """Wall times per named stage, each ending after the stage's result
    is ready on its device."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stats: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if result is not None:
            _sync(result)
        self.stats[name].append(time.perf_counter() - t0)

    def record(self, name: str, value, t0: float):
        _sync(value)
        self.stats[name].append(time.perf_counter() - t0)

    def report(self) -> str:
        """Each stage's mean seconds and share, as the reference's
        logging_latencies prints them."""
        avg = {k: float(np.mean(v)) for k, v in self.stats.items()}
        total = sum(avg.values()) or 1.0
        return ", ".join(
            f"{k}: {v:.4f}s ({v / total:.0%})" for k, v in avg.items())


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the host, and CUDA where a card is
    present), its chrome trace written to log_dir/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def flops_and_bytes(fn: Callable, *args, device=None) -> Dict[str, float]:
    """One call of fn(*args): its FLOPs as torch.utils.flop_counter counts
    them (matmuls, convolutions and attention, 2 a multiply-add) and, on a
    CUDA device, the peak bytes the allocator held during the call above
    what it held before ("temp_bytes"). XLA's "bytes_accessed" and
    "code_bytes" have no PyTorch counterpart and are not returned."""
    from torch.utils.flop_counter import FlopCounterMode
    out = {}
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    out["flops"] = float(counter.get_total_flops())
    if cuda:
        torch.cuda.synchronize(device)
        out["temp_bytes"] = float(torch.cuda.max_memory_allocated(device)
                                  - base)
    return out


def parameter_count(module: torch.nn.Module) -> int:
    """The number of parameter values (fvcore.parameter_count's total)."""
    return int(sum(p.numel() for p in module.parameters()))
