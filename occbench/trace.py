"""The traced part of a `--trace 1` run, reduced to what the per-layer
readers read.

torch.profiler records the host's runtime calls and the benchmark's own
ranges (record_function) beside the device's kernels and copies; its
chrome trace is written to a temporary file, read back and deleted. A
device event belongs to the range that was open on the host when its
launch was issued (the runtime call with the same correlation id): that is
how a stage's device time is the time of the kernels launched inside it.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
# the runtime calls at which the host waits for the device
SYNC_NAMES = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class Trace:
    """Device events (name, start us, duration us, range names open at
    launch), host runtime calls (name, start us, open ranges), the ranges
    themselves (name -> [(start, end)]) and the traced window in us."""
    device: List[Tuple[str, float, float, Tuple[str, ...]]] = \
        field(default_factory=list)
    runtime: List[Tuple[str, float, Tuple[str, ...]]] = \
        field(default_factory=list)
    ranges: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    window_us: float = 0.0

    def busy_us(self) -> float:
        """The union of the device events' intervals."""
        spans = sorted((s, s + d) for _, s, d, _ in self.device)
        busy, end = 0.0, float("-inf")
        for s, e in spans:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def kernel_us(self, names, within: str = None) -> float:
        """The summed duration of kernels whose name contains one of
        `names` (all kernels for None), launched inside range `within`
        where it is given."""
        return sum(d for n, _, d, r in self.device
                   if (names is None or any(k in n for k in names))
                   and (within is None or within in r))

    def count_runtime(self, names, within: str) -> int:
        return sum(1 for n, _, r in self.runtime
                   if n in names and within in r)

    def top_kernels(self, k: int = 10):
        by = {}
        for n, _, d, _ in self.device:
            by[n] = by.get(n, 0.0) + d
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The longest gaps between device events, each named by the
        innermost benchmark range open on the host when it began."""
        spans = sorted((s, s + d) for _, s, d, _ in self.device)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        return [(self.open_at(t0), g) for g, t0 in gaps[:k]]

    def open_at(self, t: float) -> str:
        inner, width = "host", float("inf")
        for name, spans in self.ranges.items():
            for s, e in spans:
                if s <= t <= e and e - s < width:
                    inner, width = name, e - s
        return inner


def _open_ranges(ranges, t: float) -> Tuple[str, ...]:
    out = []
    for name, (starts, spans) in ranges.items():
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][1] >= t:
            out.append(name)
    return tuple(out)


def parse(path: str, prefix: str = "occbench.") -> Trace:
    """A chrome trace written by torch.profiler -> Trace, keeping only the
    ranges whose names start with `prefix`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges: Dict[str, List[Tuple[float, float]]] = {}
    launch_at: Dict[int, float] = {}
    runtime_raw = []
    device_raw = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(prefix):
            ranges.setdefault(name[len(prefix):], []).append((ts, ts + dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_at[corr] = ts
            runtime_raw.append((name, ts))
        elif cat in DEVICE_CATS:
            device_raw.append((name, ts, dur,
                               e.get("args", {}).get("correlation")))
    index = {}
    for name, spans in ranges.items():
        spans.sort()
        index[name] = ([s for s, _ in spans], spans)
    tr = Trace(ranges=ranges)
    for name, ts, dur, corr in device_raw:
        t = launch_at.get(corr)
        tr.device.append((name, ts, dur,
                          () if t is None else _open_ranges(index, t)))
    for name, ts in runtime_raw:
        tr.runtime.append((name, ts, _open_ranges(index, ts)))
    win = ranges.get("window", [])
    tr.window_us = sum(e - s for s, e in win)
    return tr


def profile(fn):
    """Run fn() under torch.profiler (host and device activity) and return
    (fn's result, Trace). The trace file goes to the temporary directory
    and is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("occbench.window"):
            result = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return result, parse(path)
    finally:
        os.unlink(path)
