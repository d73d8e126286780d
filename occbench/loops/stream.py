"""The stream loop: one client, closed loop, B=1. Each frame is copied from
pinned host memory to the card, served by the port's eval forward, and its
outputs copied back into pinned host memory; the next frame starts when
this one is done. A frame's time runs from the start of its copy in to the
end of its copy out.

Set-up makes the traffic's pool of frames, sets the cascade's load from
the first frame (reference/occupancy.py: the fp32 reference works out the
weights' empty-class shift; the card's peak is reset after it, so that
`memory_peak_bytes` is the program's), builds the served model with the
seed's weights and serves every frame of the pool once. The window
then serves the pool in turn for `seconds`; a traced run serves
`trace_frames` frames under the profiler instead. After the window the
outputs of `check_frames` pool frames drawn from the seed (their last
serving) are held against the reference, after the port's state is freed.
"""
from __future__ import annotations

import gc
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

from occbench import frames, port, spans
from occbench import trace as tracing
from occbench.reference import compare, occupancy, weights
from occbench.reference import serve as ref
from occbench.run import process_age_s
from occbench.work import dense, sparse


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_info(device, peak: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def frame_work(spec, pool, slots, device, train: bool):
    """The sparse encoder's work of each pool frame in `slots`, summed."""
    sp = spec.config["sparse"]
    pub = spec.config["published"]
    cap = sp["cap_train"] if train else sp["cap_eval"]
    total = {}
    for s in slots:
        f = pool[s]
        coords = sparse.active_voxels(
            f["points"][0].to(device), f["points_mask"][0].to(device),
            pub["point_cloud_range"], pub["pts.voxel_size"],
            pub["pts.sparse_shape_xyz"], cap)
        for w in sparse.encoder_work(sp["convs"], coords,
                                     pub["pts.sparse_shape_xyz"],
                                     sp["bytes_per_element"]):
            t = total.setdefault(w.name, [w, 0, 0, 0])
            t[1] += w.pairs
            t[2] += w.flop
            t[3] += w.bytes
    return [sparse.ConvWork(w.name, w.kind, w.k2, p, f, b)
            for w, p, f, b in total.values()]


def breakdown(tr: tracing.Trace) -> dict:
    return {"device_ops": [[n, us / 1e6] for n, us in tr.top_kernels(10)],
            "idle_gaps": [[n, us / 1e6] for n, us in tr.idle_gaps(10)]}


def run(spec, seed: int, seconds: float, trace: bool, device, fault=None):
    traffic = spec.traffic
    cuda = torch.device(device).type == "cuda"
    cfg = port.config(spec.config)
    pool = frames.frame_pool(cfg, traffic, seed, device, frames.EVAL_FIELDS)
    occ = occupancy.shift(spec.config["port_config"], seed, pool[0], device,
                          train=False)
    shift = occ["shift"] if occ else 0.0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = port.served_model(cfg, seed, device, shift)
    digest = weights.names_digest(model)
    if trace:
        spans.install_model(model)
    serve_fn = model if fault is None else fault(model)
    bufs = [None] * len(pool)

    def serve(i: int):
        slot = i % len(pool)
        out = serve_fn(port.batch(pool[slot], device))
        if bufs[slot] is None:
            bufs[slot] = {k: torch.empty(v.shape, dtype=v.dtype,
                                         pin_memory=cuda)
                          for k, v in out.items()
                          if isinstance(v, torch.Tensor)}
        for k, b in bufs[slot].items():
            b.copy_(out[k], non_blocking=True)
        sync(device)
        return slot

    for i in range(len(pool) + 1):
        serve(i)
    served = len(pool) + 1
    setup_s = process_age_s()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    times, slots = [], []
    tr = None
    if trace:
        def traced():
            for _ in range(traffic["trace_frames"]):
                with torch.profiler.record_function("occbench.frame"):
                    slots.append(serve(served + len(slots)))
        _, tr = tracing.profile(traced)
        window_s = tr.window_us / 1e6
    else:
        start = time.perf_counter()
        deadline = start + seconds
        end = start
        while not times or end < deadline:
            t0 = time.perf_counter()
            slots.append(serve(served + len(times)))
            end = time.perf_counter()
            times.append(end - t0)
        window_s = end - start
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the check: the last serving of a seeded sample of the pool's frames
    rng = np.random.default_rng([seed, 11])
    check = [int(s) for s in rng.choice(len(pool), traffic["check_frames"],
                                        replace=False)]
    port_outs = [{k: v.clone() for k, v in bufs[s].items()} for s in check]
    del model, serve_fn, bufs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    counter = (lambda m: dense.DenseFlops(m, skip=("pts_middle_encoder",))) \
        if trace else None
    ref_outs, flops, ref_digest = ref.run(
        spec.config["port_config"], seed, [pool[s] for s in check], device,
        counter, shift)
    ratio = cfg.occ_head.cascade_ratio
    numbers = compare.stream_numbers(
        port_outs, ref_outs, (cfg.occ_head.max_coarse_occupied, ratio,
                              cfg.occ_head.empty_idx))
    load = dict(occ or {}, frames=check,
                port=[occupancy.counts(o, ratio) for o in port_outs],
                reference=[occupancy.counts(o, ratio) for o in ref_outs])
    correct, checks = compare.judge(numbers, spec.limits)
    checks["state_names_differ"] = {"value": float(digest != ref_digest),
                                    "limit": 0.0}
    correct = correct and digest == ref_digest

    res = SimpleNamespace(correct=correct, attempted=len(slots), failed=0,
                          checks=checks, numbers=numbers, load=load,
                          device=device_info(device,
                                             max(setup_peak, window_peak)))
    if trace:
        work = frame_work(spec, pool, slots, device, train=False)
        res.ctx = SimpleNamespace(
            kind="stream", trace=tr, units=len(slots), window_s=window_s,
            dense_flop=flops.flop if flops else None, sparse=work,
            train_forwards=1)
        res.device["busy_s"] = tr.busy_us() / 1e6
        res.device["window_s"] = window_s
        res.breakdown = breakdown(tr)
    else:
        res.e2e = {"frames_per_s": len(times) / window_s,
                   "frame_ms_p95": 1e3 * statistics.quantiles(
                       times, n=20)[-1],
                   "peak_gib": window_peak / 2 ** 30,
                   "setup_s": setup_s}
    return res
