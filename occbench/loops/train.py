"""The train loop: B=1 steps of the port's Trainer, as its loop runs at
samples_per_gpu=1. Each step copies its host batch to the card and runs
`Trainer.step`; a step's time runs from the start of its copy to the end
of the step (a synchronize).

Set-up makes the pool of frames, sets the cascade's load from the first
frame (reference/occupancy.py, BatchNorm on the frame's statistics as in
a train step; the card's peak is reset after it), builds one Trainer from
the seed's weights and drives it through its first `check_steps` steps on
distinct frames, through the window's own call and feed: those steps are
what the reference follows (their loss terms, the first gradient as AdamW
holds it, each leaf's change over the steps). The same Trainer then runs the
window on the pool's frames in turn; a traced run traces `trace_steps`
steps instead. After the window the Trainer is freed and the reference
takes the same steps in fp32.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from occbench import frames, port, spans
from occbench import trace as tracing
from occbench.loops.stream import breakdown, device_info, frame_work, sync
from occbench.reference import train as ref_train
from occbench.reference import compare, occupancy, weights
from occbench.run import process_age_s
from occbench.work import dense, peaks


def run(spec, seed: int, seconds: float, trace: bool, device, fault=None):
    traffic = spec.traffic
    cuda = torch.device(device).type == "cuda"
    cfg = port.config(spec.config)
    pool = frames.frame_pool(cfg, traffic, seed, device)
    occ = occupancy.shift(spec.config["port_config"], seed, pool[0], device,
                          train=True)
    shift = occ["shift"] if occ else 0.0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    trainer = port.trainer(cfg, seed, device, traffic["steps_per_epoch"],
                           shift)
    digest = weights.names_digest(trainer.model)
    if trace:
        spans.install_model(trainer.model)
        spans.wrap_method(trainer.optimizer, "step", "opt")
    step_fn = trainer.step if fault is None else fault(trainer)
    named = [(n, p) for n, p in trainer.model.named_parameters()
             if p.requires_grad]
    start = {n: p.detach().clone() for n, p in named}

    def step(i: int):
        slot = i % len(pool)
        m = step_fn(port.batch(pool[slot], device))
        sync(device)
        return slot, m

    n_check = traffic["check_steps"]
    losses, first = [], None
    for i in range(n_check):
        _, m = step(i)
        losses.append({k: float(v) for k, v in m.items()
                       if k.startswith("loss")})
        if i == 0:
            first = ref_train.adam_first_grads(trainer.optimizer, named)
    change = {n: float((p.detach() - start[n]).float().norm())
              for n, p in named}
    del start
    done = n_check
    setup_s = process_age_s()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    times, slots = [], []
    tr = None
    if trace:
        def traced():
            for _ in range(traffic["trace_steps"]):
                with torch.profiler.record_function("occbench.step"):
                    slots.append(step(done + len(slots))[0])
        _, tr = tracing.profile(traced)
        window_s = tr.window_us / 1e6
    else:
        t_start = time.perf_counter()
        deadline = t_start + seconds
        end = t_start
        while not times or end < deadline:
            t0 = time.perf_counter()
            slots.append(step(done + len(times))[0])
            end = time.perf_counter()
            times.append(end - t0)
        window_s = end - t_start
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    del trainer, step_fn, named
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    batches = [pool[i % len(pool)] for i in range(n_check)]
    counter = (lambda m: dense.DenseFlops(m, skip=("pts_middle_encoder",))) \
        if trace else None
    r_losses, r_first, r_change, ref_digest, flops, mats = ref_train.steps(
        spec.config["port_config"], seed, batches, device,
        traffic["steps_per_epoch"], counter, empty_shift=shift)
    numbers = compare.train_numbers(losses, first, change, r_losses,
                                    r_first, r_change, mats)
    correct, checks = compare.judge(numbers, spec.limits)
    checks["state_names_differ"] = {"value": float(digest != ref_digest),
                                    "limit": 0.0}
    correct = correct and digest == ref_digest
    load = dict(occ or {}, reference=[
        {k: int(r[k]) for k in ("occupied", "refined") if k in r}
        for r in r_losses])
    detail = {"grad": compare.worst_leaves(first or {}, r_first, 12),
              "change": compare.worst_leaves(change, r_change, 12),
              "matrices": sorted(mats),
              "losses": [losses, r_losses]}

    res = SimpleNamespace(correct=correct, attempted=len(slots), failed=0,
                          checks=checks, numbers=numbers, detail=detail,
                          load=load,
                          device=device_info(device,
                                             max(setup_peak, window_peak)))
    if trace:
        work = frame_work(spec, pool, slots, device, train=True)
        res.ctx = SimpleNamespace(
            kind="train", trace=tr, units=len(slots), window_s=window_s,
            dense_flop=flops.flop if flops else None, sparse=work,
            train_forwards=peaks.TRAIN_STEP_FORWARDS)
        res.device["busy_s"] = tr.busy_us() / 1e6
        res.device["window_s"] = window_s
        res.breakdown = breakdown(tr)
    else:
        res.e2e = {"train_samples_per_s": len(times) / window_s,
                   "peak_gib": window_peak / 2 ** 30, "setup_s": setup_s}
    return res

