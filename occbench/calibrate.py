"""The readings the limits of `correct` are set from (not run by the
benchmark's runs):

    python3 -m occbench.calibrate --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--seconds 2] [--dtype float32]

For each seed of `--seeds`, one run of the cell's own loop with a short
window, printing the numbers it compares (the program's readings, from
which the lower end is taken) and, for a train cell, its worst leaves.
With `--dtype float32` the program runs in fp32 instead of the
configuration's bf16, TF32 off: a witness of where its gaps come from,
not a reading any limit is set from. For each seed of `--control-seeds`,
the control in the program's place on the same frames: the reference in
fp8 (reference/control.py) against the fp32 reference, printing the same
numbers (the upper end) and whether the cell's limits judge it correct.
Each line is one JSON object.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import numpy as np
import torch

from occbench import frames, port
from occbench import run as runner
from occbench.reference import compare, control, occupancy
from occbench.reference import serve as ref
from occbench.reference import train as ref_train


def control_numbers(spec, seed: int, device) -> dict:
    """The control's numbers on the frames a run of `seed` checks."""
    cfg = port.config(spec.config)
    traffic = spec.traffic
    rng = np.random.default_rng([seed, 11])
    check = [int(s) for s in rng.choice(traffic["pool_frames"],
                                        traffic["check_frames"],
                                        replace=False)]
    fs = [frames.make_frame(cfg, traffic, seed, s, device,
                            frames.EVAL_FIELDS) for s in check]
    ref.fp32_strict()
    name = spec.config["port_config"]
    first = frames.make_frame(cfg, traffic, seed, 0, device,
                              frames.EVAL_FIELDS)
    occ = occupancy.shift(name, seed, first, device, train=False)
    model = ref.build(name, seed, device, occ["shift"] if occ else 0.0)
    ref_outs = [ref.forward(model, f, device) for f in fs]
    control.make_fp8(model)
    ctl_outs = [ref.forward(model, f, device) for f in fs]
    del model
    gc.collect()
    h = cfg.occ_head
    return compare.stream_numbers(
        ctl_outs, ref_outs, (h.max_coarse_occupied, h.cascade_ratio,
                             h.empty_idx))


def control_train_numbers(spec, seed: int, device) -> dict:
    """The control's numbers on a train cell: the reference's first steps
    with fp8 weights and layer inputs against the fp32 reference's, on the
    frames a run of `seed` trains on."""
    cfg = port.config(spec.config)
    traffic = spec.traffic
    fs = [frames.make_frame(cfg, traffic, seed, i, device)
          for i in range(traffic["check_steps"])]
    name = spec.config["port_config"]
    ref.fp32_strict()
    occ = occupancy.shift(name, seed, fs[0], device, train=True)
    shift = occ["shift"] if occ else 0.0
    r = ref_train.steps(name, seed, fs, device, traffic["steps_per_epoch"],
                        empty_shift=shift)
    gc.collect()
    torch.cuda.empty_cache()
    c = ref_train.steps(name, seed, fs, device, traffic["steps_per_epoch"],
                        prepare=control.make_fp8, empty_shift=shift)
    return compare.train_numbers(c[0], c[1], c[2], r[0], r[1], r[2], r[5])


def tf32_witness(spec, seed: int, device) -> dict:
    """A train cell's numbers for the reference with TF32 on (products of
    10-bit mantissas, like bf16's 8) in the program's place, against the
    reference with it off, with every leaf's gap: how far rounding alone,
    in code that shares nothing with the program, moves each number."""
    cfg = port.config(spec.config)
    traffic = spec.traffic
    fs = [frames.make_frame(cfg, traffic, seed, i, device)
          for i in range(traffic["check_steps"])]
    name = spec.config["port_config"]
    ref.fp32_strict()
    occ = occupancy.shift(name, seed, fs[0], device, train=True)
    shift = occ["shift"] if occ else 0.0
    r = ref_train.steps(name, seed, fs, device, traffic["steps_per_epoch"],
                        empty_shift=shift)
    gc.collect()
    torch.cuda.empty_cache()
    strict = ref_train.fp32_strict

    def tf32():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    ref_train.fp32_strict = tf32      # steps() sets the flags it reads
    try:
        t = ref_train.steps(name, seed, fs, device,
                            traffic["steps_per_epoch"], empty_shift=shift)
    finally:
        ref_train.fp32_strict = strict
        ref.fp32_strict()
    return {"numbers": compare.train_numbers(t[0], t[1], t[2], r[0], r[1],
                                             r[2], r[5]),
            "grad": compare.worst_leaves(t[1], r[1], k=len(r[1])),
            "change": compare.worst_leaves(t[2], r[2], k=len(r[2])),
            "matrices": sorted(r[5])}


def _flat(out) -> torch.Tensor:
    """A prefix's outputs as one fp32 vector on the host."""
    ts = []
    for v in out.values():
        for t in (v if isinstance(v, list) else [v]):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                ts.append(t.detach().float().reshape(-1).cpu())
    return torch.cat(ts)


def stage_drift(spec, seed: int, device) -> dict:
    """Each stage prefix's gap (2-norm of the difference over the
    reference's) on the first checked frame: the program against the fp32
    reference, and the fp8 control against it: where the program's
    rounding enters."""
    cfg = port.config(spec.config)
    frame = frames.make_frame(cfg, spec.traffic, seed, 0, device,
                              frames.EVAL_FIELDS)
    occ = occupancy.shift(spec.config["port_config"], seed, frame, device,
                          train=False)
    shift = occ["shift"] if occ else 0.0
    model = port.served_model(cfg, seed, device, shift)
    stages = ("img", "pts", "fuse", "sem", "coarse")
    prog = {}
    with torch.no_grad():
        for st in stages:
            try:
                prog[st] = _flat(model(port.batch(frame, device),
                                       stop_at=st))
            except (ValueError, RuntimeError):
                pass
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ref.fp32_strict()
    rmodel = ref.build(spec.config["port_config"], seed, device, shift)
    from occbench.reference.occref.models.coocc_ray import Batch
    rb = Batch(**{k: v.to(device) for k, v in frame.items()})
    out = {}
    with torch.no_grad():
        refs = {st: _flat(rmodel(rb, stop_at=st)) for st in prog}
        control.make_fp8(rmodel)
        for st in prog:
            c = _flat(rmodel(rb, stop_at=st))
            r = refs[st]
            den = float(r.norm()) or 1e-30
            out[st] = {"program": float((prog[st] - r).norm()) / den,
                       "control": float((c - r).norm()) / den}
    return out


def in_dtype(dtype: str):
    """The program's config in `dtype` from now on, TF32 off (the loops
    take the config through port.config)."""
    import dataclasses
    base = port.config

    def config(config_file):
        cfg = base(config_file)
        return dataclasses.replace(cfg, compute_dtype=dtype)

    port.config = config
    ref.fp32_strict()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m occbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--stages", type=int, nargs="*", default=[])
    ap.add_argument("--tf32-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default=None, help="run the program in this dtype")
    args = ap.parse_args(argv)
    runner.set_cache_dirs()
    bench = runner.load_json(runner.ROOT, "BENCHMARK.json")
    spec = runner.cell_spec(bench, args.workload)
    if args.dtype is not None and args.dtype != spec.config["dtype"]:
        in_dtype(args.dtype)
    runner.card_check(spec.chips)
    loop = runner.load_module(
        os.path.join(spec.pkg, "loops", f"{spec.traffic['loop']}.py"),
        "occbench_calibrate_loop")
    for seed in args.seeds:
        res = loop.run(spec, seed, args.seconds, False, "cuda")
        print(json.dumps({"side": "program", "seed": seed,
                          "dtype": args.dtype or spec.config["dtype"],
                          "correct": res.correct, "numbers": res.numbers,
                          "load": res.load,
                          "detail": getattr(res, "detail", None)}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        nums = (control_train_numbers if spec.traffic["loop"] == "train"
                else control_numbers)(spec, seed, "cuda")
        correct, _ = compare.judge(nums, spec.limits)
        print(json.dumps({"side": "control", "seed": seed,
                          "correct": correct, "numbers": nums}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.tf32_seeds:
        print(json.dumps({"side": "tf32_reference", "seed": seed,
                          **tf32_witness(spec, seed, "cuda")}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.stages:
        print(json.dumps({"side": "stages", "seed": seed,
                          "drift": stage_drift(spec, seed, "cuda")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
