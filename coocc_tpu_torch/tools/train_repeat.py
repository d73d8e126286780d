"""Whether a train step repeats bit for bit on the card (ROADMAP C8), and
what the fixed orders of summation cost:

    python -m coocc_tpu_torch.tools.train_repeat [config ...]

For each config (default: the flagship and coocc_lidar), a Trainer in the
config's bf16 takes a warm-up step, then two steps from one state,
generator and batch (the synthetic batch of seed 0), and prints how many
loss terms, gradient leaves, moved statistics and updated parameters
differ between them; the same two steps with `torch.backends.cudnn.
deterministic` alone and under `torch.use_deterministic_algorithms(True,
warn_only=True)`, each with its device busy ms, the ops it warns of and
the kernels whose device time it moves most against the default step
(what it swaps in names the op that sums in another order each run);
then the two repaired sums of training, ops/gather.py's backward and
ops/subm_conv.py's tap fold, in their fixed orders against the
`index_add_` they replace: the step's busy ms (fixed, index_add_,
index_add_, fixed) and each site's ms on the step's own calls. Needs a
CUDA card. chip_smoke.py imports the helpers.
"""
from __future__ import annotations

import contextlib
import copy
import statistics
import subprocess
import sys
import warnings
from typing import Dict, List, Optional

import torch

from ..config import get_config
from ..data.synthetic import synthetic_batch
from ..entry import FLAGSHIP, Trainer
from ..ops import gather, subm_conv
from ..ops._build import load_all_kernel_libraries
from ..parallel.train_step import train_step

CONFIGS = (FLAGSHIP, "coocc_lidar")


def snapshot(trainer):
    """A Trainer's state: its model's state_dict, its optimizer's and its
    generator's, copied."""
    return ({k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()},
            copy.deepcopy(trainer.optimizer.state_dict()),
            trainer.generator.get_state())


def restore(trainer, snap):
    model_sd, opt_sd, gen = snap
    trainer.model.load_state_dict(model_sd)
    trainer.optimizer.load_state_dict(copy.deepcopy(opt_sd))
    trainer.generator.set_state(gen)


def step_result(trainer, batch, group=None) -> Dict[str, Dict]:
    """One train step (train_step, over `group` where given) -> its loss
    terms, every parameter's gradient (as the update read it) and the
    state after it, copied."""
    metrics = train_step(trainer.model, trainer.optimizer, batch,
                         trainer.generator, group)
    return {"losses": {k: v.detach().clone() for k, v in metrics.items()},
            "grads": {k: p.grad.clone()
                      for k, p in trainer.model.named_parameters()},
            "state": {k: v.detach().clone()
                      for k, v in trainer.model.state_dict().items()}}


def bits(t: torch.Tensor) -> torch.Tensor:
    """t's bits, for an exact comparison (-0.0 against 0.0, NaNs)."""
    t = t.detach()
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16, torch.float64: torch.int64}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def differing(a, b) -> Dict[str, List[str]]:
    """The names whose tensors differ in a bit between two step_result()s:
    "losses", "grads", "stats" (the moved BatchNorm statistics) and
    "params" (after the update)."""
    def neq(x, y):
        return not bool((bits(x) == bits(y)).all())
    state = [k for k in a["state"] if neq(a["state"][k], b["state"][k])]
    return {"losses": [k for k in a["losses"]
                       if neq(a["losses"][k], b["losses"][k])],
            "grads": [k for k in a["grads"]
                      if neq(a["grads"][k], b["grads"][k])],
            "stats": [k for k in state if "running" in k],
            "params": [k for k in state if "running" not in k]}


class deterministic:
    """Inside the block: torch.use_deterministic_algorithms(True,
    warn_only=True) (mode "algorithms", which also makes cuDNN pick
    deterministic algorithms) or torch.backends.cudnn.deterministic alone
    (mode "cudnn"); the warnings of ops without a deterministic
    implementation are collected in .ops on exit."""

    def __init__(self, mode: str):
        self.mode, self.ops = mode, []

    def __enter__(self):
        self.caught = warnings.catch_warnings(record=True)
        self.warned = self.caught.__enter__()
        warnings.simplefilter("always")
        if self.mode == "algorithms":
            torch.use_deterministic_algorithms(True, warn_only=True)
        else:
            torch.backends.cudnn.deterministic = True
        return self

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        self.ops = sorted({str(w.message).split(" does not have")[0]
                           .split("\n")[0][:120] for w in self.warned
                           if "deterministic" in str(w.message)})
        self.caught.__exit__(*exc)
        return False


def old_gather_backward(ctx, g):
    """ops/gather.py's backward as it was: an fp32 index_add_ (atomics)."""
    idx, = ctx.saved_tensors
    row = g.shape[idx.dim():]
    acc = g.new_zeros((ctx.rows,) + row, dtype=torch.float32)
    acc.index_add_(0, idx.reshape(-1), g.reshape((-1,) + row).float())
    return acc.to(g.dtype), None


def old_tap_fold(g, table, Ci, Co):
    """ops/subm_conv.py:gather_taps_transpose as it was: an fp32
    index_add_ of the blocks onto their taps."""
    n_in, n_out = table.shape
    blocks = g.float().reshape(3, 3, n_in, Ci, n_out, Co).permute(
        0, 1, 2, 4, 3, 5).reshape(3, 3, n_in * n_out, Ci, Co)
    idx = torch.from_numpy(table.reshape(-1)).to(g.device)
    w3 = g.new_zeros((3, 3, 4, Ci, Co), dtype=torch.float32)
    w3.index_add_(2, idx, blocks)
    return w3[:, :, :3].reshape(27, Ci, Co)


class repaired_sites:
    """Inside the block the two repaired sums run as `version` says: "new"
    (the fixed orders) or "old" (index_add_); with `record`, each call's
    inputs are appended to record["gather"] and record["taps"]."""

    def __init__(self, version: str = "new", record=None):
        self.version, self.record = version, record

    def __enter__(self):
        self.saved = (gather._GatherRows.backward,
                      subm_conv.gather_taps_transpose)
        back, fold = self.saved if self.version == "new" else (
            old_gather_backward, old_tap_fold)
        rec = self.record

        def backward(ctx, g):
            if rec is not None:
                rec["gather"].append((ctx.saved_tensors[0], g, ctx.rows))
            return back(ctx, g)

        def taps(g, table, Ci, Co):
            if rec is not None:
                rec["taps"].append((g, table, Ci, Co))
            return fold(g, table, Ci, Co)
        gather._GatherRows.backward = staticmethod(backward)
        subm_conv.gather_taps_transpose = taps
        return self

    def __exit__(self, *exc):
        gather._GatherRows.backward = staticmethod(self.saved[0])
        subm_conv.gather_taps_transpose = self.saved[1]
        return False


def gather_new(idx, g, rows):
    """ops/gather.py's backward on one call's inputs."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    row = g.shape[idx.dim():]
    return gather.sorted_segment_sum(g.reshape((-1,) + row)[order].float(),
                                     flat[order], rows).to(g.dtype)


def gather_old(idx, g, rows):
    class Ctx:
        saved_tensors = (idx,)
    Ctx.rows = rows
    return old_gather_backward(Ctx, g)


def event_ms(fn, reps: int = 5) -> float:
    """Median device ms of fn() (CUDA events behind a sleep kernel, so the
    host's launches stay out of the window)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def site_times(record) -> Dict[str, Dict]:
    """Each repaired site's device ms over one step's calls, the fixed
    order against index_add_ on the same inputs (old, new, old, new, each
    pair averaged), and the gather's calls one by one. -> {site: {"calls",
    "old_ms", "new_ms"}, "gather_calls": [(values, row shape, rows,
    old ms, new ms)]}."""
    out = {}
    for site, calls, old, new in (
            ("gather_rows backward", record["gather"], gather_old,
             gather_new),
            ("K2 dW tap fold", record["taps"], old_tap_fold,
             subm_conv.gather_taps_transpose)):
        times = {"old_ms": [], "new_ms": []}
        for key, fn in (("old_ms", old), ("new_ms", new), ("old_ms", old),
                        ("new_ms", new)):
            times[key].append(event_ms(
                lambda fn=fn: [fn(*c) for c in calls]))
        out[site] = {"calls": len(calls),
                     **{k: statistics.mean(v) for k, v in times.items()}}
    out["gather_calls"] = [
        (idx.numel(), tuple(g.shape[idx.dim():]), rows,
         event_ms(lambda: gather_old(idx, g, rows)),
         event_ms(lambda: gather_new(idx, g, rows)))
        for idx, g, rows in record["gather"]]
    return out


def kernel_ms(fn) -> Dict[str, float]:
    """torch.profiler over fn() -> {kernel name (70 chars): device ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name[:70]] = out.get(e.name[:70], 0.0) \
                + e.time_range.elapsed_us() / 1e3
    return out


def check(name: str, log=print) -> Dict:
    """The whole report for config `name` (the module note). -> its
    numbers."""
    cfg = get_config(name)
    trainer = Trainer(cfg, "cuda", 0, steps_per_epoch=3)
    batch = synthetic_batch(cfg, batch_size=1, seed=0).to("cuda")
    trainer.step(batch)                     # warm-up
    snap = snapshot(trainer)
    nums: Dict = {}
    default: Optional[Dict[str, float]] = None
    for mode in (None, "cudnn", "algorithms"):
        ctx = deterministic(mode) if mode else contextlib.nullcontext()
        with ctx:
            restore(trainer, snap)
            a = step_result(trainer, batch)
            restore(trainer, snap)
            b = step_result(trainer, batch)
            diff = differing(a, b)
            del a, b
            restore(trainer, snap)
            kernels = kernel_ms(lambda: trainer.step(batch))
        counts = {k: len(v) for k, v in diff.items()}
        busy = sum(kernels.values())
        label = mode or "default"
        log(f"{name}, {label}: two steps from one state differ in {counts} "
            f"(of {len(list(trainer.model.parameters()))} gradient "
            f"leaves); busy {busy:.3f} ms"
            + (f"; ops without a deterministic implementation: {ctx.ops}"
               if mode else ""))
        if diff["grads"]:
            log(f"  differing gradients, the first: {diff['grads'][:4]}")
        if default is None:
            default = kernels
        else:
            moved = sorted(set(default) | set(kernels), key=lambda k: -abs(
                kernels.get(k, 0.0) - default.get(k, 0.0)))[:6]
            log(f"  the kernels whose device time moved most against the "
                f"default step (ms):")
            for k in moved:
                log(f"    {default.get(k, 0.0):9.3f} -> "
                    f"{kernels.get(k, 0.0):9.3f}  {k}")
        nums[label] = {"differing": counts, "busy_ms": busy}
    record = {"gather": [], "taps": []}
    restore(trainer, snap)
    with repaired_sites("new", record):
        trainer.step(batch)
    sites = site_times(record)
    del record
    for site in ("gather_rows backward", "K2 dW tap fold"):
        t = sites[site]
        log(f"{name}: {site}: {t['calls']} calls a step, index_add_ "
            f"{t['old_ms']:.4f} ms, fixed order {t['new_ms']:.4f} ms")
    for n, row, rows, old, new in sites["gather_calls"]:
        log(f"  gather_rows backward, {n} values of {row} onto {rows} "
            f"rows: index_add_ {old:.4f} ms, fixed order {new:.4f} ms")
    busy = {"new": [], "old": []}
    for version in ("new", "old", "old", "new"):
        restore(trainer, snap)
        with repaired_sites(version):
            busy[version].append(sum(kernel_ms(
                lambda: trainer.step(batch)).values()))
    nums["sites"] = sites
    nums["site_busy_ms"] = {k: statistics.mean(v) for k, v in busy.items()}
    log(f"{name}: step busy {nums['site_busy_ms']['new']:.3f} ms with the "
        f"fixed orders, {nums['site_busy_ms']['old']:.3f} ms with "
        f"index_add_")
    return nums


def main(argv=None):
    configs = (argv if argv is not None else sys.argv[1:]) or CONFIGS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_all_kernel_libraries()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    for name in configs:
        check(name, lambda *a: print(*a, flush=True))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
