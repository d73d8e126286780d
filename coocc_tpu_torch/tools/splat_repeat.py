"""Whether the served flagship repeats bit for bit on the card, and what
the lift-splat's order of summation costs:

    python -m coocc_tpu_torch.tools.splat_repeat

`ops/lift_splat.py` sums each voxel's points as a sorted segment-sum; the
alternatives are one scatter-add of every frustum point, with `index_add_`
(atomics) or `index_put_(accumulate=True)` (sorted, one warp per voxel).
On the flagship's own splat inputs (the served bf16 model, request seed
0) this prints, for each of the three, the ms of the splat forward and of
its forward and backward (medians of CUDA-event windows) and whether 4
runs give equal grids. Then the served forward 4 times with the sorted
segment-sum and 4 times with `index_add_` in its place: per output, the
elements that differ from the first of the 4 runs. Last, train steps that
alternate the two (host ms, synced around each step, medians). Needs a
CUDA card.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch

from .. import parity
from ..config import get_config
from ..data.synthetic import synthetic_batch
from ..entry import FLAGSHIP, Trainer, served_model
from ..geometry.frustum import voxel_indices
from ..nn import lss
from ..ops._build import load_all_kernel_libraries
from ..ops.gather import gather_rows
from ..ops.lift_splat import lift_splat
from ..ops.voxelize import linearize

REPEATS = 4


def scatter_splat(how: str):
    """lift_splat as one scatter-add of every frustum point into the grid
    and a sink row for the points outside it, by `index_add_` or by
    `index_put_(accumulate=True)`."""
    def splat(depth_prob, img_feat, geom, dx, bx, nx):
        B, N, D, fH, fW = depth_prob.shape
        C = img_feat.shape[-1]
        nx = [int(v) for v in nx]
        n_vox = nx[0] * nx[1] * nx[2]
        idx, valid = voxel_indices(geom, dx, bx, nx)
        vox = torch.where(valid, linearize(idx, nx), n_vox).reshape(B, -1)
        pix = torch.arange(N * fH * fW, device=geom.device)
        pix = pix.reshape(N, 1, fH, fW).expand(N, D, fH, fW).reshape(-1)
        outs = []
        for b in range(B):
            contrib = gather_rows(img_feat[b].reshape(-1, C), pix).to(
                depth_prob.dtype) * depth_prob[b].reshape(-1, 1)
            out = contrib.new_zeros(n_vox + 1, C)
            if how == "index_add_":
                out.index_add_(0, vox[b].long(), contrib)
            else:
                out.index_put_((vox[b].long(),), contrib, accumulate=True)
            outs.append(out[:n_vox].reshape(nx[0], nx[1], nx[2], C))
        return torch.stack(outs)
    return splat


SPLATS = {"sorted segment-sum": lift_splat,
          "index_add_": scatter_splat("index_add_"),
          "index_put_(accumulate=True)": scatter_splat("index_put_")}


def event_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def splat_inputs(model, batch):
    """The arguments the model's forward hands lift_splat."""
    seen = []

    def spy(*args):
        seen.append(args)
        return lift_splat(*args)
    lss.lift_splat = spy
    try:
        with torch.no_grad():
            model(batch)
    finally:
        lss.lift_splat = lift_splat
    return seen[0]


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_all_kernel_libraries()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    cfg = get_config(FLAGSHIP)
    model = served_model(cfg, "cuda")
    batch = synthetic_batch(cfg, batch_size=1, seed=0).to("cuda")
    args = splat_inputs(model, batch)
    dp, feat = args[0], args[1]
    print(f"splat inputs: depth_prob {tuple(dp.shape)} {dp.dtype}, "
          f"features {tuple(feat.shape)} {feat.dtype}, grid "
          f"{[int(v) for v in args[5]]}")
    dp_g, feat_g = (t.detach().clone().requires_grad_(True)
                    for t in (dp, feat))
    cot = torch.randn_like(lift_splat(*args))
    for name, fn in SPLATS.items():
        grids = [fn(*args) for _ in range(REPEATS)]
        same = all(torch.equal(grids[0], g) for g in grids[1:])
        fwd = event_ms(lambda: fn(*args), 20)

        def step():
            out = fn(dp_g, feat_g, *args[2:])
            torch.autograd.grad((out * cot).sum(), (dp_g, feat_g))
        both = event_ms(step, 10)
        print(f"splat {name}: forward {fwd:.4f} ms, forward+backward "
              f"{both:.4f} ms; {REPEATS} runs equal: {same}")

    for name in ("sorted segment-sum", "index_add_"):
        lss.lift_splat = SPLATS[name]
        try:
            first = parity.capture(model, batch)
            diff = {k: [] for k in first}
            for _ in range(REPEATS - 1):
                out = parity.capture(model, batch)
                for k in first:
                    diff[k].append(int((out[k] != first[k]).sum()))
        finally:
            lss.lift_splat = lift_splat
        print(f"served forward with the {name} splat, elements differing "
              f"from the first of {REPEATS} runs:")
        for k, v in diff.items():
            print(f"  {k} ({first[k].size}): {v}")
    del model
    torch.cuda.empty_cache()

    trainer = Trainer(cfg, "cuda", seed=0, steps_per_epoch=100)
    batches = [synthetic_batch(cfg, batch_size=1, seed=s).to("cuda")
               for s in range(3)]
    ms = {"sorted segment-sum": [], "index_add_": []}
    for warm in (True, False, False, False):
        for name in ms:
            lss.lift_splat = SPLATS[name]
            try:
                for b in batches[:1] if warm else batches:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.step(b)
                    torch.cuda.synchronize()
                    if not warm:
                        ms[name].append((time.perf_counter() - t0) * 1e3)
            finally:
                lss.lift_splat = lift_splat
    for name, v in ms.items():
        print(f"train step with the {name} splat: median "
              f"{statistics.median(v):.3f} ms of {len(v)} "
              f"({min(v):.3f}-{max(v):.3f})")


if __name__ == "__main__":
    main()
