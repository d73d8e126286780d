"""K2's backward kernels (csrc/subm_conv_bwd.cuh) on one NVIDIA card at the
train steps' level shapes; run it from the repository's root:

    python -m coocc_tpu_torch.tools.k2_backward [--quick] [--tps N,N,...]
        [--train CONFIG]

Compiles the three backward sources with `nvcc -Xptxas -v` and prints
ptxas's register and spill lines and any "serialized" wgmma warning. Then,
at every level shape of the flagship's, OpenOccupancy's and coocc_lidar's
train steps (random bf16 activations and cotangents on 30% of the cells,
`chip_smoke.py:k2_inputs`), holds each kernel against its plain version
(dX under `k2_dx_check`, dW under `k2_dw_check`, bit for bit on integer
inputs under `k2_dw_exact`, two dW calls bit-equal) and times (CUDA events
behind a sleep kernel, median of 3): dX, the route it replaced (K2 with
the mirrored taps and an all-ones mask), cuDNN bf16 on the concatenated
input; dW, its plain version (PyTorch ops), `torch.nn.grad.conv2d_weight`
on the concatenated input under the train step's deterministic cuDNN
flags and under the defaults (the concat not counted). Sums each per step
by the level's calls, with the bound (`chip_smoke.py:k2_bwd_work`). fp32
is checked at the flagship's levels. `--quick` checks one small ragged
shape per packing and times nothing. `--tps 32,48,64` also times dW at
every level with each of those tiles a split (`tiles_per_split` of
`subm_ext_weight_grad`, the shape-only rule of `dw_splits`), each held bit-equal to itself.
`--train CONFIG` times dW on each call of one of that config's bf16 train
steps (`chip_smoke.py:train_k2_calls`) as `chip_smoke.py` times it, then
behind a sleep kernel ten times as long, on copies of the call's inputs
and on random inputs of its shape, beside the wrapper's host ms.
"""
from __future__ import annotations

import os
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops import subm_conv as k2

# (x shape, p, calls a step) of each trained config's K2 levels
LEVELS = {
    "coocc_multi_r50_256x704": [((1, 8, 400, 400, 128), 4, 4),
                                ((1, 8, 200, 200, 128), 2, 4),
                                ((1, 8, 100, 100, 128), 1, 5)],
    "coocc_multi_r101_openoccupancy": [((1, 10, 512, 512, 128), 4, 4),
                                       ((1, 10, 256, 256, 128), 2, 4),
                                       ((1, 10, 128, 128, 128), 1, 5)],
    "coocc_lidar": [((1, 9, 800, 800, 128), 8, 4),
                    ((1, 9, 400, 400, 128), 4, 4),
                    ((1, 9, 200, 200, 128), 2, 4),
                    ((1, 9, 100, 100, 128), 1, 4)],
}
QUICK = [((2, 3, 37, 29, 128), p) for p in (8, 4, 2, 1)]
SOURCES = ("subm_conv_dx", "subm_conv_dx_f32", "subm_weight_grad")


def ptxas_report():
    for name in SOURCES:
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.devnull, os.path.join(_build.CSRC, f"{name}.cu")],
            capture_output=True, text=True)
        print(f"nvcc {name}.cu: rc {proc.returncode}", flush=True)
        for ln in (proc.stdout + proc.stderr).splitlines():
            if any(w in ln for w in ("Compiling entry", "serialized",
                                     "registers", "error", "spill")):
                print(f"  {ln}")
        if proc.returncode:
            raise SystemExit(proc.stdout + proc.stderr)


def inputs(cs, gen, shape, p, dtype):
    """x (the forward's input) and the masked cotangent dy, zero outside
    30% of the cells, and w27."""
    [(x, mcell, _)], w27, _ = cs.k2_inputs(gen, shape, p, 128 // p, dtype,
                                           1)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return x, k2.masked(dy, mcell).contiguous(), w27


def check(cs, gen, shape, p, dtype):
    """Both kernels against their plain versions on one input; -> (x, dy,
    w27) for timing."""
    x, dy, w27 = inputs(cs, gen, shape, p, dtype)
    err, ok = cs.k2_dx_check(dy, w27, p)
    print(f"dX {shape} p={p} {str(dtype)[6:]}: max_abs_err {err:.6g}, "
          f"scale {float(dy.abs().max()):.6g}, {'ok' if ok else 'FAIL'}",
          flush=True)
    derr, dscale, ratio, dok = cs.k2_dw_check(x, dy, p)
    exact = cs.k2_dw_exact(gen, shape, p, dtype)
    again = torch.equal(k2.subm_ext_weight_grad(x, dy, p),
                        k2.subm_ext_weight_grad(x, dy, p))
    print(f"dW {shape} p={p} {str(dtype)[6:]}: max_abs_err {derr:.6g}, "
          f"scale {dscale:.6g}, max err/tol {ratio:.4g}, "
          f"{'ok' if dok else 'FAIL'}; integer inputs "
          f"{'exact' if exact else 'DIFFER'}; repeat "
          f"{'bit-equal' if again else 'DIFFERS'}", flush=True)
    if not (ok and dok and exact and again):
        raise AssertionError(f"a backward kernel differs at {shape} p={p} "
                             f"{dtype}")
    return x, dy, w27


def times(cs, x, dy, w27, p):
    """ms of one call each: dX, the old dX route, cuDNN's dgrad-shaped
    conv; dW, its plain version, conv2d_weight deterministic and default;
    and the plain dX."""
    from coocc_tpu_torch.parallel.train_step import cudnn_deterministic
    shape = tuple(x.shape)
    C = shape[-1] // p
    G, X, Y = shape[0] * shape[1], shape[2], shape[3]
    ones = torch.ones(shape[:-1] + (p,), dtype=torch.bool, device="cuda")
    wf = k2.flip_taps(w27)
    ms = {"dx": cs.timed_ms(lambda: k2.subm_ext_conv_dx(dy, w27, p), 3),
          "dx_old": cs.timed_ms(lambda: k2.subm_ext_conv(dy, wf, p, ones),
                                3),
          "dx_plain": cs.timed_ms(
              lambda: k2.subm_ext_conv_dx_plain(dy, w27, p), 1)}
    ext = k2.shift_ext(dy, C).reshape(G, X, Y, -1).permute(0, 3, 1, 2)
    wb = k2.subm_ext_weight(wf, p).to(dy.dtype).permute(
        3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    F.conv2d(ext, wb, padding=1)
    ms["dx_cudnn"] = cs.timed_ms(lambda: F.conv2d(ext, wb, padding=1), 3)
    del ext, wb
    ms["dw"] = cs.timed_ms(lambda: k2.subm_ext_weight_grad(x, dy, p), 3)
    ms["dw_plain"] = cs.timed_ms(
        lambda: k2.subm_ext_weight_grad_plain(x, dy, p), 3)
    xe = k2.shift_ext(x, C).reshape(G, X, Y, -1).permute(0, 3, 1, 2)
    dyc = dy.reshape(G, X, Y, -1).permute(0, 3, 1, 2)
    wshape = (dyc.shape[1], xe.shape[1], 3, 3)

    def wgrad():
        torch.nn.grad.conv2d_weight(xe, wshape, dyc, padding=1)
    wgrad()
    ms["dw_cudnn"] = cs.timed_ms(wgrad, 3)
    with cudnn_deterministic():
        wgrad()
        ms["dw_cudnn_det"] = cs.timed_ms(wgrad, 3)
    del xe, dyc, ones
    return ms


def tune_splits(cs, gen, tps):
    """ms of one dW call at every level for each tiles-a-split value."""
    seen = set()
    for name, levels in LEVELS.items():
        for shape, p, _ in levels:
            if (shape, p) in seen:
                continue
            seen.add((shape, p))
            x, dy, _ = inputs(cs, gen, shape, p, torch.bfloat16)
            out = []
            for n in tps:
                def run():
                    return k2.subm_ext_weight_grad(x, dy, p, n)
                again = torch.equal(run(), run())
                ms = cs.timed_ms(run, 3)
                S = k2.dw_splits(k2.dw_tiles(shape[0] * shape[1], shape[2],
                                             shape[3]), n)
                out.append(f"{n}: {ms:.4f} (S {S}"
                           f"{'' if again else ', DIFFERS'})")
            print(f"dW {shape} p={p} ms by tiles a split: "
                  + ", ".join(out), flush=True)
            del x, dy
            torch.cuda.empty_cache()


def train_probe(cs, name):
    """dW's ms on every call of one bf16 train step of config `name`."""
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import train_steps
    cfg = get_config(name)
    trainer, _ = train_steps(cfg, 1, "cuda")
    batch = synthetic_batch(cfg, batch_size=1, seed=1).to("cuda")
    calls = cs.train_k2_calls(trainer, batch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def long_ms(fn):
        ts = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        return sorted(ts)[1]
    for i, j in calls["dw"]:
        x, _, p = calls["fwd"][i][:3]
        x, dy = x.cuda(), calls["dx"][j][0].cuda()
        shape = tuple(x.shape)
        blocks = len(k2._dw_table(p, x.shape[-1] // p, 128 // p)) * \
            k2.dw_splits(k2.dw_tiles(shape[0] * shape[1], *shape[2:4]))

        def on(a, b):
            return lambda: k2.subm_ext_weight_grad(a, b, p)
        run = on(x, dy)
        run()
        ms = {"as_chip_smoke": cs.timed_ms(run, 3), "long_sleep":
              long_ms(run), "host": cs.host_ms(lambda _: run(), range(3))}
        cs.k2_dw_check(x, dy, p)
        ms["after_check"] = cs.timed_ms(run, 3)
        xc, dyc = x.clone(), dy.clone()
        ms["copies"] = cs.timed_ms(on(xc, dyc), 3)
        xr, dyr, _ = inputs(cs, gen, shape, p, x.dtype)
        ms["random"] = cs.timed_ms(on(xr, dyr), 3)
        print(f"{name} train dW {shape} p={p} {str(x.dtype)[6:]}/"
              f"{str(dy.dtype)[6:]} strides {x.stride()}/{dy.stride()} "
              f"{blocks} blocks on {sms} SMs, ms: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
        del x, dy, xc, dyc, xr, dyr
        torch.cuda.empty_cache()


def main():
    import chip_smoke as cs   # the repository's root, as `python -m` runs
    if not torch.cuda.is_available():
        raise SystemExit("k2_backward needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    ptxas_report()
    _build.load_all_kernel_libraries()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape, p in QUICK:
        for dtype in (torch.bfloat16, torch.float32):
            check(cs, gen, shape, p, dtype)
    torch.cuda.empty_cache()
    if "--quick" in sys.argv:
        return
    if "--train" in sys.argv:
        train_probe(cs, sys.argv[sys.argv.index("--train") + 1])
        return
    if "--tps" in sys.argv:
        arg = sys.argv[sys.argv.index("--tps") + 1]
        tune_splits(cs, gen, [int(v) for v in arg.split(",")])
    for shape, p, _ in LEVELS["coocc_multi_r50_256x704"]:
        check(cs, gen, shape, p, torch.float32)
        torch.cuda.empty_cache()
    done = {}
    for name, levels in LEVELS.items():
        tot = dict.fromkeys(("dx", "dx_old", "dx_plain", "dx_cudnn", "dw",
                             "dw_plain", "dw_cudnn", "dw_cudnn_det"), 0.0)
        work = {"dx": [0, 0], "dw": [0, 0]}
        for shape, p, n in levels:
            if (shape, p) not in done:
                x, dy, w27 = check(cs, gen, shape, p, torch.bfloat16)
                done[shape, p] = times(cs, x, dy, w27, p)
                print(f"{shape} p={p} ms a call: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in done[shape, p].items()),
                    flush=True)
                del x, dy, w27
                torch.cuda.empty_cache()
            for k, v in done[shape, p].items():
                tot[k] += n * v
            for kind in work:
                o, b = cs.k2_bwd_work(shape, p, 128 // p, 2, kind)
                work[kind][0] += n * o
                work[kind][1] += n * b
        bounds = {k: max(o / cs.BF16_OPS_PER_S, b / cs.HBM_BYTES_PER_S) * 1e3
                  for k, (o, b) in work.items()}
        print(f"{name} per step (bf16): " + ", ".join(
            f"{k} {v:.4f}" for k, v in tot.items()) + f"; bound dx "
            f"{bounds['dx']:.4f}, dw {bounds['dw']:.4f} ms", flush=True)
    print(f"card: {cs.card_line()}")


if __name__ == "__main__":
    main()
