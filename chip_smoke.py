"""Smoke run of the PyTorch/CUDA port (coocc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. build: nvcc compiles every coocc_tpu_torch/csrc/*.cu for sm_90a;
  2. main path: the flagship eval forward (coocc_multi_r50_256x704, fp32,
     B=1, seeded random weights) through coocc_tpu_torch.entry.entry(),
     warmed up once, then 3 requests (synthetic batches of seeds 0, 1, 2)
     with the kernels' launch counts read around them; per-request and
     per-stage (stop_at prefixes) times and peak memory;
  3. kernels against their plain PyTorch versions on the card, at the main
     path's shapes (and a ragged one), exact for the integer window-KNN;
  4. the tiny config on the card against the same model on the CPU (the
     route the tests hold against the JAX package), atol=rtol=5e-3.
Prints the card, the kernels' JSON line and, last, the result line. Needs a
CUDA card and the repository around it; it imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TOL = dict(atol=5e-3, rtol=5e-3)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sync():
    import torch
    torch.cuda.synchronize()


def timed_ms(fn, reps: int, setup=None):
    """Median device ms of fn() over `reps` runs (CUDA events). A sleep
    kernel queued first keeps the host's launch latency out of the window;
    `setup(i)` (untimed) gives each run its own inputs."""
    import torch
    times = []
    for i in range(reps):
        args = setup(i) if setup else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_outputs(out, cfg):
    import torch
    X, Y, Z = cfg.lss_grid_size
    rows = cfg.occ_head.max_coarse_occupied * cfg.occ_head.cascade_ratio ** 3
    want = {"occ": (1, X, Y, Z, cfg.num_classes),
            "fine_logits": (1, rows, cfg.num_classes),
            "fine_coords": (1, rows, 3), "fine_valid": (1, rows)}
    for k, shape in want.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(
                f"{k}: shape {tuple(out[k].shape)} != {shape}")
    for k in ("occ", "fine_logits"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{k} has non-finite values")
    if int(out["fine_valid"].sum()) == 0:
        raise AssertionError("the cascade refined no cell")


def phase_main_path(kernels):
    import torch
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import entry
    from coocc_tpu_torch.models.coocc_ray import STAGES

    model, (batch,) = entry("cuda")
    cfg = model.cfg
    model(batch)  # warm-up: cuDNN algorithm selection, allocator
    sync()
    requests = [synthetic_batch(cfg, batch_size=1, seed=s).to("cuda")
                for s in range(3)]
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    req_ms = []
    for i, b in enumerate(requests):
        before = {n: k.launches for n, k in kernels.items()}
        sync()
        t0 = time.perf_counter()
        out = model(b)
        sync()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        check_outputs(out, cfg)
        grew = {n: k.launches - before[n] for n, k in kernels.items()}
        if grew["window_knn"] != 2:
            raise AssertionError(f"request {i}: window_knn launched "
                                 f"{grew['window_knn']} times, not 2")
        log(f"request {i} (seed {i}): {req_ms[-1]:.3f} ms, "
            f"fine_valid {int(out['fine_valid'].sum())}, "
            f"fine_overflow {int(out['fine_overflow'].sum())}")
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"main path launches: {launches}")
    log(f"request ms: {[round(t, 3) for t in req_ms]} "
        f"(median {statistics.median(req_ms):.3f})")
    log(f"peak memory allocated: {peak / 2**30:.3f} GiB")

    prefix = {}
    for stop in STAGES + (None,):
        ts = []
        for b in requests:
            sync()
            t0 = time.perf_counter()
            model(b, stop_at=stop)
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        prefix[stop or "full"] = statistics.median(ts)
    prev = 0.0
    for name, t in prefix.items():
        log(f"stage {name:6s}: prefix {t:9.3f} ms, marginal {t - prev:9.3f}"
            " ms")
        prev = t
    pts = model(requests[0], stop_at="pts")
    masks = {"img": pts["img_voxel"][0].abs().sum(-1) != 0,
             "pts": pts["pts_voxel"][0].abs().sum(-1) != 0}
    return model, launches, masks


def phase_window_knn(model, masks, launches):
    """Kernel against plain version on the card; -> the kernel's JSON row."""
    import torch
    from coocc_tpu_torch.ops.window_knn import (best2_ranks_plain,
                                                make_offsets, window_knn,
                                                window_knn_plain)
    fuser = model.occ_fuser
    windows = {"img": fuser.offsets_img, "pts": fuser.offsets}
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0
    shape = tuple(masks["img"].shape)
    cases = []
    for key, offs in windows.items():
        for d in (0.0, 0.02, 0.3, 1.0):
            m = torch.rand(shape, generator=gen, device="cuda") < d
            cases.append((f"{key} window, density {d}", m, offs))
        cases.append((f"{key} window, real {key}_active", masks[key], offs))
        cases.append((f"{key} window, real other mask",
                      masks["pts" if key == "img" else "img"], offs))
    ragged = torch.rand((37, 23, 5), generator=gen, device="cuda") < 0.3
    cases.append(("ragged (37,23,5), (6,6,7)", ragged,
                  make_offsets(6, 6, 7, 13.3)))
    for name, m, offs in cases:
        got = window_knn(m, offs)
        ref = window_knn_plain(m, offs)
        sync()
        err = int((got.long() - ref.long()).abs().max())
        max_err = max(max_err, err)
        log(f"window_knn vs plain [{name}]: O={len(offs)} max_abs_err={err}"
            f" active={int(m.sum())}")
        if err != 0:
            raise AssertionError(f"window_knn differs from plain: {name}")

    # timing at the main path's inputs: both calls of one forward, each
    # repeat on its own masks (the real ones with 0.1% of cells flipped)
    reps = 20
    variants = []
    for i in range(reps):
        pair = {}
        for key in ("img", "pts"):
            flip = torch.rand(shape, generator=gen, device="cuda") < 1e-3
            pair[key] = masks[key] ^ flip
        variants.append(pair)

    def both(fn):
        return lambda pair: [fn(pair[k], windows[k]) for k in ("img", "pts")]

    ms = {}
    for key in ("img", "pts"):
        ms[key] = timed_ms(lambda m, k=key: window_knn(m, windows[k]), reps,
                           lambda i, k=key: (variants[i][k],))
    kernel_ms = timed_ms(both(window_knn), reps, lambda i: (variants[i],))
    plain_ms = timed_ms(both(window_knn_plain), 5, lambda i: (variants[i],))
    log(f"window_knn kernel ms: img window {ms['img']:.4f}, pts window "
        f"{ms['pts']:.4f}, both {kernel_ms:.4f}; plain both {plain_ms:.3f}")

    # bound: bytes read once + written once; operations = the probes these
    # masks need (a cell stops at its second hit, else walks all O offsets)
    nbytes = probes = 0
    for key in ("img", "pts"):
        m, offs = masks[key], windows[key]
        n, O = m.numel(), len(offs)
        nbytes += n + offs.nbytes + 8 * n
        _, b2 = best2_ranks_plain(m, offs)
        probes += int(torch.where(b2 < O, b2 + 1, O).sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = probes / FP32_OPS_PER_S * 1e3
    log(f"window_knn bound: {nbytes} bytes -> {bytes_ms:.6f} ms; {probes} "
        f"probes -> {ops_ms:.6f} ms")
    return {"name": "window_knn", "route": "cuda",
            "source": "coocc_tpu_torch/csrc/window_knn.cu",
            "replaces": "coocc_tpu/ops/pallas/window_knn.py:37",
            "launches": launches["window_knn"], "max_abs_err": max_err,
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def phase_tiny_agreement():
    import numpy as np
    from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
    from coocc_tpu_torch.entry import build_model
    cfg = tiny_config()
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev, seed=7)
        out = model(synthetic_batch(cfg, batch_size=1, seed=3).to(dev))
        outs[dev] = {k: v.cpu().numpy() for k, v in out.items()}
    a, b = outs["cpu"], outs["cuda"]
    np.testing.assert_allclose(b["occ"], a["occ"], **TOL)

    def by_coord(o):
        return {tuple(c): l for c, l, v in zip(
            o["fine_coords"][0], o["fine_logits"][0], o["fine_valid"][0])
            if v}
    fa, fb = by_coord(a), by_coord(b)
    if set(fa) != set(fb):
        raise AssertionError("tiny: refined cells differ between cpu and cuda")
    for c in fa:
        np.testing.assert_allclose(fb[c], fa[c], **TOL)
    log(f"tiny config cuda vs cpu: occ and {len(fa)} fine rows agree "
        f"(atol=rtol=5e-3)")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from coocc_tpu_torch.ops._build import kernel_names, load_kernel_library
    from coocc_tpu_torch.ops.window_knn import window_knn

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False (fp32 throughout)")

    for name in kernel_names():
        t0 = time.perf_counter()
        load_kernel_library(name)
        log(f"build csrc/{name}.cu: {time.perf_counter() - t0:.2f} s "
            "(nvcc, sm_90a)")

    kernels = {"window_knn": window_knn}
    model, launches, masks = phase_main_path(kernels)
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    rows = [phase_window_knn(model, masks, launches)]
    del model
    phase_tiny_agreement()

    log(f"card: {card_line()}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
