"""Smoke run of the PyTorch/CUDA port (coocc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. build: nvcc compiles every coocc_tpu_torch/csrc/*.cu for sm_90a, one
     process per source, all at once;
  2. main path, bf16: the flagship as it is served (coocc_multi_r50_256x704
     in its config's bf16 compute, entry.served_model, B=1, seeded random
     weights, the default z-packed LiDAR encoder), warmed up once, then 3
     requests (synthetic batches of seeds 0, 1, 2) with the kernels' launch
     counts set to 0 before them and read after them (per request:
     window_knn 2, subm_ext_conv 13 on bf16 tensors, subm_ext_conv_dx
     and knn2 0); per-request
     and per-stage (stop_at prefixes) times, peak memory, and a
     torch.profiler breakdown of device time by kernel (full forward and
     pts stage) with the device's busy share; every K2 call of a pts
     prefix against its plain version on the call's own bf16 inputs; K2's
     bf16 times and bound at those shapes. It runs before any profiler has
     traced the process;
  3. main path, fp32: the same through coocc_tpu_torch.entry.entry() (the
     JAX entry's twin), with its own counts set to 0 (request times, peak
     memory and the full forward's profile, no stages); K1's masks equal to
     phase 2's; phase 2's outputs against these (occ drift, coarse argmax
     agreement, common refined cells, logged; JAX's own bf16 drift bounds
     them in phase 8);
  4. dense path: the same weights with pts.impl="dense"; its pts prefix
     and request times and profile, and the packed encoder's pts_voxel
     held against the dense one at flagship shapes;
  5. kernels against their plain PyTorch versions on the card, at the main
     path's shapes (and ragged ones), with times, bounds and library calls:
     window_knn (exact: the flagship windows on random and real masks, a
     clipped window, a Z=32 grid, the OpenOccupancy grid and windows; with
     the divergence of the old offset walk and the column walk),
     subm_ext_conv (each epilogue mode, fp32 and bf16 inputs; fp32 times),
     knn2 (exact on integer cell coordinates and on ties across key tiles,
     by distance on floats);
  6. the bench twin, `python -m coocc_tpu_torch.bench` (bf16), once;
  7. the tiny config on the card against the same model on the CPU (the
     route the tests hold against the JAX package), dense and packed in
     fp32, packed in bf16.
  8. real-shape parity: the flagship at its own shapes against JAX's
     committed fingerprint (coocc_tpu_torch/parity/flagship_real.npz): the
     weights' and batch's digests, then the card's fp32 and bf16 outputs at
     every prefix within 2x (max) and 1.5x (mean) of the CPU port's own
     distance to JAX;
  9. train path: the flagship's train step at full width in bf16
     (entry.train_steps), a warm-up step then 3 steps with the counts set
     to 0 before them and read after them (per step: window_knn 2,
     subm_ext_conv 13, subm_ext_conv_dx 13), times, peak memory, a profiled
     step, finite losses, moved parameters and BN statistics, and K2's dX
     on its 13 calls' own inputs against its plain version; then a tiny
     train step on the card against the CPU;
 10. the epoch loop (train/loop.py:train, the train CLI's function): the
     flagship in bf16 from flax's initial weights, 1 epoch of 2 steps and
     the eval hook on 2 batches, with the counts set to 0 before it and
     read after it (window_knn 8, subm_ext_conv 52, subm_ext_conv_dx 26);
     step and eval times, the SSC summary, the checkpoint's bytes and save
     and restore times; the restored checkpoint bit-equal to the trained
     state; the eval repeated bit for bit, and the test CLI's eval of the
     work dir equal to the loop's.
Prints the card, the kernels' JSON line (the served bf16 path's launches
and K2 times, K2's fp32 ones beside them; the train path's and the loop's
launches and K2's dX row) and, last, the result line. Needs a CUDA card and the
repository around it; it imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
TOL = dict(atol=5e-3, rtol=5e-3)
# packed vs dense pts_voxel, as fractions of max |dense|: the packed
# encoder's nine SubM layers round their operands to bf16 (K2), the dense
# one stays fp32, and the roundings compound layer over layer. On the tiny
# config (CPU) the two differ by 2.2% at most; the JAX kernel route differs
# from the JAX fp32 route by 1.4-2.2% there (tests/test_torch_packed_
# encoder.py). A fault in the encoder's wiring moves outputs by O(1).
PACKED_VS_DENSE_MAX = 5e-2
PACKED_VS_DENSE_MEAN = 2e-3
# K2 against its plain version: both sum the same exact bf16 products in
# fp32, in other orders (K = 9*(pC+2C) <= 3456 terms): the conv within 2e-5
# of its scale, carried through the epilogue (phase_subm_conv); bf16
# outputs within one bf16 ulp more (the two fp32 values may straddle a
# rounding boundary).
K2_FP32_REL = 2e-5
BF16_ULP_REL = 2.0 ** -7
# K2 launches per train step: 13 forward (mask epilogue) and 13 dX
PER_TRAIN_STEP = {"window_knn": 2, "subm_ext_conv": 13,
                  "subm_ext_conv_dx": 13, "knn2": 0}


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


def host_ms(fn, inputs):
    """Median host ms of fn(x) over `inputs`, each ending in a sync."""
    ts = []
    for x in inputs:
        sync()
        t0 = time.perf_counter()
        fn(x)
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


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


PER_REQUEST = {"window_knn": 2, "subm_ext_conv": 13, "subm_ext_conv_dx": 0,
               "knn2": 0}


def phase_main_path(kernels, requests):
    """The fp32 flagship through entry.entry(), the JAX entry's twin (its
    batch is request 0's)."""
    from coocc_tpu_torch.entry import entry
    model, _ = entry("cuda")
    launches, outs, masks = drive_main_path(model, requests, kernels,
                                            stages=False)
    return model, launches, masks, outs


def drive_main_path(model, requests, kernels, stages=True):
    """One warm-up forward, then the 3 requests with the kernels' launch
    counts set to 0 before them and read after them (and per request);
    per-request times, peak memory, device time by kernel of the full
    forward and, with `stages`, per-stage times and the pts stage's device
    time by kernel. -> (launches, the requests' outputs on the host, K1's
    two masks of request 0)."""
    import torch
    from coocc_tpu_torch.models.coocc_ray import STAGES
    from coocc_tpu_torch.nn.sparse_enc_packed import PackedLiDAREnc8x
    cfg = model.cfg
    if type(model.pts_middle_encoder) is not PackedLiDAREnc8x:
        raise AssertionError("the flagship does not run the packed encoder")
    model(requests[0])  # warm-up: cuDNN algorithm selection, allocator
    sync()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    req_ms, outs = [], []
    for i, b in enumerate(requests):
        before = {n: k.launches for n, k in kernels.items()}
        sync()
        t0 = time.perf_counter()
        out = model(b)
        sync()
        req_ms.append((time.perf_counter() - t0) * 1e3)
        check_outputs(out, cfg)
        grew = {n: k.launches - before[n] for n, k in kernels.items()}
        if grew != PER_REQUEST:
            raise AssertionError(f"request {i}: launches {grew}, want "
                                 f"{PER_REQUEST}")
        log(f"request {i} (seed {i}): {req_ms[-1]:.3f} ms, "
            f"fine_valid {int(out['fine_valid'].sum())}, "
            f"fine_overflow {int(out['fine_overflow'].sum())}")
        outs.append({k: v.cpu() for k, v in out.items()})
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"main path launches: {launches}")
    log(f"request ms: {[round(t, 3) for t in req_ms]} "
        f"(median {statistics.median(req_ms):.3f})")
    log(f"peak memory allocated: {peak / 2**30:.3f} GiB")

    if stages:
        prefix = {}
        for stop in STAGES + (None,):
            prefix[stop or "full"] = host_ms(
                lambda b: model(b, stop_at=stop), requests)
        prev = 0.0
        for name, t in prefix.items():
            log(f"stage {name:6s}: prefix {t:9.3f} ms, marginal "
                f"{t - prev:9.3f} ms")
            prev = t
    log("profile, full forward (device time by kernel):")
    device_breakdown(model, requests, 15)
    if stages:
        log("profile, pts stage (voxelize + packed encoder, device time by "
            "kernel):")
        device_breakdown(pts_stage(model), requests, 12)
    pts = model(requests[0], stop_at="pts")
    masks = {"img": pts["img_voxel"][0].abs().sum(-1) != 0,
             "pts": pts["pts_voxel"][0].abs().sum(-1) != 0}
    # request 0's stage outputs, for the drift between dtypes by stage
    stage_outs = {k: v.cpu() for k, v in pts.items()}
    stage_outs["voxel_feats"] = model(requests[0],
                                      stop_at="fuse")["voxel_feats"].cpu()
    for i, t in enumerate(model(requests[0], stop_at="sem")["semantic"]):
        stage_outs[f"semantic[{i}]"] = t.cpu()
    outs[0]["stages"] = stage_outs
    return launches, outs, masks


def pts_stage(model):
    """The model's pts stage alone (voxelize + LiDAR encoder) on a batch."""
    import torch

    def run(batch):
        with torch.no_grad():
            return model._pts_voxels(batch)
    return run


def device_breakdown(fn, inputs, top: int):
    """torch.profiler over fn(x) for each input: device time by kernel name
    (ms per input, the `top` largest) and the device's busy share of the
    host wall time. Kernels run on one stream, so their times add up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in inputs:
            fn(x)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:70]
            by_name[name] = by_name.get(name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if busy == 0:
        log("profiler: no device time recorded (not measured)")
        return
    n = len(inputs)
    log(f"  wall {wall / n:.3f} ms per input, device busy {busy / n:.3f} ms "
        f"({100 * busy / wall:.1f}%), {len(by_name)} kernel names")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {ms / n:9.3f} ms  {100 * ms / busy:5.1f}%  {name}")


def phase_dense_path(model, requests):
    """The same weights with pts.impl="dense": its times, and the packed
    pts_voxel against the dense one at flagship shapes."""
    import torch
    from coocc_tpu_torch.models.coocc_ray import CoOccRay
    from coocc_tpu_torch.nn.sparse_enc_dense import DenseLiDAREnc8x
    cfg = model.cfg
    dense = CoOccRay(dataclasses.replace(cfg, pts=dataclasses.replace(
        cfg.pts, impl="dense"))).eval().to("cuda")
    dense.load_state_dict(model.state_dict(), strict=True)
    if type(dense.pts_middle_encoder) is not DenseLiDAREnc8x:
        raise AssertionError("pts.impl='dense' did not give the dense twin")
    dense(requests[0])  # warm-up
    sync()
    pts_ms = host_ms(lambda b: dense(b, stop_at="pts"), requests)
    img_ms = host_ms(lambda b: dense(b, stop_at="img"), requests)
    full_ms = host_ms(dense, requests)
    log(f"dense path: request median {full_ms:.3f} ms, pts prefix "
        f"{pts_ms:.3f} ms (pts marginal {pts_ms - img_ms:.3f} ms)")
    log("profile, dense pts stage (voxelize + dense encoder, device time "
        "by kernel):")
    device_breakdown(pts_stage(dense), requests, 8)
    worst = (0.0, 0.0)
    for i, b in enumerate(requests):
        d = dense(b, stop_at="pts")["pts_voxel"]
        p = model(b, stop_at="pts")["pts_voxel"]
        scale = float(d.abs().max())
        err = (p - d).abs()
        rel_max, rel_mean = float(err.max()) / scale, \
            float(err.mean()) / scale
        log(f"packed vs dense pts_voxel, request {i}: max_abs_err "
            f"{float(err.max()):.6g}, scale max|dense| {scale:.6g}, max "
            f"{rel_max:.6g} and mean {rel_mean:.6g} of the scale "
            f"(bounds {PACKED_VS_DENSE_MAX}, {PACKED_VS_DENSE_MEAN})")
        if not (scale > 0 and rel_max <= PACKED_VS_DENSE_MAX
                and rel_mean <= PACKED_VS_DENSE_MEAN):
            raise AssertionError("packed pts_voxel differs from dense")
        worst = (max(worst[0], rel_max), max(worst[1], rel_mean))
    del dense
    return worst


def phase_window_knn(model, masks, launches):
    """Kernel against plain version on the card; -> the kernel's JSON row."""
    import torch
    from coocc_tpu_torch.ops.window_knn import (WALK_CHUNK,
                                                best2_ranks_plain,
                                                column_tables, make_offsets,
                                                window_knn, window_knn_plain)
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
    for d in (0.02, 0.3):
        m = torch.rand(shape, generator=gen, device="cuda") < d
        cases.append((f"clipped window (6,6,7) at 8.0, density {d}", m,
                      make_offsets(6, 6, 7, 8.0)))
        m = torch.rand((37, 23, 32), generator=gen, device="cuda") < d
        cases.append((f"Z=32 ragged (37,23,32), density {d}", m,
                      make_offsets(6, 6, 7, 13.3)))
    # the OpenOccupancy fuser grid and windows (config/configs.py)
    for d in (0.01, 0.2):
        m = torch.rand((128, 128, 10), generator=gen, device="cuda") < d
        for radii in ((8, 8, 9), (6, 6, 7)):
            cases.append((f"openoccupancy (128,128,10) {radii}, density {d}",
                          m, make_offsets(*radii, 13.3)))
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
    walks = {"offset walk (earlier design)": [0, 0], "column walk": [0, 0]}
    for key in ("img", "pts"):
        m, offs = masks[key], windows[key]
        n, O = m.numel(), len(offs)
        nbytes += n + offs.nbytes + 8 * n
        _, b2 = best2_ranks_plain(m, offs)
        steps = torch.where(b2 < O, b2 + 1, O)
        probes += int(steps.sum())
        min_rank = torch.from_numpy(column_tables(offs).min_rank).cuda()
        cols = torch.searchsorted(min_rank, b2, right=True)
        cols = (cols + WALK_CHUNK - 1) // WALK_CHUNK * WALK_CHUNK
        for name, per_cell, warp in (
                ("offset walk (earlier design)", steps, offset_walk_warps),
                ("column walk", cols, column_walk_warps)):
            walks[name][0] += int(per_cell.sum())
            walks[name][1] += 32 * warp_longest(per_cell, warp(m.shape))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = probes / FP32_OPS_PER_S * 1e3
    log(f"window_knn bound: {nbytes} bytes -> {bytes_ms:.6f} ms; {probes} "
        f"probes -> {ops_ms:.6f} ms")
    for name, (steps, longest) in walks.items():
        log(f"window_knn divergence, {name}: {steps} steps over both "
            f"windows, sum over warps of 32 x the longest walk {longest} "
            f"({longest / steps:.3f} x the steps)")
    return {"name": "window_knn", "route": "cuda",
            "source": "coocc_tpu_torch/csrc/window_knn.cu",
            "replaces": "coocc_tpu/ops/pallas/window_knn.py:37",
            "launches": launches["window_knn"], "max_abs_err": max_err,
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def offset_walk_warps(shape):
    """Warp of each cell [X*Y*Z] in K1's earlier offset walk (one thread a
    cell, blocks of 4x8x8 cells, z fastest)."""
    import torch
    X, Y, Z = shape
    x, y, z = (t.reshape(-1) for t in torch.meshgrid(
        *(torch.arange(n, device="cuda") for n in shape), indexing="ij"))
    block = ((x // 4) * -(-Y // 8) + y // 8) * -(-Z // 8) + z // 8
    return block * 8 + ((x % 4) * 64 + (y % 8) * 8 + z % 8) // 32


def column_walk_warps(shape):
    """Warp slot of each cell [X*Y*Z] in csrc/window_knn.cu (blocks of 4x8
    columns, 256 threads walking the block's cells z fastest, 32 a warp per
    pass)."""
    import torch
    X, Y, Z = shape
    x, y, z = (t.reshape(-1) for t in torch.meshgrid(
        *(torch.arange(n, device="cuda") for n in shape), indexing="ij"))
    block = (x // 4) * -(-Y // 8) + y // 8
    c = ((x % 4) * 8 + y % 8) * Z + z
    return block * Z + c // 32  # 4*8*Z cells a block: Z warp passes


def warp_longest(per_cell, warp) -> int:
    """Sum over warps of the longest walk of their cells."""
    import torch
    longest = torch.zeros(int(warp.max()) + 1, dtype=torch.long,
                          device="cuda")
    longest.scatter_reduce_(0, warp, per_cell.long(), "amax")
    return int(longest.sum())


def k2_mode(bn, identity) -> str:
    return "mask" if bn is None else "bn_relu" if identity is None \
        else "bn_res_relu"


K2_MODES = ("mask", "bn_relu", "bn_res_relu")


def k2_work(shape, p, Co, mode, esz):
    """(useful FLOP, bytes) one K2 call needs: the products of the
    extended weight's nonzero blocks only (a carry's at every pack but a
    sample's last or first), each input read once (x, the cell mask, the
    residual in bn_res_relu, the BN vectors, the weight panels) and the
    output written once; esz is the activations' element size (4 fp32, 2
    bf16)."""
    from coocc_tpu_torch.ops.subm_conv import KB, kblocks
    B, bz, X, Y, pC = shape
    C = pC // p
    ops = 0
    for _, dg, _, width in kblocks(p, C, Co):
        packs = B * (bz if dg == 0 else bz - 1)
        ops += 2 * 9 * KB * width * packs * X * Y
    sites = B * bz * X * Y
    nbytes = sites * (pC * esz + p * Co * esz + p)
    nbytes += 2 * 9 * KB * sum(w for *_, w in kblocks(p, C, Co))
    if mode != "mask":
        nbytes += 3 * Co * 4
    if mode == "bn_res_relu":
        nbytes += sites * p * Co * esz
    return ops, nbytes


def k2_levels(calls, dtype):
    """{(shape, p, Co): {mode: calls}} of one pts prefix's K2 calls, each
    of which must take an x of `dtype`."""
    levels = {}
    for shape, p, Co, dt, mode in calls:
        if dt != dtype:
            raise AssertionError(f"main path K2 input is {dt}, not {dtype}")
        counts = levels.setdefault((shape, p, Co), dict.fromkeys(K2_MODES, 0))
        counts[mode] += 1
    log(f"subm_ext_conv main-path calls per forward ({str(dtype)[6:]}): "
        f"{[(s, p, Co, n) for (s, p, Co), n in levels.items()]}")
    if len(calls) != PER_REQUEST["subm_ext_conv"]:
        raise AssertionError(f"{len(calls)} K2 calls in one pts prefix")
    return levels


def k2_inputs(gen, shape, p, Co, dtype, n):
    """n random inputs of one shape, with one weight, mask and BatchNorm: x
    and the residual zero outside 30% of the cells, as the encoder's are."""
    import torch
    from coocc_tpu_torch.ops.subm_conv import BNAffine

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    B, bz, X, Y, pC = shape
    C = pC // p
    w27 = randn(27, C, Co) / (27 * C) ** 0.5
    bn = BNAffine(0.3 * randn(Co), 0.5 + torch.rand(
        Co, generator=gen, device="cuda"), 0.3 * randn(Co))
    xs = []
    for _ in range(n):
        mcell = torch.rand((B, bz, X, Y, p), generator=gen,
                           device="cuda") < 0.3
        x = randn(*shape).reshape(B, bz, X, Y, p, C) * mcell[..., None]
        idn = randn(B, bz, X, Y, p, Co) * mcell[..., None]
        xs.append((x.reshape(shape).to(dtype), mcell,
                   idn.reshape(B, bz, X, Y, p * Co).to(dtype)))
    return xs, w27, bn


def k2_args(mode, idn, bn):
    """(bn, identity) for one epilogue mode."""
    return (bn if mode != "mask" else None,
            idn if mode == "bn_res_relu" else None)


def k2_check(x, w27, p, mcell, bn, identity):
    """K2 against its plain version on one input: -> (max abs err, ok).
    Both sum the same exact bf16 products in fp32, in other orders: the
    conv within K2_FP32_REL of its scale, times the BN's gain through the
    epilogue, an ulp of the epilogue's own fp32 roundings; a bf16 output
    one bf16 ulp more (the two fp32 values may straddle a rounding
    boundary)."""
    import torch
    from coocc_tpu_torch.ops.subm_conv import (ext_conv_plain,
                                               subm_ext_conv,
                                               subm_ext_conv_plain,
                                               subm_ext_weight)
    got = subm_ext_conv(x, w27, p, mcell, bn, identity).float()
    ref = subm_ext_conv_plain(x, w27, p, mcell, bn, identity).float()
    conv_scale = float(ext_conv_plain(
        x.float(), subm_ext_weight(w27, p), x.shape[1],
        x.shape[-1] // p).abs().max())
    gain = 1.0 if bn is None else max(1.0, float(bn.inv.abs().max()))
    tol = K2_FP32_REL * conv_scale * gain + 2.0 ** -21 * float(
        ref.abs().max())
    err = (got - ref).abs()
    if x.dtype == torch.float32:
        ok = float(err.max()) <= tol
    else:
        ulp = BF16_ULP_REL * torch.maximum(got.abs(), ref.abs())
        ok = bool((err <= ulp + tol).all())
    return float(err.max()), float(ref.abs().max()), conv_scale, ok


def phase_subm_conv(model, requests):
    """K2 against its plain version on the card: every call of the fp32
    main path's pts prefix on its own inputs; random inputs in every
    epilogue mode at those level shapes (res1, res2, res3; conv_out is
    res3's shape) and two ragged ones, fp32 and bf16; the fp32 times per
    forward. -> (max abs err over the fp32 cases, the fp32 times)."""
    import torch
    calls, max_err = k2_main_path_check(model, requests[0])
    levels = k2_levels(calls, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(s, p, Co, f"main path x{sum(n.values())}") for (s, p, Co), n
             in levels.items()]
    cases += [((2, 3, 37, 29, 128), 2, 64, "ragged B=2, p=2"),
              ((1, 2, 45, 51, 128), 4, 32, "ragged p=4")]
    for shape, p, Co, name in cases:
        for dtype in (torch.float32, torch.bfloat16):
            [(x, mcell, idn)], w27, bn = k2_inputs(gen, shape, p, Co, dtype,
                                                   1)
            for mode in K2_MODES:
                err, scale, conv_scale, ok = k2_check(
                    x, w27, p, mcell, *k2_args(mode, idn, bn))
                sync()
                if dtype == torch.float32:
                    max_err = max(max_err, err)
                log(f"subm_ext_conv vs plain [{name} {shape} p={p} "
                    f"{str(dtype)[6:]} {mode}]: max_abs_err {err:.6g}, "
                    f"scale {scale:.6g}, conv scale {conv_scale:.6g}")
                if not (ok and scale > 0):
                    raise AssertionError(
                        f"subm_ext_conv differs: {name} {dtype} {mode}")
    return max_err, k2_times(gen, levels, torch.float32)


def k2_times(gen, levels, dtype):
    """K2's times per forward at the main path's shapes in `dtype`, each
    repeat on its own input, weighted by the main path's calls per mode,
    beside the mask-only mode, the unfused PyTorch epilogue, the plain
    version, cuDNN bf16 on the concatenated input and the concat it needs;
    and its bound from this work."""
    import torch
    import torch.nn.functional as F
    from coocc_tpu_torch.ops.subm_conv import (epilogue_plain, shift_ext,
                                               subm_ext_conv,
                                               subm_ext_conv_plain,
                                               subm_ext_weight)
    reps = 5
    kernel = mask_only = unfused = plain = library = concat = 0.0
    ops = nbytes = full_ops = 0
    esz = torch.empty((), dtype=dtype).element_size()
    for (shape, p, Co), counts in levels.items():
        xs, w27, bn = k2_inputs(gen, shape, p, Co, dtype, reps)
        bz = shape[1]
        G, X, Y = shape[0] * bz, shape[2], shape[3]
        C = shape[-1] // p
        E = shape[-1] + 2 * C
        n = sum(counts.values())
        ms = {}
        for mode in K2_MODES:
            ms[mode] = timed_ms(
                lambda x, m, i, mode=mode: subm_ext_conv(
                    x, w27, p, m, *k2_args(mode, i, bn)), reps,
                lambda i: xs[i])
        convs = [subm_ext_conv(x, w27, p, torch.ones_like(m)) for x, m, _ in
                 xs]
        e_ms = {mode: timed_ms(
            lambda c, m, i, mode=mode: epilogue_plain(
                c, m, *k2_args(mode, i, bn)), reps,
            lambda i: (convs[i], xs[i][1], xs[i][2])) for mode in K2_MODES}
        p_ms = {mode: timed_ms(
            lambda x, m, i, mode=mode: subm_ext_conv_plain(
                x, w27, p, m, *k2_args(mode, i, bn)), 2,
            lambda i: xs[i]) for mode in K2_MODES}
        # library: cuDNN bf16 conv2d of the pre-concatenated extended input
        xb = [x.to(torch.bfloat16) for x, _, _ in xs]
        exts = [shift_ext(x, C).reshape(G, X, Y, E).permute(0, 3, 1, 2)
                for x in xb]
        wb = subm_ext_weight(w27, p).to(torch.bfloat16).permute(
            3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        F.conv2d(exts[0], wb, padding=1)
        l_ms = timed_ms(lambda e: F.conv2d(e, wb, padding=1), reps,
                        lambda i: (exts[i],))
        c_ms = timed_ms(lambda x: shift_ext(x, C), reps, lambda i: (xb[i],))
        del xs, xb, exts, convs
        lvl_ops, _ = k2_work(shape, p, Co, "mask", esz)
        log(f"subm_ext_conv {str(dtype)[6:]} {shape} p={p} calls {counts}: "
            "kernel " + ", ".join(f"{m} {ms[m]:.4f} ms" for m in K2_MODES)
            + f" ({lvl_ops / ms['mask'] / 1e9:.1f} TFLOP/s useful, mask "
            f"mode); unfused PyTorch epilogue "
            + ", ".join(f"{m} {e_ms[m]:.4f}" for m in K2_MODES)
            + f" ms; plain {p_ms['mask']:.3f} ms (mask); cuDNN bf16 on the "
            f"concatenated input {l_ms:.4f} ms, the bf16 concat {c_ms:.4f} "
            "ms")
        for mode, k in counts.items():
            kernel += k * ms[mode]
            unfused += k * e_ms[mode]
            plain += k * p_ms[mode]
            o, b = k2_work(shape, p, Co, mode, esz)
            ops += k * o
            nbytes += k * b
        mask_only += n * ms["mask"]
        library += n * l_ms
        concat += n * c_ms
        full_ops += n * 2 * G * X * Y * 9 * E * p * Co
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"subm_ext_conv {str(dtype)[6:]} per forward: fused kernel "
        f"{kernel:.4f} ms (13 launches, {ops / kernel / 1e9:.1f} TFLOP/s "
        f"useful), mask-only mode {mask_only:.4f} ms, unfused PyTorch "
        f"epilogue {unfused:.4f} ms, plain {plain:.4f} ms, cuDNN bf16 "
        f"{library:.4f} ms (+ concat {concat:.4f} ms, not in library_ms); "
        f"bound {ops} useful FLOP -> {ops_ms:.4f} ms, {nbytes} bytes -> "
        f"{bytes_ms:.4f} ms; full-K {full_ops} FLOP -> "
        f"{full_ops / BF16_OPS_PER_S * 1e3:.4f} ms")
    return {"ms": kernel, "plain_ms": plain,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library}


def k2_main_path_check(model, batch):
    """Every K2 call of one pts prefix against its plain version on the
    call's own inputs (the main path's shapes, modes, data and dtype):
    -> (the calls, each (x shape, p, Co, dtype, epilogue), max abs err)."""
    from coocc_tpu_torch.nn import sparse_enc_packed
    calls, worst = [], [0.0]
    inner = sparse_enc_packed.subm_ext_conv

    def check(x_pb, w27, p, mcell, bn=None, identity=None):
        mode = k2_mode(bn, identity)
        calls.append((tuple(x_pb.shape), p, w27.shape[2], x_pb.dtype, mode))
        err, scale, conv_scale, ok = k2_check(x_pb, w27, p, mcell, bn,
                                              identity)
        log(f"subm_ext_conv vs plain [main path input {tuple(x_pb.shape)} "
            f"p={p} {str(x_pb.dtype)[6:]} {mode}]: max_abs_err {err:.6g}, "
            f"scale {scale:.6g}, conv scale {conv_scale:.6g}")
        if not (ok and scale > 0):
            raise AssertionError("subm_ext_conv differs on a main path input")
        worst[0] = max(worst[0], err)
        return inner(x_pb, w27, p, mcell, bn, identity)

    sparse_enc_packed.subm_ext_conv = check
    try:
        model(batch, stop_at="pts")
    finally:
        sparse_enc_packed.subm_ext_conv = inner
    return calls, worst[0]


def phase_knn2(masks, launches):
    """K3 against its plain version: queries the active image cells of the
    main path's fuser grid, keys its active LiDAR cells (integer
    coordinates: exact), ties across key tiles (exact), and a random-float
    case (by distance, to 1e-4 as tests/test_pallas_knn.py compares)."""
    import numpy as np
    import torch
    from coocc_tpu_torch.ops.knn import knn2, knn2_plain
    gen = torch.Generator(device="cuda").manual_seed(2)
    thresh = 13.3

    def cells(m):
        return torch.nonzero(m).float()

    q, k = cells(masks["img"]), cells(masks["pts"])
    qm = torch.ones(len(q), dtype=torch.bool, device="cuda")
    km = torch.ones(len(k), dtype=torch.bool, device="cuda")
    idx, dist = knn2(q, k, qm, km, thresh)
    ref_idx, ref_dist = knn2_plain(q, k, qm, km, thresh)
    sync()
    if not (torch.equal(idx, ref_idx) and torch.equal(dist, ref_dist)):
        raise AssertionError("knn2 differs from plain on cell coordinates")
    log(f"knn2 vs plain [main path cells: {len(q)} image-cell queries, "
        f"{len(k)} LiDAR-cell keys]: idx and dist equal, "
        f"{int((idx >= 0).sum())} neighbours within {thresh}")

    # ties: integer keys in a 6-box with the tiles before the 512-key
    # boundaries repeated after them, and one query far off whose keys 5,
    # 515 and 519 make the TPU kernel's merge keep 519 where the
    # lexicographic second is 5 (tests/test_torch_knn.py builds the same);
    # Q = 1000 is not a multiple of the kernel's 64 queries a block
    rng = np.random.RandomState(3)
    keys = rng.randint(0, 6, (1300, 3)).astype(np.float32)
    keys[512:700] = keys[324:512]
    keys[1024:1200] = keys[848:1024]
    keys[[5, 515, 519]] = 100 + np.array([[2, 0, 0], [1, 0, 0], [0, 2, 0]],
                                         np.float32)
    for Q in (301, 1000):
        queries = rng.randint(0, 6, (Q, 3)).astype(np.float32)
        queries[0] = 100
        tq, tk, tqm, tkm = (torch.from_numpy(a).cuda() for a in (
            queries, keys, rng.rand(Q) > 0.05, rng.rand(len(keys)) > 0.1))
        idx, dist = knn2(tq, tk, tqm, tkm, thresh)
        ref_idx, ref_dist = knn2_plain(tq, tk, tqm, tkm, thresh)
        sync()
        if not (torch.equal(idx, ref_idx) and torch.equal(dist, ref_dist)
                and idx[0].tolist() == [515, 519]):
            raise AssertionError(f"knn2 differs from plain on ties, Q={Q}")
        log(f"knn2 vs plain [ties across key tiles, Q={Q} x K={len(keys)}]:"
            f" idx and dist equal, query 0 -> {idx[0].tolist()}")

    Qf, Kf = 20000, 30000
    qf = torch.rand(Qf, 3, generator=gen, device="cuda") * 100
    kf = torch.rand(Kf, 3, generator=gen, device="cuda") * 100
    qmf = torch.rand(Qf, generator=gen, device="cuda") > 0.1
    kmf = torch.rand(Kf, generator=gen, device="cuda") > 0.1
    idx, _ = knn2(qf, kf, qmf, kmf, thresh)
    ref_idx, _ = knn2_plain(qf, kf, qmf, kmf, thresh)

    def d_of(i):
        d = (kf[i.clamp(min=0).long()] - qf[:, None]).norm(dim=-1)
        return torch.where(i >= 0, d, float("inf"))

    a, b = d_of(idx), d_of(ref_idx)
    both = torch.isfinite(a) & torch.isfinite(b)
    float_err = float((a[both] - b[both]).abs().max()) if bool(
        both.any()) else 0.0
    sync()
    log(f"knn2 vs plain [random floats {Qf}x{Kf}]: distance max_abs_err "
        f"{float_err:.6g}, same validity {torch.equal(idx >= 0, ref_idx >= 0)}"
        f", idx equal {torch.equal(idx, ref_idx)}")
    tol_ok = bool(((a[both] - b[both]).abs()
                   <= 1e-4 + 1e-4 * b[both]).all())
    if not (torch.equal(torch.isfinite(a), torch.isfinite(b)) and tol_ok):
        raise AssertionError("knn2 differs from plain on random floats")

    # times on the cell case, each repeat on its own masks (the real ones
    # with 0.1% of the cells flipped)
    reps = 10
    variants = []
    for _ in range(reps):
        pair = []
        for key in ("img", "pts"):
            flip = torch.rand(masks[key].shape, generator=gen,
                              device="cuda") < 1e-3
            pts = cells(masks[key] ^ flip)
            pair += [pts, torch.ones(len(pts), dtype=torch.bool,
                                     device="cuda")]
        variants.append(pair)

    def run(fn):
        return lambda qv, qmv, kv, kmv: fn(qv, kv, qmv, kmv, thresh)

    def library(qv, qmv, kv, kmv):
        d = torch.cdist(qv, kv)
        d = d.masked_fill(~kmv[None], float("inf"))
        return d.topk(2, dim=1, largest=False)

    k_ms = timed_ms(run(knn2), reps, lambda i: variants[i])
    p_ms = timed_ms(run(knn2_plain), 3, lambda i: variants[i])
    library(*variants[0])
    l_ms = timed_ms(library, reps, lambda i: variants[i])
    Q, K = len(q), len(k)
    ops_ms = 8 * Q * K / FP32_OPS_PER_S * 1e3
    bytes_ms = (13 * Q + 13 * K + 16 * Q) / HBM_BYTES_PER_S * 1e3
    log(f"knn2 ms: kernel {k_ms:.4f}, plain {p_ms:.3f}, torch.cdist + topk "
        f"{l_ms:.4f}; bound {8 * Q * K} operations -> {ops_ms:.6f} ms, "
        f"{13 * Q + 13 * K + 16 * Q} bytes -> {bytes_ms:.6f} ms")
    return {"name": "knn2", "route": "cuda",
            "source": "coocc_tpu_torch/csrc/knn.cu",
            "replaces": "coocc_tpu/ops/pallas/knn.py:29",
            "launches": launches["knn2"], "max_abs_err": float_err,
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": l_ms}


def phase_bf16_path(kernels, cfg, requests):
    """The flagship as it is served, in its config's bf16 compute
    (entry.served_model, the model of `python -m coocc_tpu_torch`): the
    main path's requests, counts, times and profiles; every K2 call of a
    pts prefix against its plain version on its own bf16 inputs, and K2's
    bf16 times at those shapes. It runs first, before any profiler has
    traced the process. -> (launches, outputs, K1's masks, K2's max abs err
    on the main path, K2's bf16 times)."""
    import torch
    from coocc_tpu_torch.entry import served_model
    model = served_model(cfg, "cuda")
    if not (model.dtype == torch.bfloat16
            and model.pts_middle_encoder.compute_dtype == torch.bfloat16):
        raise AssertionError(f"the served flagship computes in {model.dtype}")
    launches, outs, masks = drive_main_path(model, requests, kernels)
    after = host_ms(model, requests)
    log(f"request median after the profiler has traced the process: "
        f"{after:.3f} ms")
    calls, max_err = k2_main_path_check(model, requests[0])
    levels = k2_levels(calls, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    times = k2_times(gen, levels, torch.bfloat16)
    return launches, outs, masks, max_err, times


def check_bf16_masks(masks16, masks32):
    """K1's two masks are dtype-free: equal in the bf16 and fp32 runs."""
    import torch
    for key in ("img", "pts"):
        if not torch.equal(masks16[key], masks32[key]):
            raise AssertionError(f"K1's {key} mask differs between bf16 and "
                                 "fp32")
    log("K1's two masks (img, pts) are equal in bf16 and fp32: "
        f"{int(masks16['img'].sum())} and {int(masks16['pts'].sum())} "
        "active cells")


def check_bf16_drift(outs16, outs32):
    """The bf16 run's outputs against the fp32 run's, request by request:
    JAX's output dtypes and finite values; the drift is logged (the bounds
    that hold it are JAX's own, in phase_real_shape_parity)."""
    import torch
    for key, t32 in outs32[0]["stages"].items():
        t16 = outs16[0]["stages"][key]
        if t16.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 run's {key} is {t16.dtype}")
        scale = float(t32.abs().max())
        err = (t16.float() - t32).abs()
        log(f"bf16 vs fp32, request 0, {key}: max |diff| "
            f"{float(err.max()) / scale:.6g} and mean "
            f"{float(err.mean()) / scale:.6g} of max |fp32| {scale:.6g}")
    for i, (o16, o32) in enumerate(zip(outs16, outs32)):
        if o16["occ"].dtype != torch.bfloat16 or \
                o16["fine_logits"].dtype != torch.float32:
            raise AssertionError("bf16 outputs: occ must be bf16 and "
                                 "fine_logits fp32, as JAX returns them")
        occ16, occ32 = o16["occ"].float(), o32["occ"]
        scale = float(occ32.abs().max())
        err = (occ16 - occ32).abs()
        rel_max, rel_mean = float(err.max()) / scale, \
            float(err.mean()) / scale
        agree = float((occ16.argmax(-1) == occ32.argmax(-1)).float().mean())

        def cells(o):
            return {tuple(c) for c, v in zip(o["fine_coords"][0].tolist(),
                                             o["fine_valid"][0].tolist())
                    if v}
        c16, c32 = cells(o16), cells(o32)
        common = len(c16 & c32) / max(1, len(c32))
        log(f"bf16 vs fp32, request {i}: occ max |diff| {rel_max:.6g} and "
            f"mean {rel_mean:.6g} of max |fp32 occ| {scale:.6g}; coarse "
            f"argmax agreement {agree:.6f}; common fine cells {common:.6f} "
            f"of {len(c32)}")
        if not all(bool(torch.isfinite(o16[k].float()).all())
                   for k in ("occ", "fine_logits")):
            raise AssertionError(f"bf16 outputs are not finite (request {i})")


def phase_real_shape_parity():
    """The flagship at real shapes against JAX's fingerprint
    (coocc_tpu_torch/parity/flagship_real.npz, written on a CPU by
    tests/test_torch_real_shapes.py): the weights' and the batch's digests
    first, then the card's fp32 (TF32 off) and bf16 forwards, every prefix
    within 2x (max) and 1.5x (mean) of the CPU port's own distance to JAX
    (`parity.check`); both dtypes are read before a failure is raised.
    -> {dtype: [(name, card, cpu port, ok)]}."""
    import torch
    from coocc_tpu_torch import parity
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import FLAGSHIP
    fp = parity.load()
    cfg = get_config(FLAGSHIP)
    batch_np = synthetic_batch(cfg, batch_size=1, seed=0)
    if parity.batch_digest(batch_np) != str(fp["batch_digest"]):
        raise AssertionError("the fingerprint's batch digest differs")
    batch = batch_np.to("cuda")
    results = {}
    for prefix, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        model = parity.fingerprint_model(cfg, "cuda", dtype)
        digest = parity.state_digest(model)
        if digest != str(fp["state_digest"]):
            raise AssertionError(f"the fingerprint's state_dict digest "
                                 f"differs: {digest}")
        out = parity.capture(model, batch)
        del model
        torch.cuda.empty_cache()
        res = parity.check(fp, prefix, out)
        for name, (dmax, dmean), (pmax, pmean), ok in res:
            log(f"real-shape parity {prefix} {name}: card max {dmax:.6g} "
                f"mean {dmean:.6g}; cpu port max {pmax:.6g} mean "
                f"{pmean:.6g} ({'ok' if ok else 'FAIL'})")
        results[prefix] = res
    bad = [(prefix, r[0]) for prefix, res in results.items()
           for r in res if not r[3]]
    if bad:
        raise AssertionError(f"flagship outputs differ from JAX's "
                             f"fingerprint: {bad}")
    log("real-shape parity: digests equal, fp32 and bf16 within the bounds")
    return results


def k2_dx_check(dy, w27, p):
    """K2's dX (the mirrored-tap conv of the masked cotangent) against its
    plain version on one input, under k2_check's rule: -> (max abs err,
    ok)."""
    import torch
    from coocc_tpu_torch.ops.subm_conv import (ext_conv_plain, flip_taps,
                                               subm_ext_conv_dx,
                                               subm_ext_conv_plain,
                                               subm_ext_weight)
    wf = flip_taps(w27)
    ones = torch.ones(dy.shape[:-1] + (p,), dtype=torch.bool,
                      device=dy.device)
    got = subm_ext_conv_dx(dy, w27, p).float()
    ref = subm_ext_conv_plain(dy, wf, p, ones).float()
    conv_scale = float(ext_conv_plain(dy.float(), subm_ext_weight(wf, p),
                                      dy.shape[1], dy.shape[-1] // p)
                       .abs().max())
    tol = K2_FP32_REL * conv_scale + 2.0 ** -21 * float(ref.abs().max())
    err = (got - ref).abs()
    if dy.dtype == torch.float32:
        return float(err.max()), float(err.max()) <= tol
    ulp = BF16_ULP_REL * torch.maximum(got.abs(), ref.abs())
    return float(err.max()), bool((err <= ulp + tol).all())


def phase_train(kernels):
    """The flagship's train step at full width in its config's bf16
    (entry.train_steps: seeded weights, AdamW, BN on batch statistics,
    the renderer, every loss): one warm-up step, then 3 steps on the
    synthetic batches of seeds 0, 1, 2 with the kernels' counts set to 0
    before them and read after them (per step: window_knn 2, subm_ext_conv
    13, subm_ext_conv_dx 13); ms per step, peak memory, every loss term
    finite, parameters and BN statistics moved; a profiled step's device
    time by kernel; K2's dX on its 13 calls' own inputs against its plain
    version, with its times and bound, and dW's time. -> (launches, the dX
    kernel's JSON row)."""
    import torch
    import torch.nn.functional as F
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import FLAGSHIP, train_steps
    from coocc_tpu_torch.ops import subm_conv as k2
    cfg = get_config(FLAGSHIP)
    t0 = time.perf_counter()
    trainer, [warm] = train_steps(cfg, 1, "cuda")
    sync()
    model = trainer.model
    if model.dtype != torch.bfloat16:
        raise AssertionError(f"the flagship trains in {model.dtype}")
    log(f"train warm-up step (seed 0, model build included): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, loss_total "
        f"{float(warm['loss_total']):.6g}")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batches = [synthetic_batch(cfg, batch_size=1, seed=i).to("cuda")
               for i in range(3)]
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    step_ms = []
    for i, b in enumerate(batches):
        counts = {n: k.launches for n, k in kernels.items()}
        sync()
        t1 = time.perf_counter()
        metrics = trainer.step(b)
        sync()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        grew = {n: k.launches - counts[n] for n, k in kernels.items()}
        if grew != PER_TRAIN_STEP:
            raise AssertionError(f"train step {i}: launches {grew}, want "
                                 f"{PER_TRAIN_STEP}")
        values = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"train step {i}: {values}")
        log(f"train step {i} (seed {i}): {step_ms[-1]:.3f} ms; " + ", ".join(
            f"{k} {v:.6g}" for k, v in values.items()))
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"train launches over 3 steps: {launches}")
    log(f"train step ms: {[round(t, 3) for t in step_ms]} (median "
        f"{statistics.median(step_ms):.3f}); peak memory allocated "
        f"{peak / 2**30:.3f} GiB")
    after = model.state_dict()
    params = dict(model.named_parameters())
    moved = [k for k in params if not torch.equal(before[k], after[k])]
    stats = [k for k in after if "running" in k]
    still = [k for k in stats if torch.equal(before[k], after[k])]
    log(f"train moved {len(moved)} of {len(params)} parameter tensors and "
        f"{len(stats) - len(still)} of {len(stats)} BN statistics")
    if still or len(moved) < 0.95 * len(params):
        raise AssertionError(f"the steps left BN statistics {still[:5]} or "
                             f"{len(params) - len(moved)} parameters still")
    log("profile, one train step (device time by kernel):")
    device_breakdown(trainer.step, batches[:1], 15)

    # K2's dX and dW on one step's own inputs
    calls = {"dx": [], "dw": []}
    inner_dx, inner_dw = k2.subm_ext_conv_dx, k2.subm_ext_weight_grad

    def keep_dx(dy, w27, p):
        calls["dx"].append((dy.detach().clone(), w27.detach().clone(), p))
        return inner_dx(dy, w27, p)

    def keep_dw(x_pb, dy, p):
        calls["dw"].append((x_pb.detach().clone(), dy.detach().clone(), p))
        return inner_dw(x_pb, dy, p)
    # the wrapper counts its launch on its module's name, keep_dx while this
    # step runs; the counts of the main path were read above
    keep_dx.launches = 0
    k2.subm_ext_conv_dx, k2.subm_ext_weight_grad = keep_dx, keep_dw
    try:
        trainer.step(batches[1])
    finally:
        k2.subm_ext_conv_dx, k2.subm_ext_weight_grad = inner_dx, inner_dw
    if len(calls["dx"]) != 13 or len(calls["dw"]) != 13:
        raise AssertionError(f"{len(calls['dx'])} dX, {len(calls['dw'])} dW"
                             " calls in one step")
    max_err = 0.0
    dx_ms = plain_ms = lib_ms = dw_ms = 0.0
    ops = nbytes = 0
    for dy, w27, p in calls["dx"]:
        err, ok = k2_dx_check(dy, w27, p)
        log(f"subm_ext_conv_dx vs plain [train step input "
            f"{tuple(dy.shape)} p={p} {str(dy.dtype)[6:]}]: max_abs_err "
            f"{err:.6g}, scale {float(dy.abs().max()):.6g}")
        if not ok:
            raise AssertionError("K2's dX differs from its plain version")
        max_err = max(max_err, err)
        wf = k2.flip_taps(w27)
        ones = torch.ones(dy.shape[:-1] + (p,), dtype=torch.bool,
                          device="cuda")
        dx_ms += timed_ms(lambda: k2.subm_ext_conv_dx(dy, w27, p), 5)
        plain_ms += timed_ms(lambda: k2.subm_ext_conv_plain(dy, wf, p,
                                                            ones), 2)
        C = dy.shape[-1] // p
        G, X, Y = dy.shape[0] * dy.shape[1], dy.shape[2], dy.shape[3]
        ext = k2.shift_ext(dy, C).reshape(G, X, Y, -1).permute(0, 3, 1, 2)
        wb = k2.subm_ext_weight(wf, p).to(dy.dtype).permute(
            3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        F.conv2d(ext, wb, padding=1)
        lib_ms += timed_ms(lambda: F.conv2d(ext, wb, padding=1), 5)
        o, b = k2_work(tuple(dy.shape), p, w27.shape[1], "mask",
                       dy.element_size())
        ops, nbytes = ops + o, nbytes + b
    for x_pb, dy, p in calls["dw"]:
        dw_ms += timed_ms(lambda: k2.subm_ext_weight_grad(x_pb, dy, p), 5)
    del calls
    torch.cuda.empty_cache()
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"subm_ext_conv_dx bf16 per train step: kernel {dx_ms:.4f} ms (13 "
        f"launches, {ops / dx_ms / 1e9:.1f} TFLOP/s useful), plain "
        f"{plain_ms:.4f} ms, cuDNN bf16 on the concatenated input "
        f"{lib_ms:.4f} ms; bound {ops} FLOP -> {ops_ms:.4f} ms, {nbytes} "
        f"bytes -> {bytes_ms:.4f} ms; dW (torch ops) {dw_ms:.4f} ms per "
        "step")
    row = {"name": "subm_ext_conv_dx", "route": "cuda",
           "source": "coocc_tpu_torch/csrc/subm_conv.cu",
           "replaces": "coocc_tpu/ops/pallas/subm_conv.py:107 (its VJP, "
                       "which JAX takes through coocc_tpu/nn/"
                       "sparse_enc_packed.py:431-433)",
           "launches": launches["subm_ext_conv_dx"], "max_abs_err": max_err,
           "ms": dx_ms, "plain_ms": plain_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "library_ms": lib_ms, "dtype": "bfloat16", "dW_ms": dw_ms}
    del trainer, model, before, after
    torch.cuda.empty_cache()
    return launches, row


def phase_tiny_train_agreement():
    """One tiny-config train step (fp32, dropout off, one set of cascade
    priorities) on the card against the CPU, the route the tests hold
    against JAX: with K2 swapped for an fp32 conv at the encoder's seam,
    the raw loss terms to 1e-3, the moved BN statistics to 1e-3 of their
    scale, the gradients under tests/test_torch_train.py's aggregate rule
    (median leaf within 6% of its scale, 90th percentile within 20%); with
    K2 (the card's kernel and its dX), the raw losses within 5%."""
    import dataclasses as dc
    import numpy as np
    import torch
    from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
    from coocc_tpu_torch.entry import build_model
    from coocc_tpu_torch.models.losses import compute_losses
    from coocc_tpu_torch.nn import sparse_enc_packed
    from coocc_tpu_torch.nn.layers import Dropout
    from coocc_tpu_torch.ops.subm_conv import subm_conv_unrounded
    cfg = tiny_config()
    raw_cfg = dc.replace(cfg, loss_norm=False)
    n = math.prod(cfg.lss_grid_size)
    prio = torch.rand((1, n), generator=torch.Generator().manual_seed(0))
    runs = {}
    inner = sparse_enc_packed.subm_conv
    for swap in (True, False):
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, dev, seed=7).train()
            for m in model.modules():
                if isinstance(m, Dropout):
                    m.p = 0.0
            batch = synthetic_batch(cfg, batch_size=1, seed=3).to(dev)
            if swap:
                sparse_enc_packed.subm_conv = subm_conv_unrounded
            try:
                outs = model(batch, fine_priorities=prio.to(dev))
                raw = compute_losses(outs, batch, raw_cfg)
                sum(v for k, v in compute_losses(outs, batch, cfg).items()
                    if k.startswith("loss")).backward()
            finally:
                sparse_enc_packed.subm_conv = inner
            runs[(swap, dev)] = (
                {k: float(v.detach()) for k, v in raw.items()},
                {k: p.grad.cpu() for k, p in model.named_parameters()
                 if p.grad is not None},
                {k: v.cpu() for k, v in model.state_dict().items()
                 if "running" in k})
    (la, ga, sa), (lb, gb, sb) = runs[(True, "cpu")], runs[(True, "cuda")]
    worst_loss = max(abs(lb[k] - la[k]) / abs(la[k]) for k in la)
    worst_stat = max(float((sb[k] - sa[k]).abs().max())
                     / float(sa[k].abs().max()) for k in sa)
    rel = np.array([float((gb[k] - g).abs().max()) / float(g.abs().max())
                    for k, g in ga.items() if float(g.abs().max()) > 0])
    lk = runs[(False, "cuda")][0]
    k2_loss = max(abs(lk[k] - runs[(False, "cpu")][0][k]) / abs(la[k])
                  for k in la)
    log(f"tiny train step, cuda vs cpu (fp32, K2 as fp32 conv): raw losses "
        f"worst rel {worst_loss:.6g}, BN statistics worst {worst_stat:.6g}"
        f" of scale, gradient leaves median {np.median(rel):.6g} and 90th "
        f"percentile {np.quantile(rel, 0.9):.6g} of scale ({len(rel)} "
        f"leaves); with K2: raw losses worst rel {k2_loss:.6g}")
    if not (worst_loss <= 1e-3 and worst_stat <= 1e-3
            and np.median(rel) <= 0.06 and np.quantile(rel, 0.9) <= 0.2
            and k2_loss <= 5e-2 and len(rel) > 250):
        raise AssertionError("the tiny train step differs between the card "
                             "and the CPU")


# launches in the loop phase: 2 train steps (13 forward + 13 dX each) and
# the eval hook's 2 forwards
PER_LOOP = {"window_knn": 2 * 4, "subm_ext_conv": 13 * 4,
            "subm_ext_conv_dx": 13 * 2, "knn2": 0}
# the eval repeats bit for bit on the card (the lift-splat sums each
# voxel's points in sorted order, ops/lift_splat.py): the in-memory model's
# eval forwards, repeated, give equal logits, each repeat of the eval the
# loop's own hists, and the test CLI's eval of the work dir (the same
# weights and batches) the loop's hists, and so its metrics, exactly.
LOOP_REPEATS = 2


def phase_loop(kernels):
    """The flagship through the epoch loop (train/loop.py:train) at full
    width in its config's bf16: 1 epoch of 2 steps (synthetic seeds 0-1)
    and the eval hook on seeds 1000-1001, from flax's initial weights, into
    a temporary work dir, with the kernels' counts set to 0 before it and
    read after it (PER_LOOP); each step's and eval batch's ms (host clock,
    synced at each batch), the eval summary, the checkpoint's bytes and its
    save and restore seconds. The checkpoint restored into a fresh model
    and optimizer is bit-equal to the trained ones. The in-memory model's
    eval forwards repeat bit for bit, and LOOP_REPEATS evals of it and the
    test CLI's evaluate_checkpoint on the work dir and the same 2 batches
    each give the loop's own eval hists. -> launches."""
    import tempfile
    import torch
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import FLAGSHIP, Trainer
    from coocc_tpu_torch.parallel.train_step import eval_step
    from coocc_tpu_torch.test.__main__ import evaluate_checkpoint
    from coocc_tpu_torch.train import loop
    from coocc_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
    cfg = get_config(FLAGSHIP)
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, max_epochs=1))
    train_b = [synthetic_batch(cfg, batch_size=1, seed=i).to("cuda")
               for i in range(2)]
    val_b = [synthetic_batch(cfg, batch_size=1, seed=1000 + i).to("cuda")
             for i in range(2)]

    def timed(batches, ms):
        """An iterator over batches that records the ms from handing each
        out to being asked for the next (the loop's work on it)."""
        def it():
            for b in batches:
                sync()
                t0 = time.perf_counter()
                yield b
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
        return it

    saved, seen = [], {}

    class TimedCheckpoints(CheckpointManager):
        def save(self, *a, **k):
            t0 = time.perf_counter()
            super().save(*a, **k)
            saved.append(time.perf_counter() - t0)

    def keep_sums(*a, **k):
        seen["sums"] = inner_sums(*a, **k)
        return seen["sums"]
    inner_ckpt, inner_sums = loop.CheckpointManager, loop.sum_eval_hists
    step_ms, eval_ms = [], []
    with tempfile.TemporaryDirectory() as d:
        wd = os.path.join(d, "work_dir")
        loop.CheckpointManager, loop.sum_eval_hists = TimedCheckpoints, \
            keep_sums
        for k in kernels.values():
            k.launches = 0
        try:
            t0 = time.perf_counter()
            trainer = loop.train(cfg, timed(train_b, step_ms),
                                 timed(val_b, eval_ms), steps_per_epoch=2,
                                 work_dir=wd, seed=0, log_interval=1,
                                 device="cuda")
            sync()
            wall = time.perf_counter() - t0
        finally:
            loop.CheckpointManager, loop.sum_eval_hists = inner_ckpt, \
                inner_sums
        launches = {n: k.launches for n, k in kernels.items()}
        log(f"loop launches (2 train steps, 2 eval batches): {launches}")
        if launches != PER_LOOP:
            raise AssertionError(f"loop launches {launches}, want "
                                 f"{PER_LOOP}")
        if trainer.model.dtype != torch.bfloat16:
            raise AssertionError(f"the loop trained in {trainer.model.dtype}")
        with open(os.path.join(wd, "ckpt_meta.json")) as f:
            summary = json.load(f)["metrics"]["0"]
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            records = [json.loads(ln) for ln in f]
        for r in records:
            if r["kind"] == "train":
                if not all(math.isfinite(v) for k, v in r.items()
                           if isinstance(v, float)):
                    raise AssertionError(f"loop: {r}")
        state = os.path.join(wd, "epoch_0", STATE_FILE)
        nbytes = os.path.getsize(state)
        linked = os.path.samefile(state, os.path.join(wd, "best",
                                                      STATE_FILE))
        log(f"loop: {wall:.3f} s in all (model build and init_flax "
            f"included); step ms {[round(t, 3) for t in step_ms]}; eval ms "
            f"per batch {[round(t, 3) for t in eval_ms]}")
        log("loop eval summary: " + ", ".join(
            f"{k} {summary[k]:.6g}" for k in (
                "SC_IoU", "SSC_mIoU", "SSC_mIoU_fine", "lidarseg_mIoU")))
        log(f"loop checkpoint: {nbytes} bytes (epoch_0/{STATE_FILE}; "
            f"best/ hard-linked: {linked}), saved in {saved[0]:.3f} s")
        if not (len(step_ms) == len(eval_ms) == 2 and len(saved) == 1
                and linked):
            raise AssertionError("the loop did not take 2 steps, 2 eval "
                                 "batches and 1 save")

        # restore into a fresh model and optimizer: bit-equal
        fresh = Trainer(cfg, "cuda", seed=1, steps_per_epoch=2)
        sync()
        t0 = time.perf_counter()
        tree, epoch = CheckpointManager(wd).restore(map_location="cuda")
        fresh.model.load_state_dict(tree["model"])
        fresh.optimizer.load_state_dict(tree["optimizer"])
        sync()
        restore_s = time.perf_counter() - t0
        del tree
        got, want = fresh.model.state_dict(), trainer.model.state_dict()
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        go, wo = fresh.optimizer.state_dict(), trainer.optimizer.state_dict()
        for i, s in wo["adamw"]["state"].items():
            for k, v in s.items():
                if not torch.equal(go["adamw"]["state"][i][k], v):
                    bad.append(f"adamw state {i}/{k}")
        if go["schedule"] != wo["schedule"] or epoch != 0:
            bad.append("schedule")
        log(f"loop checkpoint restored in {restore_s:.3f} s: "
            f"{len(want)} model tensors, {len(wo['adamw']['state'])} AdamW "
            f"states, schedule count {go['schedule']['last_epoch']}; "
            f"{len(bad)} differ")
        if bad:
            raise AssertionError(f"the restored checkpoint differs: "
                                 f"{bad[:5]}")
        del fresh, got, go, want, wo
        torch.cuda.empty_cache()

        model = trainer.model
        ndiff = 0
        for batch in val_b:
            a, b = (eval_step(model, batch, cfg) for _ in range(2))
            ndiff += sum(int((a[k] != b[k]).sum())
                         for k in ("occ_logits", "fine_logits"))
        repeats = [loop.sum_eval_hists(model, cfg, iter(val_b), 2)
                   for _ in range(LOOP_REPEATS)]
        del model, trainer
        # the test CLI's function on the same work dir and batches
        cli, sums = evaluate_checkpoint(cfg, wd, lambda: iter(val_b),
                                        "cuda", max_steps=2)
    loop_sums = seen["sums"]

    def hist_l1(a):
        return {k: int(abs(a[k] - loop_sums[k]).sum()) for k in loop_sums}
    ious = ("SC_IoU", "SSC_mIoU", "SSC_mIoU_fine", "lidarseg_mIoU")
    log(f"eval of the in-memory model: {ndiff} logits differ between two "
        f"forwards; hist L1 of {LOOP_REPEATS} repeats against the loop's "
        f"own eval: {[hist_l1(x) for x in repeats]}")
    log(f"test CLI vs the loop's eval: hist L1 {hist_l1(sums)}, metric "
        f"moves {({k: cli[k] - summary[k] for k in ious})}")
    if ndiff or any(set(x) != set(loop_sums) or any(hist_l1(x).values())
                    for x in [sums] + repeats):
        raise AssertionError("an eval of the trained weights, repeated or "
                             "through the test CLI, differs from the "
                             "loop's")
    torch.cuda.empty_cache()
    return launches


def phase_bench():
    """`python -m coocc_tpu_torch.bench` once (BENCH_ITERS=3, its default
    bf16), in a process of its own; its JSON line is logged behind a
    prefix."""
    proc = subprocess.run(
        [sys.executable, "-m", "coocc_tpu_torch.bench"], cwd=ROOT,
        env={**os.environ, "BENCH_ITERS": "3"}, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the bench failed: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    if len(lines) != 1 or result["dtype"] != "bf16" or not (
            result["value"] > 0 and result["unit"] == "frames/sec"
            and "power_limit" in result["device"]):
        raise AssertionError(f"the bench printed {proc.stdout!r}")
    log(f"bench (python -m coocc_tpu_torch.bench, BENCH_ITERS=3): "
        f"{lines[-1]}")


def phase_tiny_agreement():
    """The tiny config on the card against the CPU, with the dense encoder
    (fp32 throughout: 5e-3) and the default packed one (full outputs at
    5e-3; pts_voxel at the bf16 bounds above, K2's roundings on the two
    devices compounding apart); and the packed one in bf16."""
    import numpy as np
    import torch
    from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
    from coocc_tpu_torch.entry import build_model
    for impl in ("dense", "auto"):
        cfg = tiny_config()
        cfg = dataclasses.replace(cfg, pts=dataclasses.replace(cfg.pts,
                                                               impl=impl))
        outs = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, dev, seed=7)
            batch = synthetic_batch(cfg, batch_size=1, seed=3).to(dev)
            out = dict(model(batch))
            out["pts_voxel"] = model(batch, stop_at="pts")["pts_voxel"]
            outs[dev] = {k: v.cpu().numpy() for k, v in out.items()}
        a, b = outs["cpu"], outs["cuda"]
        np.testing.assert_allclose(b["occ"], a["occ"], **TOL)

        def by_coord(o):
            return {tuple(c): l for c, l, v in zip(
                o["fine_coords"][0], o["fine_logits"][0],
                o["fine_valid"][0]) if v}
        fa, fb = by_coord(a), by_coord(b)
        if set(fa) != set(fb):
            raise AssertionError(f"tiny {impl}: refined cells differ "
                                 "between cpu and cuda")
        for c in fa:
            np.testing.assert_allclose(fb[c], fa[c], **TOL)
        scale = np.abs(a["pts_voxel"]).max()
        err = np.abs(b["pts_voxel"] - a["pts_voxel"])
        if impl == "dense":
            np.testing.assert_allclose(b["pts_voxel"], a["pts_voxel"], **TOL)
        elif not (err.max() <= PACKED_VS_DENSE_MAX * scale
                  and err.mean() <= PACKED_VS_DENSE_MEAN * scale):
            raise AssertionError(f"tiny packed pts_voxel: cuda vs cpu "
                                 f"{err.max()} (scale {scale})")
        log(f"tiny config ({impl} encoder) cuda vs cpu: occ and {len(fa)} "
            f"fine rows agree (atol=rtol=5e-3); pts_voxel max_abs_err "
            f"{err.max():.6g}, mean {err.mean():.6g}, scale {scale:.6g}")
    # bf16: the card's bf16 occ against the CPU's (the route the tests hold
    # against JAX's bf16), within the rule the tests use: 2x (max) and
    # 1.5x (mean) the CPU's own bf16-vs-fp32 drift
    cfg = tiny_config()
    occ = {}
    for dev, dt in (("cpu", None), ("cpu", torch.bfloat16),
                    ("cuda", torch.bfloat16)):
        model = build_model(cfg, dev, seed=7, dtype=dt)
        batch = synthetic_batch(cfg, batch_size=1, seed=3).to(dev)
        occ[(dev, dt)] = model(batch)["occ"].float().cpu().numpy()
    ref = occ[("cpu", torch.bfloat16)]
    own = np.abs(ref - occ[("cpu", None)])
    card = np.abs(occ[("cuda", torch.bfloat16)] - ref)
    log(f"tiny config bf16, cuda vs cpu: occ max |diff| {card.max():.6g}, "
        f"mean {card.mean():.6g}; the cpu's bf16-vs-fp32 drift max "
        f"{own.max():.6g}, mean {own.mean():.6g}")
    if not (card.max() <= 2.0 * own.max()
            and card.mean() <= 1.5 * own.mean()):
        raise AssertionError("tiny bf16: the card's occ differs from the "
                             "cpu's by more than bf16 noise")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    t0 = time.perf_counter()
    sys.path.insert(0, ROOT)
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import FLAGSHIP
    from coocc_tpu_torch.ops._build import load_all_kernel_libraries
    from coocc_tpu_torch.ops.knn import knn2
    from coocc_tpu_torch.ops.subm_conv import subm_ext_conv, subm_ext_conv_dx
    from coocc_tpu_torch.ops.window_knn import window_knn

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False (fp32 is fp32)")

    for name, secs in sorted(load_all_kernel_libraries().items()):
        log(f"build csrc/{name}.cu: {secs:.2f} s (nvcc, sm_90a, in "
            "parallel)")

    kernels = {"window_knn": window_knn, "subm_ext_conv": subm_ext_conv,
               "subm_ext_conv_dx": subm_ext_conv_dx, "knn2": knn2}
    cfg = get_config(FLAGSHIP)
    requests = [synthetic_batch(cfg, batch_size=1, seed=s).to("cuda")
                for s in range(3)]
    log(f"[{time.perf_counter() - t0:.1f} s] main path, bf16 (the config's "
        "compute_dtype, as served):")
    launches, outs16, masks16, k2_err, k2_times16 = phase_bf16_path(
        kernels, cfg, requests)
    if any(launches[n] == 0 for n, per in PER_REQUEST.items() if per):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    log("knn2 has no caller on the main path (none in the JAX package "
        "either): 0 launches per forward; its entry point is knn2()")
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t0:.1f} s] main path, fp32 (entry.entry(), "
        "the JAX entry's twin):")
    model, launches32, masks, outs32 = phase_main_path(kernels, requests)
    check_bf16_masks(masks16, masks)
    check_bf16_drift(outs16, outs32)
    del outs16, outs32
    log(f"[{time.perf_counter() - t0:.1f} s] dense path:")
    phase_dense_path(model, requests)
    log(f"[{time.perf_counter() - t0:.1f} s] kernels against their plain "
        "versions:")
    k1_row = phase_window_knn(model, masks, launches32)
    k2_err32, k2_times32 = phase_subm_conv(model, requests)
    k3_row = phase_knn2(masks, launches32)
    del model, requests
    torch.cuda.empty_cache()
    # the kernels' rows describe the served (bf16) path; K2's fp32
    # instantiation, which entry() runs, is kept beside it
    k2_row = {"name": "subm_ext_conv", "route": "cuda",
              "source": "coocc_tpu_torch/csrc/subm_conv.cu",
              "replaces": "coocc_tpu/ops/pallas/subm_conv.py:53",
              "launches": launches["subm_ext_conv"], "max_abs_err": k2_err,
              **k2_times16, "dtype": "bfloat16",
              "fp32": {"launches": launches32["subm_ext_conv"],
                       "max_abs_err": k2_err32, **k2_times32}}
    rows = [k1_row, k2_row, k3_row]
    for row in (k1_row, k3_row):
        row["launches"] = launches[row["name"]]
    log(f"[{time.perf_counter() - t0:.1f} s] bench and tiny config:")
    phase_bench()
    phase_tiny_agreement()
    log(f"[{time.perf_counter() - t0:.1f} s] real-shape parity against JAX's "
        "fingerprint:")
    phase_real_shape_parity()
    log(f"[{time.perf_counter() - t0:.1f} s] train path (bf16, the config's "
        "compute_dtype):")
    train_launches, dx_row = phase_train(kernels)
    for row in (k1_row, k2_row):
        row["train_launches"] = train_launches[row["name"]]
    rows.insert(2, dx_row)
    phase_tiny_train_agreement()
    log(f"[{time.perf_counter() - t0:.1f} s] the epoch loop (bf16, eval hook, "
        "checkpoint, test CLI):")
    loop_launches = phase_loop(kernels)
    for row in rows:
        row["loop_launches"] = loop_launches[row["name"]]

    log(f"[{time.perf_counter() - t0:.1f} s] card: {card_line()}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
