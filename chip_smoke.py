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
     weights' and batch's digests, then the card's fp32 outputs at every
     prefix within 2x (max) and 1.5x (mean) of the CPU port's own distance
     to JAX (`parity.check`) and its bf16 ones within 2x / 1.5x of JAX's
     own bf16-vs-fp32 drift (`parity.check_drift`, the C9 rule of every
     fingerprint; the CPU port's yardstick logged beside); the flagship on
     pts.impl="gather" against parity/flagship_gather_real.npz the same
     way, its pts prefix with the eval cap binding (120,000 sites at level
     1) and the sites each strided level kept equal to JAX's; one train
     step of the flagship at full width (dropout off, the cascade on the
     fingerprint's priorities) in fp32 and bf16 against
     parity/flagship_train_real.npz (phase_train_fingerprint: the loss
     terms, outputs and refined cells row by row, the moved statistics,
     gradient leaves and sums pooled, `parity.train.check`);
  9. train path: the train step of every shipped config the port trains
     (TRAIN_CONFIGS: the flagship, coocc_lidar, OpenOccupancy,
     coocc_multi_r101_896x1600, coocc_cam_r101_896x1600, the stereo
     flagship) at full width in
     its config's bf16 (entry.train_steps), a warm-up step then 3 steps
     with the counts set to 0 before them and read after them (per step,
     PER_TRAIN_STEP_OF: window_knn 2, subm_ext_conv 13, subm_ext_conv_dx
     13 for the z-packed encoder's configs; 0, 16, 16 for coocc_lidar; none
     for the camera-only model), times, peak memory, a profiled step,
     finite losses (loss_depth_render among them), moved parameters and
     every BN statistic; for the flagship, coocc_lidar and OpenOccupancy,
     K2's mask-only forward and its dX on one step's own inputs (16 each in
     coocc_lidar, 4 at Co = 16 on stage 0's [1,9,800,800,128]) against
     their plain versions, with their times, bound and cuDNN's, and dW's
     time; for the stereo config, whose LiDAR shapes are the flagship's,
     the step's first K2 forward and first dX against their plain versions
     (not timed again); the flagship's train CLI (`python -m
     coocc_tpu_torch.train coocc_multi_r50_256x704 --synthetic
     --steps-per-epoch 1 --max-epochs 1`, its eval hook and checkpoint) in
     a process of its own; then a tiny train step on the card against the
     CPU. For the flagship and coocc_lidar (C8_CONFIGS) two more steps
     from one state, generator and batch (the leaves that differ between
     them: none may differ) and the kernels of one step (no upsample
     kernel may run), with coocc_tpu_torch/tools/train_repeat.py's helpers
     (the tool also times the repaired sites against what they replace
     and names an op that still differs); for the flagship, the
     data-parallel step over an NCCL group of one against the
     single-device step, bit for bit (both under
     torch.use_deterministic_algorithms while the step does not repeat);
 10. the epoch loop (train/loop.py:train, the train CLI's function): the
     flagship in bf16 from flax's initial weights, 1 epoch of 2 steps and
     the eval hook on 2 batches, with the counts set to 0 before it and
     read after it (window_knn 8, subm_ext_conv 52, subm_ext_conv_dx 26);
     step and eval times, the SSC summary, the checkpoint's bytes and save
     and restore times; the restored checkpoint bit-equal to the trained
     state; the eval repeated bit for bit, and the test CLI's eval of the
     work dir equal to the loop's.
 11. OpenOccupancy (coocc_multi_r101_openoccupancy) at full width as
     served (bf16): 6x896x1600 images through ResNet-101, 350,000 LiDAR
     points on the 1024x1024x80 grid, the 128x128x10 fuser grid with its
     windows (8,8,9)/(6,6,7), cascade ratio 4 (20,000 cells x 64
     children) onto 512x512x40; 3 requests with the counts set to 0
     before them and read after them (window_knn 2, subm_ext_conv 13 a
     request), times, device busy and peak memory; K1 against its plain
     version on the model's masks with both windows (exact), every K2 call
     of a pts prefix against its plain version on its own inputs (res1
     [1,10,512,512,128]), K2's times and bound at those shapes; eval_step
     with a visible mask; the fp32 and bf16 forwards against
     parity/openocc_real.npz; the test CLI (`python -m
     coocc_tpu_torch.test coocc_multi_r101_openoccupancy --synthetic
     --max-steps 2`, its table and eval ms a batch) in a process of its
     own and the bench (BENCH_CONFIG=coocc_multi_r101_openoccupancy, its
     main() in this process);
 12. coocc_multi_r101_896x1600 and coocc_cam_r101_896x1600 at full width
     as served: 3 requests each (K1 2 and K2 13 a request, and none for
     the camera-only model), their outputs checked, times, device busy
     and peak memory.
 13. coocc_lidar, the LiDAR-only model, at full width as served (bf16):
     350,000 points (245,000 valid) voxelized with their means onto the
     800x800x65 grid at the 120,000-voxel eval cap, the HD encoder (K2 at
     p = 8, 4, 2, 1, bz = 9; stage 0 [1,9,800,800,128] at Co = 16),
     SECOND3D and its FPN, the semantic stack and the head on 100x100x8
     without the cascade; 3 requests (K2 16 launches a request, K1 none),
     times, device busy and its share, peak memory, device time by prefix;
     every K2 call of a pts prefix against its plain version (4 each at
     Co = 16, 32, 64, 128), K2 on random inputs at those levels in fp32
     and bf16 and every epilogue, its times and bound there; the fp32 and
     bf16 forwards against parity/lidar_real.npz; its data path at real
     size: a nuScenes tree written from a seed (coocc_tpu_torch/tools/
     nuscenes_tree.py: 3 train and 2 val keyframes of 34,720 points with
     10 sweeps each, 381,920 points past the 350,000 capacity, SurroundOcc
     ground truth, lidarseg labels, six cameras' calibration, no image),
     get_sample's ms per sample and collate's, no PIL imported, the served
     model on a loaded batch (K2 16 launches, its first call against its
     plain version), then the train CLI (`--data-root ... --steps-per-epoch
     2 --max-epochs 1`: finite losses, K2 16 and its dX 16 a step, the
     loop's wait for each batch against its step, the checkpoint, the eval
     hook's lidarseg metric) and the test CLI (`--max-steps 2
     --save-by-scene --pred-save`: the SC/SSC and lidarseg tables, one
     prediction file per token) in processes of their own; the bench
     (its main() in this process).
 14. coocc_multi_r50_256x704_stereo, the flagship with BEVStereo depth, at
     full width as served (bf16): the previous keyframe's 6 images through
     the shared R50's stage 0 and 12 plane-sweep warps of [6, 3, 64, 176,
     256]; 3 requests (K1 2, K2 13 launches each), device busy and peak
     memory, the stereo depth net's device time with and without its EM
     rounds (the plane sweep's share); K1 and K2 each on one call of the
     path against their plain versions; the fp32 and bf16 forwards against
     parity/stereo_real.npz; the bench (its main() in this process)
     and the test CLI in a process of its own.
 15. coocc_kitti's img and pts prefixes at full width (one 384x1280 camera
     through R50 with the 30-d camera vector of KITTI's 3x4 intrinsics;
     350,000 points, 245,000 valid, on the 512x512x64 LiDAR grid), from
     its fingerprint's numpy weights, in bf16 and fp32: 3 runs each with
     K2's 13 launches counted (K1 none), host and device busy ms, every
     K2 call against its plain version, the full forward's ValueError
     (its LiDAR grid is not its fuser's, as JAX's fails), both prefixes
     held to parity/kitti_real.npz, K2's times and bound at its shapes;
 16. eval-time rendering: the flagship as served (bf16) with
     render.test_rendering, 3 eval_step requests (K1 2, K2 13 each) beside
     the same without rendering (host ms, busy ms, peak memory), the
     rendered views' shapes and ranges, evaluate's render_PSNR and
     render_SSIM over 2 batches, one camera's render on the card against
     the CPU's on the same voxel_feats, and the test CLI with
     --test-rendering in this process.
 17. data parallelism (run after phase 10): the flagship's train step at
     full width (bf16) over 2 ranks, spawned processes that share the
     card through gloo (NCCL refuses two ranks on one device; NCCL across
     2 cards where the host has them), 3 steps on synthetic_batch(cfg,
     batch_size=2, seed=i) split by rows: K1 2 / K2 13 / K2's dX 13
     launches a step on each rank, both ranks bit-equal after each step,
     ms a step, device busy, the gradient all-reduce's bytes and ms, the
     all-reduces a step (SyncBN's), peak memory a rank; SyncBN on the
     first BatchNorm's real input against one process's BatchNorm on the
     concatenated batch; the 2-rank eval's hists against one process's of
     the same two samples.
 18. the LiDAR encoder's other routes (phase_lidar_routes), each model
     built on the card from the served weights: the flagship with
     pts.impl="gather" (the gather-GEMM SparseLiDAREnc8x, fp32 inside the
     bf16 model) served (3 requests, K1 2 and K2 0 launches each, request
     and busy ms, the pts stage's device time by kernel, peak memory, the
     voxel cap's and each strided level's drops, the synchronizing calls
     of a forward: tools/host_profile.py:sync_sites), its fp32 pts_voxel
     against the dense and packed routes' on a request of its first
     12,000 points (no cap binds), its bf16 train step (K1 2, K2 0 a
     step, C8: two steps from one state equal bit for bit); the
     flagship's train step on pts.impl="dense" (the masked BatchNorm over
     each level's active cells); coocc_lidar with pts.impl="gather"
     (SparseEncoderHD's rulebook form) served and trained (no K1 or K2);
     SparseLiDAREnc4x as a module on the 800x800x64 grid at
     max_voxels_test (its output 200x200x16: the model raises at the
     fuser grid, as JAX's fuser fails).
 19. the Swin route (phase_swin): the flagship with img_backbone
     SwinTransformer (Swin-T: embed 96, depths (2, 2, 6, 2), heads (3, 6,
     12, 24), window 7; every stage pads its tokens at 256x704), built by
     dataclasses.replace as JAX's tests/test_swin_model.py builds it,
     served in bf16 (3 requests, K1 2 and K2 13 launches each, request and
     busy ms, the img prefix's busy ms, peak memory), K1 and K2 on one
     call each against their plain versions, 3 bf16 train steps (K1 2, K2
     13, K2's dX 13 a step) and C8 (two steps from one state equal bit for
     bit);
 20. the card's fp32 Swin-T on one 256x704 camera against JAX's
     fingerprint (coocc_tpu_torch/parity/swin_real.npz), its digests
     first;
 21. the envelope's other modules (phase_modules), each once on the card
     against the same module on the host's CPU in fp32 (within 1e-4 of
     the scale), with its device time: EfficientNet-b0 on 6x3x256x704,
     SECONDFPN2, GeneralizedLSSFPN and FPNRender on the R50 pyramid of a
     6x256x704 request, AddFuser, AttnFuser, TemporalBEVConcat and
     OccupancyEncoder on [1, 128, 100, 100, 8], MoE on 80,000 tokens of
     128, FLoSP of a 128x16x44 feature into the 200x200x16 grid;
 22. the rest of the envelope (phase_envelope), fp32, card against host
     within 1e-4 of the scale, device ms a call: MSDeformAttn3D on
     80,000 queries over the flagship's 100x100x8 fuser grid and two
     coarser levels; Image2BEVTransformer (3 layers timed, 1 layer held
     against the host) on six cameras' 256-channel maps at strides 8-64
     of 256x704 and the synthetic request's calibration; two backward
     passes of each bit-equal, peak memory; Mask2FormerOccHead on the
     200x200x16 pyramid, every stage, and forward_lidarseg of 245,000
     points; render_rays of 4,224 rays (112 + 32 samples); torch.profiler
     by kernel of the transformer and the head; the native host library
     against its numpy versions on the request's cloud.
 23. the lane-major route (phase_lane_major): the flagship's
     PackedLiDAREnc8x alone at 800x800x36 (the synthetic request's points
     with 36 voxels in z), whose res1 (p = 3, 96 lanes) and res2 (p = 1,
     64 lanes) take the narrow SubM route (`subm_conv_narrow`, cuDNN) and
     whose down2 and down3 take the lane-major stride-2 conv: fp32 and
     bf16 served (K2 5 and the narrow route 8 launches a forward, ms a
     forward), the fp32 output against the dense twin's on the sites below
     level-0 z slice 25 (PACKED_VS_DENSE_MAX / _MEAN), the bf16 output's
     distance to fp32 logged, two bf16 train steps of the encoder from one
     state equal bit for bit (K2 5, its dX 5, the narrow route 8 a step);
     every K2 call of a forward in each dtype and of a third step (its dX
     calls too) against its plain version on the call's own inputs.
The real-shape parity phases' numpy weights are drawn and hashed in a
background thread from phase 4 on (ParityWeights).
Prints the card, the kernels' JSON line (the served bf16 path's launches
and K2 times, K2's fp32 ones beside them; the train path's launches by
config, K2's mask-only forward in training by config ("train"), and K2's
dX row, the flagship's with the other configs' under "configs"; the loop's
launches; K1's and K2's numbers at OpenOccupancy's shapes, K2's at
coocc_lidar's (with its data path's launches and one-call check) and
coocc_kitti's, the stereo path's launches and one-call checks, the
render path's launches, the LiDAR routes' ("routes") and the Swin
route's ("swin"), under "configs"; each rank's
launches in the data-parallel steps under "data_parallel") and, last, the
result line.
Needs a CUDA card and the repository around it; it imports nothing of
JAX.
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


def has_cascade(cfg) -> bool:
    head = cfg.occ_head
    return head.cascade_ratio != 1 and (head.sample_from_voxel
                                        or head.sample_from_img)


def check_outputs(out, cfg):
    """The eval outputs' shapes and finite values: occ, and the cascade's
    where the config has one (coocc_lidar's model returns occ alone)."""
    import torch
    X, Y, Z = cfg.lss_grid_size
    rows = cfg.occ_head.max_coarse_occupied * cfg.occ_head.cascade_ratio ** 3
    want = {"occ": (1, X, Y, Z, cfg.num_classes)}
    if has_cascade(cfg):
        want.update({"fine_logits": (1, rows, cfg.num_classes),
                     "fine_coords": (1, rows, 3), "fine_valid": (1, rows)})
    if set(out) - {"fine_overflow"} != set(want):
        raise AssertionError(f"outputs {sorted(out)}, want {sorted(want)}")
    for k, shape in want.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(
                f"{k}: shape {tuple(out[k].shape)} != {shape}")
    for k in ("occ", "fine_logits"):
        if k in out and not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{k} has non-finite values")
    if "fine_valid" in out and int(out["fine_valid"].sum()) == 0:
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


def serve_requests(model, requests, kernels, per_request, keep=True):
    """One warm-up forward, then the requests with the kernels' launch
    counts set to 0 before them and read after them (and per request:
    `per_request` each), each request's outputs checked (check_outputs);
    per-request times and peak memory. -> (launches, the request ms, peak
    bytes, with `keep` the requests' outputs on the host)."""
    import torch
    cfg = model.cfg
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
        if grew != per_request:
            raise AssertionError(f"request {i}: launches {grew}, want "
                                 f"{per_request}")
        fine = (f", fine_valid {int(out['fine_valid'].sum())}, "
                f"fine_overflow {int(out['fine_overflow'].sum())}"
                if "fine_valid" in out else "")
        log(f"request {i} (seed {i}): {req_ms[-1]:.3f} ms{fine}")
        if keep:
            outs.append({k: v.cpu() for k, v in out.items()})
        del out
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"{cfg.name} launches: {launches}")
    log(f"request ms: {[round(t, 3) for t in req_ms]} "
        f"(median {statistics.median(req_ms):.3f})")
    log(f"peak memory allocated: {peak / 2**30:.3f} GiB")
    return launches, req_ms, peak, outs


def drive_main_path(model, requests, kernels, stages=True):
    """serve_requests (PER_REQUEST), then device time by kernel of the full
    forward and, with `stages`, per-stage times and the pts stage's device
    time by kernel. -> (launches, the requests' outputs on the host, K1's
    two masks of request 0)."""
    from coocc_tpu_torch.models.coocc_ray import STAGES
    from coocc_tpu_torch.nn.sparse_enc_packed import PackedLiDAREnc8x
    if type(model.pts_middle_encoder) is not PackedLiDAREnc8x:
        raise AssertionError("the flagship does not run the packed encoder")
    launches, _, _, outs = serve_requests(model, requests, kernels,
                                          PER_REQUEST)

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
    host wall time. Kernels run on one stream, so their times add up.
    -> device busy ms per input (None where the profiler saw no device
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    # the device's activity only: the host's ops would add their events
    # to trace and sort, seconds a train step, and no number reads them
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        return None
    n = len(inputs)
    log(f"  wall {wall / n:.3f} ms per input, device busy {busy / n:.3f} ms "
        f"({100 * busy / wall:.1f}%), {len(by_name)} kernel names")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {ms / n:9.3f} ms  {100 * ms / busy:5.1f}%  {name}")
    return busy / n


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


def k2_levels(calls, dtype, n_calls=PER_REQUEST["subm_ext_conv"]):
    """{(shape, p, Co): {mode: calls}} of one pts prefix's K2 calls
    (`n_calls` of them), each of which must take an x of `dtype`."""
    levels = {}
    for shape, p, Co, dt, mode in calls:
        if dt != dtype:
            raise AssertionError(f"main path K2 input is {dt}, not {dtype}")
        counts = levels.setdefault((shape, p, Co), dict.fromkeys(K2_MODES, 0))
        counts[mode] += 1
    log(f"subm_ext_conv main-path calls per forward ({str(dtype)[6:]}): "
        f"{[(s, p, Co, n) for (s, p, Co), n in levels.items()]}")
    if len(calls) != n_calls:
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
    from coocc_tpu_torch.ops.subm_conv import (epilogue_plain,
                                               ext_conv_plain,
                                               subm_ext_conv,
                                               subm_ext_weight)
    got = subm_ext_conv(x, w27, p, mcell, bn, identity).float()
    # the plain version (subm_ext_conv_plain) with its conv kept: JAX's conv
    # of the bf16-rounded operands, the epilogue, one rounding to x's dtype
    conv = ext_conv_plain(x.float(), subm_ext_weight(w27, p), x.shape[1],
                          x.shape[-1] // p)
    ref = epilogue_plain(conv, mcell, bn, identity).to(x.dtype).float()
    conv_scale = float(conv.abs().max())
    del conv
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
    max_err = max(max_err, k2_random_checks(gen, cases))
    return max_err, k2_times(gen, levels, torch.float32)


def k2_random_checks(gen, cases):
    """K2 against its plain version on random inputs of each case (shape,
    p, Co, name), fp32 and bf16, in every epilogue mode. -> the max abs
    err over the fp32 ones."""
    import torch
    max_err = 0.0
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
            del x, mcell, idn
            torch.cuda.empty_cache()
    return max_err


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
    launches = sum(sum(c.values()) for c in levels.values())
    log(f"subm_ext_conv {str(dtype)[6:]} per forward: fused kernel "
        f"{kernel:.4f} ms ({launches} launches, {ops / kernel / 1e9:.1f} "
        f"TFLOP/s useful), mask-only mode {mask_only:.4f} ms, unfused PyTorch "
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


def _parity_weights(name):
    """Config `name`'s fingerprint weights (parity.fingerprint_model, drawn
    with numpy on the host) and their digest (parity.state_digest's)."""
    from coocc_tpu_torch import parity
    weights = parity.fingerprint_model(parity.fingerprint_config(name),
                                       "cpu").state_dict()
    return weights, parity.digest({k: v.numpy() for k, v in weights.items()})


class ParityWeights:
    """The real-shape parity phases' weights, drawn and hashed in one
    background thread (a daemon: a failed run does not wait for it) in the
    order the phases read them: numpy's draws and sha256 release the
    interpreter lock, so the host's part overlaps the card's work of the
    phases before. take(name) waits for config `name`'s and drops the
    thread's reference to them."""

    def __init__(self, names):
        import threading
        from concurrent.futures import Future
        self.jobs = {n: Future() for n in names}
        threading.Thread(target=self._draw, args=(dict(self.jobs),),
                         daemon=True).start()

    @staticmethod
    def _draw(jobs):
        while jobs:
            name, job = next(iter(jobs.items()))
            del jobs[name]
            t0 = time.perf_counter()
            try:
                job.set_result(_parity_weights(name))
            except BaseException as e:  # raised by take()
                job.set_exception(e)
            log(f"parity weights of {name} drawn and hashed in the "
                f"background in {time.perf_counter() - t0:.1f} s")
            del job

    def take(self, name):
        t0 = time.perf_counter()
        out = self.jobs.pop(name).result()
        log(f"parity weights of {name}: waited {time.perf_counter() - t0:.1f}"
            " s for them")
        return out


def phase_real_shape_parity(name, weights, each=None):
    """Config `name` at real shapes against JAX's fingerprint
    (coocc_tpu_torch/parity/, written on a CPU by
    tests/test_torch_real_shapes.py): the weights' (from `weights`, a
    ParityWeights) and the batch's digests first, then the card's fp32
    (TF32 off) and bf16 forwards: fp32 every prefix within 2x (max) and
    1.5x (mean) of the CPU port's own distance to JAX (`parity.check`),
    bf16 within 2x and 1.5x of JAX's own bf16-vs-fp32 drift
    (`parity.check_drift`, the rule of C9: the CPU port's yardstick is
    logged beside it); both dtypes are read before a failure is raised.
    The weights are
    drawn once (numpy), hashed once, and loaded into both models
    (load_state_dict copies them exactly). A config of parity.PREFIX_ONLY
    is held at that prefix. each(dtype name, model, batch), where given,
    runs on each dtype's model before its capture. -> {dtype: [(name,
    card, yardstick, ok)]}."""
    import torch
    from coocc_tpu_torch import parity
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.models.coocc_ray import CoOccRay
    t0 = time.perf_counter()
    fp = parity.load(name)
    cfg = parity.fingerprint_config(name)
    batch_np = synthetic_batch(cfg, batch_size=1, seed=0)
    if parity.batch_digest(batch_np) != str(fp["batch_digest"]):
        raise AssertionError(f"{name}: the fingerprint's batch digest "
                             "differs")
    batch = batch_np.to("cuda")
    results = {}
    state, digest = weights.take(name)
    if digest != str(fp["state_digest"]):
        raise AssertionError(f"{name}: the fingerprint's state_dict "
                             f"digest differs: {digest}")
    for prefix, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        # built on the card (its default init is fast there); .to() moves
        # the buffers made from numpy (the frustum)
        with torch.device("cuda"):
            model = CoOccRay(cfg, dtype).eval().to("cuda")
        model.load_state_dict(state)
        if each is not None:
            each(prefix, model, batch)
        out = parity.capture(model, batch, parity.PREFIX_ONLY.get(name))
        del model
        torch.cuda.empty_cache()
        ratio = cfg.occ_head.cascade_ratio
        res = parity.check(fp, prefix, out, ratio)
        held = "cpu port"
        if prefix == "bf16":
            # JAX's own drift holds (C9); the CPU port's yardstick is read
            # and logged
            for key, (dmax, dmean), (pmax, pmean), ok in res:
                log(f"real-shape parity {name} {prefix} {key}: card max "
                    f"{dmax:.6g} mean {dmean:.6g}; cpu port max {pmax:.6g} "
                    f"mean {pmean:.6g} ({'within' if ok else 'beyond'} 2x "
                    "/ 1.5x of it; not the bound)")
            res = parity.check_drift(fp, out, ratio, name)
            held = "JAX's own bf16 drift"
        for key, (dmax, dmean), (pmax, pmean), ok in res:
            log(f"real-shape parity {name} {prefix} {key}: card max "
                f"{dmax:.6g} mean {dmean:.6g}; {held} max {pmax:.6g} mean "
                f"{pmean:.6g} ({'ok' if ok else 'FAIL'})")
        results[prefix] = res
    bad = [(prefix, r[0]) for prefix, res in results.items()
           for r in res if not r[3]]
    if bad:
        raise AssertionError(f"{name} outputs differ from JAX's "
                             f"fingerprint: {bad}")
    log(f"real-shape parity {name}: digests equal, fp32 and bf16 within "
        f"the bounds ({time.perf_counter() - t0:.1f} s)")
    return results


def phase_train_fingerprint(weights):
    """The flagship's train step at full width on the card against JAX's
    fingerprint (coocc_tpu_torch/parity/flagship_train_real.npz, written on
    a CPU by tests/test_torch_real_train.py): the weights' and the batch's
    digests, then one step in fp32 (TF32 off) and one in bf16, dropout off,
    the cascade's priorities the fingerprint's (JAX's draw), each read
    whole before a failure is raised (`parity.train.step_arrays`): the raw
    loss terms, the outputs the losses read, the moved BN statistics and
    every gradient leaf, held by `parity.train.check` (each loss term,
    output and the refined cells within 2x / 1.5x of the yardstick, each
    statistic, gradient leaf and sum within a ceiling of
    parity.train.CEILING x it, and pooled: the module note of
    parity.train), the yardstick the CPU port's distance to JAX in fp32
    and JAX's own bf16-vs-fp32 drift in bf16 (the C9 rule). -> {dtype: the
    worst and the pooled rows}."""
    import torch
    from coocc_tpu_torch import parity
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.models.coocc_ray import CoOccRay
    from coocc_tpu_torch.parity import train as ptrain
    t0 = time.perf_counter()
    fp = parity.load(parity.TRAIN)
    cfg = parity.fingerprint_config(parity.TRAIN)
    batch_np = synthetic_batch(cfg, batch_size=1, seed=0)
    state, digest = weights.take(parity.TRAIN)
    if parity.batch_digest(batch_np) != str(fp["batch_digest"]) or \
            digest != str(fp["state_digest"]):
        raise AssertionError("the train fingerprint's digests differ")
    batch = batch_np.to("cuda")
    prio = torch.from_numpy(fp["priorities"]).to("cuda")
    held = {"fp32": "cpu port", "bf16": "JAX's own bf16 drift"}
    results, bad = {}, []
    for prefix, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        with torch.device("cuda"):
            model = CoOccRay(cfg, dtype).to("cuda")
        model.load_state_dict(state)
        sync()
        t1 = time.perf_counter()
        res = ptrain.step_arrays(model, batch, prio)
        step_s = time.perf_counter() - t1
        del model
        torch.cuda.empty_cache()
        rows = ptrain.check(fp, prefix, res)
        del res
        bad += [(prefix, *r[:3]) for r in rows if not r[3]]

        def share(r):
            # the run's max as a share of its bound
            return r[1][0] / max(r[2][0], 1e-30)
        pooled = [r for r in rows if r[0].startswith(("grads ", "stats ",
                                                      "sums "))]
        worst = sorted((r for r in rows if r not in pooled), key=share,
                       reverse=True)[:6]
        for key, (dmax, dmean), (bmax, bmean), ok in worst + pooled:
            log(f"train fingerprint {prefix} {key}: card {dmax:.6g} / "
                f"{dmean:.6g}; bound {bmax:.6g} / {bmean:.6g} "
                f"({'ok' if ok else 'FAIL'})")
        results[prefix] = {"rows": len(rows), "failed": sum(
            not r[3] for r in rows), "worst": [r[:3] for r in worst],
            "pooled": [r[:3] for r in pooled], "step_s": step_s}
        log(f"train fingerprint {prefix}: {len(rows)} rows (the loss terms, "
            f"the samples of {len(fp['out/names'])} outputs, the refined "
            f"cells and fine logits, each of "
            f"{len(fp['stat/names'])} statistics, "
            f"{len(fp['grad/names'])} gradient leaves and their sums, and "
            "those pooled), "
            f"{results[prefix]['failed']} beyond their bound, held by "
            f"{held[prefix]}; the step read in {step_s:.1f} s")
    if bad:
        raise AssertionError(f"the train step differs from JAX's "
                             f"fingerprint: {bad[:8]}")
    log(f"train fingerprint: digests equal, fp32 and bf16 within the "
        f"bounds ({time.perf_counter() - t0:.1f} s)")
    return results


def k2_dx_check(dy, w27, p):
    """K2's dX (the mirrored-tap conv of the masked cotangent) against its
    plain version on one input, under k2_check's rule: -> (max abs err,
    ok)."""
    import torch
    from coocc_tpu_torch.ops.subm_conv import (ext_conv_plain, flip_taps,
                                               subm_ext_conv_dx,
                                               subm_ext_weight)
    got = subm_ext_conv_dx(dy, w27, p).float()
    # the plain version (subm_ext_conv_plain with no mask and no epilogue:
    # the conv, one rounding to dy's dtype), its conv kept for the scale
    conv = ext_conv_plain(dy.float(), subm_ext_weight(flip_taps(w27), p),
                          dy.shape[1], dy.shape[-1] // p)
    ref = conv.to(dy.dtype).float()
    conv_scale = float(conv.abs().max())
    del conv
    tol = K2_FP32_REL * conv_scale + 2.0 ** -21 * float(ref.abs().max())
    err = (got - ref).abs()
    if dy.dtype == torch.float32:
        return float(err.max()), float(err.max()) <= tol
    ulp = BF16_ULP_REL * torch.maximum(got.abs(), ref.abs())
    return float(err.max()), bool((err <= ulp + tol).all())


# the configs whose train step runs at full width (phase_train), and their
# launches per step: K2's mask-only forward and its dX once per SubM conv
# (13 in the z-packed encoder, 16 in coocc_lidar's HD encoder), K1 twice
# in the fuser; the camera-only model has neither
PER_TRAIN_STEP_OF = {
    "coocc_multi_r50_256x704": PER_TRAIN_STEP,
    "coocc_lidar": {"window_knn": 0, "subm_ext_conv": 16,
                    "subm_ext_conv_dx": 16, "knn2": 0},
    "coocc_multi_r101_openoccupancy": PER_TRAIN_STEP,
    "coocc_multi_r101_896x1600": PER_TRAIN_STEP,
    "coocc_cam_r101_896x1600": dict.fromkeys(PER_TRAIN_STEP, 0),
    "coocc_multi_r50_256x704_stereo": PER_TRAIN_STEP}
TRAIN_CONFIGS = tuple(PER_TRAIN_STEP_OF)
# the configs whose train step's K2 calls are checked and timed one by one
# (coocc_multi_r101_896x1600's LiDAR branch is the flagship's: same shapes)
TRAIN_K2_CHECKED = ("coocc_multi_r50_256x704", "coocc_lidar",
                    "coocc_multi_r101_openoccupancy")
# the stereo config's LiDAR branch is the flagship's too: its first K2
# forward and dX of a step are checked, not timed again
TRAIN_K2_ONE_CALL = ("coocc_multi_r50_256x704_stereo",)


def phase_train(name, kernels, cfg=None, want=None, c8=None, init=None):
    """Config `name`'s train step (or, with `cfg`, that config's under the
    label `name`, its launches `want` a step, C8 checked where `c8` and
    the weights `init` gives) at full width in its config's bf16
    (entry.train_steps: seeded weights, AdamW, BN on batch statistics, the
    renderer, every loss): one warm-up step, then 3 steps on the synthetic
    batches of seeds 0, 1, 2 with the kernels' counts set to 0 before them
    and read after them (per step: PER_TRAIN_STEP_OF); ms per step, peak
    memory, every loss term finite (loss_depth_render among them), at
    least 95% of the parameters and every BN statistic moved; a profiled
    step's device time by kernel. For TRAIN_K2_CHECKED, one more step's K2
    calls (its mask-only forward and its dX), each against its plain
    version on the call's own inputs, with their times, bound and cuDNN's,
    and dW's time. -> the config's numbers, its launches among them."""
    import torch
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import init_weights, train_steps
    lap = lap_timer(f"{name} train")
    cfg = cfg or get_config(name)
    want = want or PER_TRAIN_STEP_OF[name]
    c8 = name in C8_CONFIGS if c8 is None else c8
    t0 = time.perf_counter()
    trainer, [warm] = train_steps(cfg, 1, "cuda", init=init or init_weights)
    sync()
    model = trainer.model
    if model.dtype != torch.bfloat16:
        raise AssertionError(f"{name} trains in {model.dtype}")
    log(f"{name} train warm-up step (seed 0, model build included): "
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
        if grew != want:
            raise AssertionError(f"{name} train step {i}: launches {grew}, "
                                 f"want {want}")
        values = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()) or (
                cfg.render.use_rendering
                and "loss_depth_render" not in values):
            raise AssertionError(f"{name} train step {i}: {values}")
        log(f"{name} train step {i} (seed {i}): {step_ms[-1]:.3f} ms; "
            + ", ".join(f"{k} {v:.6g}" for k, v in values.items()))
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"{name} train launches over 3 steps: {launches}")
    log(f"{name} train step ms: {[round(t, 3) for t in step_ms]} (median "
        f"{statistics.median(step_ms):.3f}); peak memory allocated "
        f"{peak / 2**30:.3f} GiB")
    after = model.state_dict()
    params = dict(model.named_parameters())
    moved = [k for k in params if not torch.equal(before[k], after[k])]
    stats = [k for k in after if "running" in k]
    still = [k for k in stats if torch.equal(before[k], after[k])]
    log(f"{name} train moved {len(moved)} of {len(params)} parameter "
        f"tensors and {len(stats) - len(still)} of {len(stats)} BN "
        "statistics")
    if still or len(moved) < 0.95 * len(params):
        raise AssertionError(f"the steps left BN statistics {still[:5]} or "
                             f"{len(params) - len(moved)} parameters still")
    del before, after
    lap("build, warm-up and 3 steps")
    log(f"profile, {name} one train step (device time by kernel):")
    busy = device_breakdown(trainer.step, batches[:1], 15)
    lap("profile")
    nums = {"step_ms": statistics.median(step_ms), "device_busy_ms": busy,
            "peak_gib": peak / 2 ** 30, "launches": launches}
    if name in TRAIN_K2_CHECKED:
        nums.update(train_k2_checks(trainer, batches[1]))
        lap("K2's forward, dX and dW on one step's own inputs")
    elif name in TRAIN_K2_ONE_CALL:
        nums["one_call"] = train_k2_one_call(trainer, batches[1])
        lap("K2's first forward and dX of a step")
    if c8:
        nums["c8"], snap = c8_check(name, trainer, batches[0])
        if name == FLAGSHIP:
            nums["dp_world1"] = dp_world_one(
                trainer, batches[0], snap,
                not any(nums["c8"]["differing"].values()))
            lap("the data-parallel step over a group of one")
        del snap
    del trainer, model, batches
    torch.cuda.empty_cache()
    return nums


def train_k2_calls(trainer, batch):
    """One train step with K2's forward, its dX and dW recorded, each
    call's inputs copied to the host (stage 0 of coocc_lidar alone holds
    1.47 GB a tensor; the device keeps the step's own memory). dW reads
    the forward's x and the dX call's dy, so it keeps only their indices.
    -> {"fwd": [(x, w27, p, mcell)], "dx": [(dy, w27, p)], "dw": [(fwd
    index, dx index)]}."""
    from coocc_tpu_torch.ops import subm_conv as k2
    calls = {"fwd": [], "dx": [], "dw": []}
    inner = k2.subm_ext_conv, k2.subm_ext_conv_dx, k2.subm_ext_weight_grad

    def host(*ts):
        return tuple(t.detach().cpu() if hasattr(t, "cpu") else t
                     for t in ts)

    ptrs = {"fwd": [], "dx": []}

    def keep_fwd(x_pb, w27, p, mcell, bn=None, identity=None):
        if bn is not None or identity is not None:
            raise AssertionError("a fused K2 epilogue in training")
        calls["fwd"].append(host(x_pb, w27, p, mcell))
        ptrs["fwd"].append(x_pb.data_ptr())
        return inner[0](x_pb, w27, p, mcell)

    def keep_dx(dy, w27, p):
        calls["dx"].append(host(dy, w27, p))
        ptrs["dx"].append(dy.data_ptr())
        return inner[1](dy, w27, p)

    def keep_dw(x_pb, dy, p):
        # the SubM whose forward saw this x (it keeps x alive, so its
        # address is its own), and the dX call just made on this dy
        i = [j for j, ptr in enumerate(ptrs["fwd"])
             if ptr == x_pb.data_ptr()]
        if len(i) != 1 or ptrs["dx"][-1] != dy.data_ptr():
            raise AssertionError("a dW call without its forward and dX")
        calls["dw"].append((i[0], len(calls["dx"]) - 1))
        return inner[2](x_pb, dy, p)
    # each wrapper counts its launch on its module's name, the keep_*
    # function's while this step runs; the main path's counts were read
    keep_fwd.launches = keep_dx.launches = 0
    k2.subm_ext_conv, k2.subm_ext_conv_dx, k2.subm_ext_weight_grad = (
        keep_fwd, keep_dx, keep_dw)
    try:
        trainer.step(batch)
        sync()
    finally:
        (k2.subm_ext_conv, k2.subm_ext_conv_dx,
         k2.subm_ext_weight_grad) = inner
    return calls


def train_k2_one_call(trainer, batch):
    """The first K2 forward (mask only) and the first dX of one train step,
    each against its plain version on the call's own inputs (k2_check,
    k2_dx_check), after the step. -> {"fwd": max abs err, "dx": max abs
    err}."""
    from coocc_tpu_torch.ops import subm_conv as k2
    name = trainer.model.cfg.name
    kept = {}
    inner = k2.subm_ext_conv, k2.subm_ext_conv_dx

    def keep_fwd(x_pb, w27, p, mcell, bn=None, identity=None):
        kept.setdefault("fwd", (x_pb.detach().clone(), w27.detach().clone(),
                                p, mcell.clone(), bn, identity))
        return inner[0](x_pb, w27, p, mcell, bn, identity)

    def keep_dx(dy, w27, p):
        kept.setdefault("dx", (dy.detach().clone(), w27.detach().clone(),
                               p))
        return inner[1](dy, w27, p)
    # each wrapper counts its launch on its module's name, the keep_*
    # function's while this step runs; the main path's counts were read
    keep_fwd.launches = keep_dx.launches = 0
    k2.subm_ext_conv, k2.subm_ext_conv_dx = keep_fwd, keep_dx
    try:
        trainer.step(batch)
        sync()
    finally:
        k2.subm_ext_conv, k2.subm_ext_conv_dx = inner
    if set(kept) != {"fwd", "dx"}:
        raise AssertionError(f"{name}: a train step made no K2 call")
    x, w27, p, mcell, bn, idn = kept["fwd"]
    err, scale, _, ok = k2_check(x, w27, p, mcell, bn, idn)
    log(f"{name} train subm_ext_conv vs plain [the step's first call, "
        f"{tuple(x.shape)} p={p} {str(x.dtype)[6:]} {k2_mode(bn, idn)}]: "
        f"max_abs_err {err:.6g}, scale {scale:.6g}")
    dy, w27d, pd = kept["dx"]
    err_dx, ok_dx = k2_dx_check(dy, w27d, pd)
    log(f"{name} train subm_ext_conv_dx vs plain [the step's first call, "
        f"{tuple(dy.shape)} p={pd} {str(dy.dtype)[6:]}]: max_abs_err "
        f"{err_dx:.6g}, input scale {float(dy.abs().max()):.6g}")
    if not (ok and ok_dx):
        raise AssertionError(f"{name}: K2's forward or dX differs from its "
                             "plain version on a train step's input")
    return {"fwd": err, "dx": err_dx}


def train_k2_checks(trainer, batch):
    """K2's mask-only forward and its dX on every call of one train step,
    each against its plain version on the call's own inputs (k2_check,
    k2_dx_check), and the per-step times of the kernel, the plain version
    and cuDNN bf16 on the concatenated input (these two timed once per
    shape), with the bound from this work (k2_work); dW's time (torch
    ops). -> {"fwd": row, "dx": row,
    "dW_ms": ms}."""
    import torch
    import torch.nn.functional as F
    from coocc_tpu_torch.ops import subm_conv as k2
    calls = train_k2_calls(trainer, batch)
    name = trainer.model.cfg.name
    n = PER_TRAIN_STEP_OF[name]["subm_ext_conv"]
    if not len(calls["fwd"]) == len(calls["dx"]) == len(calls["dw"]) == n:
        raise AssertionError(f"{name}: {len(calls['fwd'])} forward, "
                             f"{len(calls['dx'])} dX, {len(calls['dw'])} dW "
                             "calls in one step")
    rows = {}
    for kind in ("fwd", "dx"):
        max_err = kernel = plain = library = 0.0
        ops = nbytes = 0
        level_ms = {}     # the plain version's and cuDNN's ms by shape
        for args in calls[kind]:
            x, w27, p = (a.cuda() if hasattr(a, "cuda") else a
                         for a in args[:3])
            if kind == "fwd":
                mcell = args[3].cuda()
                wc = w27
                err, scale, _, ok = k2_check(x, w27, p, mcell, None, None)
                run = (lambda: k2.subm_ext_conv(x, w27, p, mcell))
                run_plain = (lambda: k2.subm_ext_conv_plain(x, w27, p,
                                                            mcell))
            else:
                wc = k2.flip_taps(w27)
                ones = torch.ones(x.shape[:-1] + (p,), dtype=torch.bool,
                                  device="cuda")
                err, ok = k2_dx_check(x, w27, p)
                scale = float(x.abs().max())
                run = (lambda: k2.subm_ext_conv_dx(x, w27, p))
                run_plain = (lambda: k2.subm_ext_conv_plain(x, wc, p, ones))
            log(f"{name} train {'subm_ext_conv' if kind == 'fwd' else 'subm_ext_conv_dx'}"
                f" vs plain [step input {tuple(x.shape)} p={p} Co="
                f"{wc.shape[2]} {str(x.dtype)[6:]}]: max_abs_err {err:.6g}, "
                f"input scale {scale:.6g}")
            if not ok:
                raise AssertionError(f"{name}: K2's {kind} differs from its "
                                     "plain version on a train step's input")
            max_err = max(max_err, err)
            kernel += timed_ms(run, 3)
            level = (tuple(x.shape), p, wc.shape[2])
            if level not in level_ms:
                # the plain version and cuDNN take one time per shape
                C = x.shape[-1] // p
                G, X, Y = x.shape[0] * x.shape[1], x.shape[2], x.shape[3]
                ext = k2.shift_ext(x, C).reshape(G, X, Y, -1).permute(
                    0, 3, 1, 2)
                wb = k2.subm_ext_weight(wc, p).to(x.dtype).permute(
                    3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                F.conv2d(ext, wb, padding=1)
                level_ms[level] = (
                    timed_ms(run_plain, 1),
                    timed_ms(lambda: F.conv2d(ext, wb, padding=1), 3))
                del ext, wb
            plain += level_ms[level][0]
            library += level_ms[level][1]
            o, b = k2_work(level[0], p, level[2], "mask", x.element_size())
            ops, nbytes = ops + o, nbytes + b
            del x, w27
            torch.cuda.empty_cache()
        ops_ms = ops / BF16_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"{name} train {kind} per step: kernel {kernel:.4f} ms ({n} "
            f"launches, {ops / kernel / 1e9:.1f} TFLOP/s useful), plain "
            f"{plain:.4f} ms, cuDNN bf16 on the concatenated input "
            f"{library:.4f} ms; bound {ops} FLOP -> {ops_ms:.4f} ms, "
            f"{nbytes} bytes -> {bytes_ms:.4f} ms")
        rows[kind] = {"launches_per_step": n, "max_abs_err": max_err,
                      "ms": kernel, "plain_ms": plain,
                      "bound_ms": max(ops_ms, bytes_ms),
                      "bound_by": "operations" if ops_ms >= bytes_ms
                      else "bytes", "library_ms": library}
    dw = 0.0
    for i, j in calls["dw"]:
        x, p = calls["fwd"][i][0].cuda(), calls["fwd"][i][2]
        dy = calls["dx"][j][0].cuda()
        dw += timed_ms(lambda: k2.subm_ext_weight_grad(x, dy, p), 3)
        del x, dy
    log(f"{name} train dW (torch ops) per step: {dw:.4f} ms")
    del calls
    torch.cuda.empty_cache()
    return {"fwd": rows["fwd"], "dx": rows["dx"], "dW_ms": dw}


def phase_train_cli(config, steps: int = 1):
    """`python -m coocc_tpu_torch.train <config> --synthetic
    --steps-per-epoch <steps> --max-epochs 1` (flax's initial weights, the
    eval hook on 2 batches, a checkpoint with save-best) in a process of
    its own, into a temporary work dir. -> its eval ms per batch (the
    second's)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        wd = os.path.join(d, "work_dir")
        proc = subprocess.run(
            [sys.executable, "-m", "coocc_tpu_torch.train", config,
             "--synthetic", "--steps-per-epoch", str(steps), "--max-epochs",
             "1", "--work-dir", wd], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        listing = sorted(os.listdir(wd)) if os.path.isdir(wd) else []
    out = proc.stdout + proc.stderr
    if proc.returncode != 0 or "mIoU" not in out or "epoch_0" not in listing:
        raise AssertionError(f"the train CLI failed: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    log(f"train CLI (python -m coocc_tpu_torch.train {config} --synthetic "
        f"--steps-per-epoch {steps} --max-epochs 1, "
        f"{time.perf_counter() - t0:.1f} s): work dir {listing}")
    for line in out.strip().splitlines():
        if any(w in line for w in ("ms a batch", "mIoU", "device:")):
            log(f"  {line[:300]}")
    line = [ln for ln in out.splitlines() if "ms a batch" in ln][-1]
    return json.loads(line.split("ms a batch ")[-1])[-1]


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


def phase_bench(config, in_process=False):
    """`BENCH_CONFIG=config python -m coocc_tpu_torch.bench` once
    (BENCH_ITERS=3, its default bf16), in a process of its own, or with
    `in_process` its `main()` in this one (the process's start, torch's
    import and the card's context cost some 8 s a bench); its JSON line is
    logged behind a prefix. -> frames/sec."""
    import contextlib
    import io
    t0 = time.perf_counter()
    env = {"BENCH_ITERS": "3", "BENCH_CONFIG": config}
    if in_process:
        from coocc_tpu_torch import bench
        old = {k: os.environ.get(k) for k in env}
        out = io.StringIO()
        os.environ.update(env)
        try:
            with contextlib.redirect_stdout(out):
                bench.main()
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        stdout = out.getvalue()
    else:
        proc = subprocess.run(
            [sys.executable, "-m", "coocc_tpu_torch.bench"], cwd=ROOT,
            env={**os.environ, **env}, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the bench failed: {proc.stderr[-2000:]}")
        stdout = proc.stdout
    lines = stdout.strip().splitlines()
    result = json.loads(lines[-1])
    if len(lines) != 1 or result["dtype"] != "bf16" or not (
            result["value"] > 0 and result["unit"] == "frames/sec"
            and "power_limit" in result["device"]
            and result["metric"].startswith(config)):
        raise AssertionError(f"the bench printed {stdout!r}")
    where = "in this process" if in_process else "in a process of its own"
    log(f"bench (BENCH_CONFIG={config} python -m coocc_tpu_torch.bench, "
        f"BENCH_ITERS=3, {where}, {time.perf_counter() - t0:.1f} s): "
        f"{lines[-1]}")
    return result["value"]


FLAGSHIP = "coocc_multi_r50_256x704"
OPENOCC = "coocc_multi_r101_openoccupancy"
LIDAR = "coocc_lidar"
STEREO = "coocc_multi_r50_256x704_stereo"
# launches per request of the other served configs: the camera-only model
# has no LiDAR branch and no fuser, so neither K1 nor K2; the LiDAR-only
# model no fuser (no K1) and 16 K2 launches, 4 SubMs at each of the HD
# encoder's stages
PER_REQUEST_OF = {OPENOCC: PER_REQUEST,
                  "coocc_multi_r101_896x1600": PER_REQUEST,
                  "coocc_cam_r101_896x1600": dict.fromkeys(PER_REQUEST, 0),
                  LIDAR: {**dict.fromkeys(PER_REQUEST, 0),
                          "subm_ext_conv": 16},
                  STEREO: PER_REQUEST}


def phase_served_config(name, kernels):
    """Config `name` as `python -m coocc_tpu_torch` serves it (its bf16
    compute dtype, entry.served_model) at full width: serve_requests on
    the synthetic batches of seeds 0-2 (launches PER_REQUEST_OF), and the
    device's busy time per request (torch.profiler). -> (model, requests,
    launches, {request ms, busy ms, peak GiB})."""
    import torch
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import served_model
    cfg = get_config(name)
    model = served_model(cfg, "cuda")
    if model.dtype != torch.bfloat16:
        raise AssertionError(f"{name} is served in {model.dtype}")
    requests = [synthetic_batch(cfg, batch_size=1, seed=s).to("cuda")
                for s in range(3)]
    launches, req_ms, peak, _ = serve_requests(
        model, requests, kernels, PER_REQUEST_OF[name], keep=False)
    log(f"profile, {name} (device time by kernel):")
    busy = device_breakdown(model, requests, 12)
    return model, requests, launches, {
        "request_ms": statistics.median(req_ms), "device_busy_ms": busy,
        "peak_gib": peak / 2 ** 30}


def phase_openocc(kernels, weights):
    """coocc_multi_r101_openoccupancy at full width (6x896x1600 images,
    350,000 LiDAR points, the 1024x1024x80 grid, cascade ratio 4 onto
    512x512x40), as served: 3 requests with K1 2 and K2 13 launches each;
    K1 against its plain version with the config's two windows on the
    model's own masks (exact); every K2 call of a pts prefix against its
    plain version on its own bf16 inputs (res1 [1,10,512,512,128]), and
    K2's times and bound at those shapes; eval_step with a visible mask
    (SC/SSC hists at 512x512x40, the _visible pair); then the card's fp32
    and bf16 forwards against openocc_real.npz, the test CLI in a process
    of its own and the bench. -> (K1's row, K2's numbers, the config's
    numbers)."""
    import torch
    from coocc_tpu_torch.parallel.train_step import eval_step
    lap = lap_timer(OPENOCC)
    model, requests, launches, nums = phase_served_config(OPENOCC, kernels)
    lap("build and serve")
    pts = model(requests[0], stop_at="pts")
    masks = {"img": pts["img_voxel"][0].abs().sum(-1) != 0,
             "pts": pts["pts_voxel"][0].abs().sum(-1) != 0}
    del pts
    log(f"{OPENOCC}: K1's masks {tuple(masks['img'].shape)}, "
        f"{int(masks['img'].sum())} and {int(masks['pts'].sum())} active "
        "cells")
    k1 = phase_window_knn(model, masks, launches)
    lap("K1's checks")
    calls, k2_err = k2_main_path_check(model, requests[0])
    levels = k2_levels(calls, torch.bfloat16)
    lap("K2 on the main path's calls")
    gen = torch.Generator(device="cuda").manual_seed(4)
    k2 = {"launches": launches["subm_ext_conv"], "max_abs_err": k2_err,
          **k2_times(gen, levels, torch.bfloat16)}
    lap("K2's times")

    # the eval step with the OpenOccupancy visible mask
    cfg = model.cfg
    vis = torch.rand((1, *cfg.occ_size), generator=gen,
                     device="cuda") < 0.6
    batch = requests[0]._replace(visible_mask=vis.to(torch.uint8))
    eval_step(model, batch, cfg)
    ms = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        res = eval_step(model, batch, cfg, return_logits=False)
        hists = {k: v.cpu() for k, v in res.items() if "hist" in k}
        ms.append((time.perf_counter() - t0) * 1e3)
    n_vis = int(hists["SC_hist_visible"].sum())
    if not (0 < n_vis < int(hists["SC_hist"].sum())
            and int(hists["SSC_hist_visible"].sum()) == n_vis):
        raise AssertionError(f"visible hists: {n_vis} cells")
    log(f"{OPENOCC} eval_step with a visible mask: {ms[0]:.3f}, "
        f"{ms[1]:.3f} ms (hists on the host); {sorted(hists)}; "
        f"{n_vis} visible cells counted")
    nums["eval_step_ms"] = ms[1]
    del model, requests, batch, res
    torch.cuda.empty_cache()
    lap("eval_step")

    phase_real_shape_parity(OPENOCC, weights)
    nums["test_cli_eval_ms"] = phase_test_cli(OPENOCC)
    nums["bench_fps"] = phase_bench(OPENOCC, in_process=True)
    return k1, k2, nums


def phase_test_cli(config):
    """`python -m coocc_tpu_torch.test <config> --synthetic --max-steps 2`
    (flax's initial weights) in a process of its own: it prints the SC/SSC
    table. -> its eval ms per batch (the second batch's)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "coocc_tpu_torch.test", config,
         "--synthetic", "--max-steps", "2"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0 or "mIoU" not in proc.stdout:
        raise AssertionError(f"the test CLI failed: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    log(f"test CLI (python -m coocc_tpu_torch.test {config} --synthetic "
        f"--max-steps 2, {time.perf_counter() - t0:.1f} s):")
    for line in proc.stdout.strip().splitlines():
        log(f"  {line}")
    line = [ln for ln in proc.stderr.splitlines() if "ms a batch" in ln][-1]
    log(f"  {line.split(' INFO ')[-1]}")
    return json.loads(line.split("ms a batch ")[-1])[-1]


def lap_timer(name):
    """-> lap(what): logs the seconds since the last lap (or the timer's
    start) against `what`."""
    last = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        log(f"{name}: {what} took {now - last[0]:.1f} s")
        last[0] = now
    return lap


def stage_device_times(model, requests):
    """Device busy ms per request of each stop_at prefix and the full
    forward (torch.profiler), and each stage's marginal. -> {stage: busy
    ms of its prefix}."""
    from coocc_tpu_torch.models.coocc_ray import STAGES
    busy, prev = {}, 0.0
    for stop in STAGES[1:] + (None,):
        log(f"profile, prefix {stop or 'full'}:")
        busy[stop or "full"] = device_breakdown(
            lambda b, stop=stop: model(b, stop_at=stop), requests, 0)
    for name, ms in busy.items():
        log(f"stage {name:6s}: prefix device busy {ms:9.3f} ms, marginal "
            f"{ms - prev:9.3f} ms")
        prev = ms
    return busy


def phase_lidar(kernels, weights):
    """coocc_lidar, the LiDAR-only model, at full width as served (bf16):
    350,000 points (245,000 valid) voxelized onto the 800x800x65 grid at
    the 120,000-voxel eval cap, the HD encoder (p = 8, 4, 2, 1 at bz = 9,
    stage 0 [1,9,800,800,128]), SECOND3D and its FPN, the semantic stack
    and the head on 100x100x8; 3 requests with K2's launches counted (16 a
    request, K1 none); device time by stop_at prefix and the pts stage's by
    kernel; every K2 call of a pts prefix against its plain version on its
    own bf16 inputs (4 each at Co = 16, 32, 64, 128), K2 on random inputs
    at each of those levels in fp32 and bf16 and every epilogue mode, K2's
    times and bound at those shapes; the fp32 and bf16 forwards against
    parity/lidar_real.npz; the data path (data_path_in_process,
    data_path_clis: the train and test CLIs on a nuScenes tree, in
    processes of their own) and the bench. -> (K2's numbers, the config's
    numbers)."""
    import torch
    lap = lap_timer(LIDAR)
    model, requests, launches, nums = phase_served_config(LIDAR, kernels)
    nums["busy_share"] = nums["device_busy_ms"] / nums["request_ms"]
    lap("build and serve")
    nums["stage_busy_ms"] = stage_device_times(model, requests)
    log(f"profile, {LIDAR} pts stage (voxelize, HD encoder, SECOND3D + FPN; "
        "device time by kernel):")
    device_breakdown(pts_stage(model), requests, 12)
    lap("profiles")
    calls, k2_err = k2_main_path_check(model, requests[0])
    levels = k2_levels(calls, torch.bfloat16,
                       PER_REQUEST_OF[LIDAR]["subm_ext_conv"])
    per_co = {Co: sum(c.values()) for (_, _, Co), c in levels.items()}
    if per_co != {16: 4, 32: 4, 64: 4, 128: 4}:
        raise AssertionError(f"{LIDAR}: K2 calls by Co {per_co}")
    lap("K2 on the main path's calls")
    tree = NuScenesTree()
    nums["data_path"] = data_path_in_process(model, kernels, tree)
    del model, requests
    torch.cuda.empty_cache()
    lap("the data path in this process")
    gen = torch.Generator(device="cuda").manual_seed(5)
    k2_random_checks(gen, [(s, p, Co, f"{LIDAR} level") for s, p, Co
                           in levels])
    lap("K2 on random inputs")
    k2 = {"launches": launches["subm_ext_conv"], "max_abs_err": k2_err,
          **k2_times(gen, levels, torch.bfloat16)}
    torch.cuda.empty_cache()
    lap("K2's times")
    phase_real_shape_parity(LIDAR, weights)
    nums["data_path"].update(data_path_clis(tree))
    tree.close()
    lap("the train and test CLIs on the tree")
    nums["bench_fps"] = phase_bench(LIDAR, in_process=True)
    k2["data_path"] = {k: nums["data_path"][k] for k in (
        "launches", "max_abs_err", "train_cli_launches")}
    return k2, nums


class NuScenesTree:
    """A nuScenes tree in the reference's layout, written from seed 0 into
    a temporary directory (coocc_tpu_torch/tools/nuscenes_tree.py: 3 train
    and 2 val keyframes of 34,720 points with 10 sweeps each, SurroundOcc
    ground truth, lidarseg labels, six cameras' calibration, no image)."""

    def __init__(self):
        import tempfile
        from coocc_tpu_torch.tools.nuscenes_tree import write_tree
        self.dir = tempfile.TemporaryDirectory()
        t0 = time.perf_counter()
        self.flags = write_tree(self.dir.name, seed=0)
        self.write_s = time.perf_counter() - t0
        log(f"nuScenes tree written in {self.write_s:.2f} s: {self.flags}")

    def close(self):
        self.dir.cleanup()


def data_path_in_process(model, kernels, tree):
    """The data path of coocc_lidar at real size in this process:
    get_sample's ms per sample (training, with the BDA draws, and eval),
    collate's ms, the padded clouds (10 sweeps take each keyframe past the
    350,000-point capacity), that PIL is not imported; then the served
    model (bf16) on a loaded val batch with the kernels' counts set to 0
    before it and read after it (K2 16, no other kernel), its outputs
    checked, and K2's first call of its pts prefix against its plain
    version. -> the numbers."""
    import numpy as np
    import torch
    from coocc_tpu_torch.data.nuscenes_dataset import (NuScenesOccDataset,
                                                       collate)
    cfg = model.cfg
    f = tree.flags
    nums = {"tree_write_s": tree.write_s}
    for split, ann, train in (("train", f["ann_file"], True),
                              ("val", f["val_ann_file"], False)):
        ds = NuScenesOccDataset(cfg, f["data_root"], ann, f["occ_path"],
                                is_train=train)
        ms, samples = [], []
        for i in range(len(ds)):
            t0 = time.perf_counter()
            samples.append(ds.get_sample(i, np.random.RandomState(i)))
            ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        batch = collate(samples[:1], cfg)
        nums[f"collate_ms_{split}"] = (time.perf_counter() - t0) * 1e3
        nums[f"get_sample_ms_{split}"] = ms
        s = samples[0]
        log(f"{LIDAR} get_sample ({split}, {len(ds)} keyframes): ms "
            f"{[round(t, 3) for t in ms]}; collate of one "
            f"{nums[f'collate_ms_{split}']:.3f} ms; keys {sorted(s)}; "
            f"points {int(s['points_mask'].sum())} of "
            f"{s['points_mask'].size}, lidarseg points "
            f"{int(s['points_occ_mask'].sum())}, occupied gt cells "
            f"{int(((s['gt_occ'] > 0) & (s['gt_occ'] < 255)).sum())}, "
            f"depth pixels {int((s['gt_depths'] > 0).sum())}")
        if "imgs" in s or not s["points_mask"].all():
            raise AssertionError(f"{LIDAR}: a sample with images, or a "
                                 "cloud under the capacity")
    from coocc_tpu_torch.data.pipelines.image_loading import pil_image
    log(f"PIL used by the data path: {pil_image.calls > 0}; PIL in this "
        f"process: {'PIL' in sys.modules}")
    if pil_image.calls or "PIL" in sys.modules:
        raise AssertionError("the LiDAR-only data path imported PIL")
    loaded = batch.to("cuda")
    for k in kernels.values():
        k.launches = 0
    sync()
    t0 = time.perf_counter()
    out = model(loaded)
    sync()
    nums["loaded_request_ms"] = (time.perf_counter() - t0) * 1e3
    launches = {n: k.launches for n, k in kernels.items()}
    check_outputs(out, cfg)
    log(f"{LIDAR} on a loaded val batch: {nums['loaded_request_ms']:.3f} "
        f"ms, launches {launches}")
    if launches != PER_REQUEST_OF[LIDAR]:
        raise AssertionError(f"{LIDAR} on a loaded batch: launches "
                             f"{launches}, want {PER_REQUEST_OF[LIDAR]}")
    from coocc_tpu_torch.nn import sparse_enc_packed
    inner, kept = sparse_enc_packed.subm_ext_conv, []

    def keep(x_pb, w27, p, mcell, bn=None, identity=None):
        if not kept:
            kept.append((x_pb.clone(), w27, p, mcell, bn, identity))
        return inner(x_pb, w27, p, mcell, bn, identity)
    sparse_enc_packed.subm_ext_conv = keep
    try:
        model(loaded, stop_at="pts")
    finally:
        sparse_enc_packed.subm_ext_conv = inner
    x, w27, p, mcell, bn, idn = kept[0]
    err, scale, _, ok = k2_check(x, w27, p, mcell, bn, idn)
    log(f"{LIDAR} subm_ext_conv vs plain [a loaded batch, the pts prefix's "
        f"first call, {tuple(x.shape)} p={p} {str(x.dtype)[6:]} "
        f"{k2_mode(bn, idn)}]: max_abs_err {err:.6g}, scale {scale:.6g}")
    if not ok:
        raise AssertionError(f"{LIDAR}: subm_ext_conv differs from its plain "
                             "version on a loaded batch")
    nums.update(launches=launches["subm_ext_conv"], max_abs_err=err)
    del out, loaded, kept, x
    return nums


def _cli_lines(out: str, *words):
    return [ln for ln in out.splitlines() if any(w in ln for w in words)]


def data_path_clis(tree):
    """coocc_lidar's train and test CLIs on the tree, each in a process of
    its own: `python -m coocc_tpu_torch.train coocc_lidar --data-root ...
    --steps-per-epoch 2 --max-epochs 1` (2 steps, the eval hook over the 2
    val keyframes, a checkpoint), then `python -m coocc_tpu_torch.test
    coocc_lidar <its work dir> --data-root ... --max-steps 2
    --save-by-scene --pred-save ...`. Checks: exit 0, finite losses in
    the epoch's record, the SC/SSC table and the lidarseg table, the
    checkpoint, one prediction file per val token in its scene's folder,
    no PIL used by either process's data path (their `data:` lines, which
    also say whether PIL is in the process), K2's launches in the
    train steps (16 and 16 dX a step). -> the CLIs' wall seconds, the
    loop's data ms and step ms a step, K2's launches."""
    import math
    import pickle
    f = tree.flags
    data = ["--data-root", f["data_root"], "--occ-path", f["occ_path"]]
    wd = os.path.join(tree.dir.name, "work_dir")
    preds = os.path.join(tree.dir.name, "preds")
    nums = {}
    for name, argv in (
            ("train", ["coocc_tpu_torch.train", LIDAR, *data, "--ann-file",
                       f["ann_file"], "--val-ann-file", f["val_ann_file"],
                       "--steps-per-epoch", "2", "--max-epochs", "1",
                       "--work-dir", wd]),
            ("test", ["coocc_tpu_torch.test", LIDAR, wd, *data, "--ann-file",
                      f["val_ann_file"], "--max-steps", "2",
                      "--save-by-scene", "--pred-save", preds])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        nums[f"{name}_cli_s"] = time.perf_counter() - t0
        out = proc.stdout + proc.stderr
        data_lines = _cli_lines(out, "data: data root")
        if proc.returncode != 0 or "mIoU" not in out or not data_lines:
            raise AssertionError(f"the {name} CLI on the tree failed: "
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        log(f"{name} CLI on the tree (python -m {' '.join(argv[:2])} "
            f"--data-root ..., {nums[f'{name}_cli_s']:.1f} s):")
        for line in _cli_lines(out, "device:", "data:", "ms a step",
                               "kernel launches", "ms a batch", "eval:",
                               "work dir"):
            log(f"  {line.split(' INFO ')[-1][:400]}")
        if "PIL used by the data path: False" not in data_lines[-1]:
            raise AssertionError(f"the {name} CLI's data path used PIL: "
                                 f"{data_lines[-1]}")
        if name == "train":
            wait = _cli_lines(out, "data ms a step")[-1].split("included) ")
            data_ms, step_ms = wait[-1].split(", step ms ")
            nums["loop_data_ms"] = json.loads(data_ms)
            nums["loop_step_ms"] = json.loads(step_ms)
            launched = _cli_lines(out, "kernel launches in its")[-1]
            nums["train_cli_launches"] = json.loads(launched.split(
                " steps ")[-1].replace("'", '"'))
            want = {k: 2 * v for k, v in PER_TRAIN_STEP_OF[LIDAR].items()}
            if nums["train_cli_launches"] != want:
                raise AssertionError(f"the train CLI's steps launched "
                                     f"{nums['train_cli_launches']}, want "
                                     f"{want}")
            with open(os.path.join(wd, "metrics.jsonl")) as fh:
                records = [json.loads(ln) for ln in fh]
            epoch = [r for r in records if r["kind"] == "epoch"][-1]
            losses = {k: v for k, v in epoch.items() if k.startswith("loss")}
            val = [r for r in records if r["kind"] == "val"][-1]
            log(f"  epoch record losses {losses}; val SC_IoU "
                f"{val['SC_IoU']:.4f}, SSC_mIoU {val['SSC_mIoU']:.4f}, "
                f"lidarseg_mIoU {val.get('lidarseg_mIoU')}; work dir "
                f"{sorted(os.listdir(wd))}")
            if not losses or not all(math.isfinite(v)
                                     for v in losses.values()):
                raise AssertionError(f"the train CLI's losses: {losses}")
            if "epoch_0" not in os.listdir(wd) \
                    or "lidarseg_mIoU" not in val:
                raise AssertionError("no checkpoint or no lidarseg metric")
        else:
            if "=== LiDAR segmentation ===" not in out \
                    or "=== Semantic Scene Completion (SSC) ===" not in out:
                raise AssertionError("the test CLI printed no SC/SSC or "
                                     "lidarseg table")
            with open(f["val_ann_file"], "rb") as fh:
                infos = pickle.load(fh)["infos"]
            want = sorted(os.path.join(x["scene_name"], x["token"] + ".npz")
                          for x in infos)
            got = sorted(os.path.join(d, p) for d in os.listdir(preds)
                         for p in os.listdir(os.path.join(preds, d)))
            log(f"  predictions: {got}")
            if got != want:
                raise AssertionError(f"predictions {got}, want {want}")
    log(f"{LIDAR} on the tree: the loop waited {nums['loop_data_ms']} ms "
        f"a step for its batch against steps of {nums['loop_step_ms']} ms")
    return nums


def phase_stereo(kernels, weights):
    """coocc_multi_r50_256x704_stereo at full width as served (bf16): the
    flagship's 6x256x704 images and LiDAR grid, the previous keyframe's 6
    images through the shared R50's stage 0, and the BEVStereo depth net
    (3 EM rounds over 4 ranges: 12 plane-sweep warps of [6, 3, 64, 176,
    256]); 3 requests with K1 2 and K2 13 launches each, device busy and
    peak memory, the device time of the stereo depth net with and without
    its EM rounds (the plane sweep's share); K1 and K2 each on one call of
    the path against their plain versions (their times are the
    flagship's: same shapes); the fp32 and bf16 forwards against
    parity/stereo_real.npz; the bench, and the test CLI (its second batch
    timed) in a process of its own. -> the config's numbers (K1's and
    K2's errors among them)."""
    import torch
    lap = lap_timer(STEREO)
    model, requests, launches, nums = phase_served_config(STEREO, kernels)
    nums["launches"] = launches
    lap("build and serve")
    nums.update(stereo_em_share(model, requests, nums["device_busy_ms"]))
    lap("the stereo depth net's profiles")
    nums.update(one_call_checks(STEREO, model, requests[0]))
    lap("K1 and K2 on one call each")
    del model, requests
    torch.cuda.empty_cache()
    phase_real_shape_parity(STEREO, weights)
    nums["bench_fps"] = phase_bench(STEREO, in_process=True)
    nums["test_cli_eval_ms"] = phase_test_cli(STEREO)
    return nums


def stereo_em_share(model, requests, busy_ms):
    """Device time of the stereo depth net alone on each request's own
    inputs (captured on the way), with its EM rounds (the plane-sweep
    warps, the cost volumes and the similarity net) and without (0
    rounds: the Gaussian splat of the depth net's own hypotheses): their
    difference is the plane sweep's, beside the request's busy time."""
    import torch
    net = model.img_view_transformer.depth_net
    inputs = []
    hook = net.register_forward_pre_hook(
        lambda mod, args: inputs.append(args))
    try:
        for b in requests:
            model(b)
    finally:
        hook.remove()

    def run(args):
        with torch.no_grad():
            net(*args)
    log(f"profile, {STEREO} stereo depth net alone "
        f"({net.em_iteration} EM rounds):")
    full = device_breakdown(run, inputs, 10)
    em = net.em_iteration
    net.em_iteration = 0
    try:
        log(f"profile, {STEREO} stereo depth net without its EM rounds:")
        bare = device_breakdown(run, inputs, 0)
    finally:
        net.em_iteration = em
    if full is None or bare is None:
        return {"stereo_net_busy_ms": None, "em_busy_ms": None}
    log(f"{STEREO}: stereo depth net {full:.3f} ms a request, its {em} EM "
        f"rounds {full - bare:.3f} ms ({100 * (full - bare) / busy_ms:.1f}% "
        f"of the request's {busy_ms:.3f} ms busy)")
    return {"stereo_net_busy_ms": full, "em_busy_ms": full - bare}


def one_call_checks(name, model, batch):
    """K1 on config `name`'s first fuser call (the image window on the
    model's own mask; exact) and K2 on its first SubM call of a pts prefix
    (k2_check), each against its plain version."""
    import torch
    from coocc_tpu_torch.nn import sparse_enc_packed
    from coocc_tpu_torch.ops.window_knn import window_knn, window_knn_plain
    pts = model(batch, stop_at="pts")
    mask = pts["img_voxel"][0].abs().sum(-1) != 0
    offs = model.occ_fuser.offsets_img
    k1_err = int((window_knn(mask, offs).long()
                  - window_knn_plain(mask, offs).long()).abs().max())
    log(f"{name} window_knn vs plain [the image window on the model's "
        f"mask, {int(mask.sum())} active cells]: max_abs_err {k1_err}")
    if k1_err != 0:
        raise AssertionError(f"{name}: window_knn differs from plain")
    inner, kept = sparse_enc_packed.subm_ext_conv, []

    def keep(x_pb, w27, p, mcell, bn=None, identity=None):
        if not kept:
            kept.append((x_pb.clone(), w27, p, mcell, bn, identity))
        return inner(x_pb, w27, p, mcell, bn, identity)
    sparse_enc_packed.subm_ext_conv = keep
    try:
        model(batch, stop_at="pts")
    finally:
        sparse_enc_packed.subm_ext_conv = inner
    x, w27, p, mcell, bn, idn = kept[0]
    err, scale, _, ok = k2_check(x, w27, p, mcell, bn, idn)
    log(f"{name} subm_ext_conv vs plain [the pts prefix's first call, "
        f"{tuple(x.shape)} p={p} {str(x.dtype)[6:]} {k2_mode(bn, idn)}]: "
        f"max_abs_err {err:.6g}, scale {scale:.6g}")
    if not ok:
        raise AssertionError(f"{name}: subm_ext_conv differs from its "
                             "plain version")
    errs = [err]
    del pts, mask
    torch.cuda.empty_cache()
    return {"k1_max_abs_err": k1_err, "k2_max_abs_err": errs[0]}


KITTI = "coocc_kitti"
# launches per img + pts prefix of coocc_kitti: no fuser (K1), the packed
# encoder's 13 SubMs
PER_KITTI_PREFIX = {**dict.fromkeys(PER_REQUEST, 0), "subm_ext_conv": 13}


def phase_kitti(kernels, weights):
    """coocc_kitti's img and pts prefixes at full width (one 384x1280
    camera through R50 with the 30-d camera vector of KITTI's 3x4
    intrinsics; 350,000 points, 245,000 valid, on the 512x512x64 LiDAR
    grid through the packed encoder), from the fingerprint's numpy weights
    (B=1, the synthetic batch of seed 0), in bf16 and fp32: per dtype the
    prefix warmed up, then 3 runs with K2's 13 launches counted (K1 none),
    host ms and device busy ms, every K2 call against its plain version on
    its own inputs; the full forward raises ValueError (its LiDAR grid is
    not its fuser's, as in JAX); both prefixes held to
    parity/kitti_real.npz; K2's bf16 times and bound at kitti's shapes.
    -> (K2's numbers, the config's numbers)."""
    import torch
    lap = lap_timer(KITTI)
    nums, k2 = {}, {"max_abs_err": 0.0}
    levels = {}

    def each(prefix, model, batch):
        lap(f"{prefix} model built")
        model(batch, stop_at="pts")          # warm-up
        sync()
        for k in kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            out = model(batch, stop_at="pts")
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = {n: k.launches for n, k in kernels.items()}
        want = {n: 3 * c for n, c in PER_KITTI_PREFIX.items()}
        if launches != want:
            raise AssertionError(f"{KITTI} {prefix}: launches {launches}, "
                                 f"want {want}")
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        if shapes != {"img_voxel": (1, 128, 128, 16, 128),
                      "pts_voxel": (1, 64, 64, 8, 128)} or not all(
                bool(torch.isfinite(v.float()).all()) for v in out.values()):
            raise AssertionError(f"{KITTI} {prefix} prefix: {shapes}")
        log(f"profile, {KITTI} img + pts prefix ({prefix}):")
        busy = device_breakdown(lambda b: model(b, stop_at="pts"), [batch],
                                8)
        nums[prefix] = {"prefix_ms": statistics.median(ms),
                        "device_busy_ms": busy,
                        "peak_gib": torch.cuda.max_memory_allocated()
                        / 2 ** 30, "launches": launches}
        log(f"{KITTI} {prefix} img + pts prefix: ms "
            f"{[round(t, 3) for t in ms]}, busy {busy} ms, launches over 3 "
            f"{launches}, shapes {shapes}")
        calls, err = k2_main_path_check(model, batch)
        levels[prefix] = k2_levels(calls, model.dtype)
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        try:
            model(batch)
        except ValueError as e:
            log(f"{KITTI} full forward raises ValueError, as JAX's fuser "
                f"fails: {e}")
        else:
            raise AssertionError(f"{KITTI}: the full forward ran")
        lap(f"{prefix} prefix served, K2 checked")

    phase_real_shape_parity(KITTI, weights, each)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(6)
    k2.update(launches=nums["bf16"]["launches"]["subm_ext_conv"],
              **k2_times(gen, levels["bf16"], torch.bfloat16))
    lap("K2's times")
    return k2, nums


# the card's render against the CPU's, as fractions of each output's max:
# the heads' bf16 outputs may differ by an ulp (2^-8 relative) between the
# two devices, whose products sum in other orders; compositing averages
# them along each ray with weights that move by as little, and the x16
# upsample averages again: the max within 4 ulps, the mean within 1/4 ulp
RENDER_MAX_REL = 4 * BF16_ULP_REL
RENDER_MEAN_REL = BF16_ULP_REL / 4


def phase_render(kernels):
    """The flagship at full width with eval-time rendering
    (render.test_rendering, `--test-rendering`), as served (bf16): 3
    eval_step requests (seeds 0-2) with K1 2 and K2 13 launches each, host
    ms, device busy ms and peak memory, beside the same requests without
    rendering; render_rgb [1, 6, 256, 704, 3] in [0, 1] and render_depth
    finite in [0, D] (the renderer's units: D = 112 frustum samples a ray);
    evaluate's render_PSNR and render_SSIM over 2 batches; one request's
    render of its first camera (the renderer alone on its fused
    voxel_feats) on the card against the same on the CPU; then the test
    CLI with --test-rendering in this process. -> the path's numbers."""
    import contextlib
    import copy
    import io
    import torch
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import served_model
    from coocc_tpu_torch.geometry.frustum import get_geometry
    from coocc_tpu_torch.models.renderer import render
    from coocc_tpu_torch.parallel.train_step import eval_step
    from coocc_tpu_torch.test import __main__ as test_cli
    from coocc_tpu_torch.train.loop import evaluate
    lap = lap_timer("render")
    base = get_config(FLAGSHIP)
    cfg = dataclasses.replace(base, render=dataclasses.replace(
        base.render, use_rendering=True, test_rendering=True))
    model = served_model(cfg, "cuda")
    requests = [synthetic_batch(cfg, batch_size=1, seed=s).to("cuda")
                for s in range(3)]
    D = len(torch.arange(*cfg.grid.dbound))
    nums = {}
    for tag, c in (("render", cfg), ("plain", base)):
        model.cfg = c
        eval_step(model, requests[0], c)     # warm-up
        sync()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        ms = []
        for i, b in enumerate(requests):
            sync()
            t0 = time.perf_counter()
            res = eval_step(model, b, c, return_logits=False)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if tag == "render":
                rgb, dep = res["render_rgb"], res["render_depth"]
                if tuple(rgb.shape) != (1, 6, 256, 704, 3) or \
                        tuple(dep.shape) != (1, 6, 256, 704):
                    raise AssertionError(f"render shapes {rgb.shape}, "
                                         f"{dep.shape}")
                if not (bool(torch.isfinite(dep).all())
                        and float(dep.min()) >= 0 and float(dep.max()) <= D
                        and float(rgb.min()) >= 0 and float(rgb.max()) <= 1):
                    raise AssertionError(f"request {i}: render out of range")
                log(f"render request {i}: depth in [{float(dep.min()):.4f}, "
                    f"{float(dep.max()):.4f}] of [0, {D}], rgb mean "
                    f"{float(rgb.mean()):.4f}")
            elif "render_rgb" in res:
                raise AssertionError("rendered without test_rendering")
            del res
        launches = {n: k.launches for n, k in kernels.items()}
        want = {n: 3 * c_ for n, c_ in PER_REQUEST.items()}
        if launches != want:
            raise AssertionError(f"{tag} eval: launches {launches}, want "
                                 f"{want}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"profile, flagship eval_step ({tag}):")
        busy = device_breakdown(lambda b: eval_step(model, b, c, False),
                                requests, 10 if tag == "render" else 0)
        nums[tag] = {"request_ms": statistics.median(ms),
                     "device_busy_ms": busy, "peak_gib": peak,
                     "launches": launches}
        log(f"flagship eval_step ({tag}): ms {[round(t, 3) for t in ms]}, "
            f"busy {busy} ms, peak {peak:.3f} GiB, launches over 3 "
            f"{launches}")
    model.cfg = cfg
    nums["added_ms"] = nums["render"]["request_ms"] \
        - nums["plain"]["request_ms"]
    if nums["render"]["device_busy_ms"] and nums["plain"]["device_busy_ms"]:
        nums["added_busy_ms"] = nums["render"]["device_busy_ms"] \
            - nums["plain"]["device_busy_ms"]
    lap("requests with and without rendering")
    summary = evaluate(model, cfg, iter(requests[:2]))
    nums["render_PSNR"], nums["render_SSIM"] = summary["render_PSNR"], \
        summary["render_SSIM"]
    log(f"evaluate over 2 batches: render_PSNR {summary['render_PSNR']:.6f} "
        f"dB, render_SSIM {summary['render_SSIM']:.6f}, SC_IoU "
        f"{summary['SC_IoU']:.6f}, SSC_mIoU {summary['SSC_mIoU']:.6f}")

    # the renderer alone on one request's fused features and its first
    # camera's frustum, on the card and on the CPU
    b = requests[0]
    with torch.no_grad():
        vf = model(b, stop_at="fuse")["voxel_feats"]
        geom = get_geometry(model.img_view_transformer.frustum, b.rots,
                            b.trans, b.intrins, b.post_rots, b.post_trans,
                            b.bda)[:, :1]
        card = render(model.sigma_head, model.rgb_head, cfg.render, vf,
                      geom)
        heads = [copy.deepcopy(h).cpu() for h in (model.sigma_head,
                                                  model.rgb_head)]
        cpu = render(*heads, cfg.render, vf.cpu(), geom.cpu())
    worst = {}
    for name, a, r in (("render_rgb", card[0], cpu[0]),
                       ("render_depth", card[1], cpu[1])):
        scale = float(r.abs().max())
        err = (a.float().cpu() - r.float()).abs()
        worst[name] = (float(err.max()) / scale, float(err.mean()) / scale)
        log(f"{name} card vs cpu (the renderer alone, bf16 voxel_feats "
            f"{tuple(vf.shape)}, camera 0): max |diff| "
            f"{worst[name][0]:.6g}, mean {worst[name][1]:.6g} of the scale "
            f"{scale:.6g} (bounds {RENDER_MAX_REL:.6g}, "
            f"{RENDER_MEAN_REL:.6g})")
        if not (worst[name][0] <= RENDER_MAX_REL
                and worst[name][1] <= RENDER_MEAN_REL):
            raise AssertionError(f"{name}: the card's render differs from "
                                 "the CPU's beyond bf16 rounding")
    nums["card_vs_cpu"] = worst
    del model, requests, vf, geom, card, cpu
    torch.cuda.empty_cache()
    lap("evaluate and the render on the CPU")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        test_cli.main([FLAGSHIP, "--synthetic", "--test-rendering",
                       "--max-steps", "2"])
    text = out.getvalue()
    if "PSNR" not in text or "mIoU" not in text:
        raise AssertionError(f"the test CLI printed {text!r}")
    log(f"test CLI (python -m coocc_tpu_torch.test {FLAGSHIP} --synthetic "
        "--test-rendering --max-steps 2, in this process):")
    for line in text.strip().splitlines():
        log(f"  {line}")
    torch.cuda.empty_cache()
    lap("the test CLI")
    return nums


# the LiDAR encoder's other routes (pts.impl 'gather' and 'dense'): K1 in
# the fuser, 2 a forward and a step; K2 (the packed encoder's) never
PER_ROUTE = {"window_knn": 2, "subm_ext_conv": 0, "subm_ext_conv_dx": 0,
             "knn2": 0}
NO_KERNELS = dict.fromkeys(PER_ROUTE, 0)
# the request whose cap binds at no level of the gather encoder: its first
# FEW_POINTS points (the voxel cap and every level's keep all their sites)
FEW_POINTS = 12_000
# gather against dense pts_voxel, fp32 both: the same sums in other orders
# (a matmul of gathered rows against cuDNN's conv3d, TF32 off) through 20
# layers, as fractions of max |dense|; a wiring fault moves them by O(1)
GATHER_VS_DENSE_MAX = 1e-3
GATHER_VS_DENSE_MEAN = 1e-4


def with_impl(cfg, impl):
    return dataclasses.replace(cfg, pts=dataclasses.replace(cfg.pts,
                                                            impl=impl))


def loaded(sd):
    """An `init` for entry.build_model and train_steps: the weights of
    state_dict `sd`, copied on the card (init_weights draws a flagship's
    on the host in about 3.5 s)."""
    def init(model, seed):
        model.load_state_dict(sd)
        return model
    return init


def cap_drops(model, requests):
    """Each request's sites before the voxel cap and each strided level's
    cap, and the drops (pts.max_voxels_test), from one pts stage of the
    gather model each. -> [{"voxels": [occupied, kept], "levels":
    [[sites, kept], ...]}]."""
    import torch
    from coocc_tpu_torch.ops.voxelize import voxelize_mask
    cfg = model.cfg
    cap = cfg.pts.max_voxels_test
    out = []
    for b in requests:
        occupied = int(voxelize_mask(
            b.points[0], b.points_mask[0], cfg.point_cloud_range,
            cfg.pts.voxel_size, cfg.pts.sparse_shape_xyz).sum())
        with torch.no_grad():
            model._pts_voxels(b)
        sites = [int(s.max()) for s in model.pts_middle_encoder.level_sites]
        out.append({"voxels": [occupied, min(occupied, cap)],
                    "levels": [[n, min(n, cap)] for n in sites]})
    log(f"{cfg.name} gather caps ({cap} sites): " + "; ".join(
        f"request {i}: voxels {r['voxels'][0]} -> {r['voxels'][1]}, levels "
        + ", ".join(f"{n} -> {k}" for n, k in r["levels"])
        for i, r in enumerate(out)))
    return out


def gather_serve(model, requests, kernels, per_request):
    """serve_requests on a gather-route model, the device's busy time
    (full forward and pts stage, by kernel), the caps' drops and the
    synchronizing calls of one forward and of its pts stage, which has
    none (coocc_tpu_torch/tools/host_profile.py:sync_sites). -> its
    numbers."""
    import torch
    from coocc_tpu_torch.tools.host_profile import sync_sites
    launches, req_ms, peak, _ = serve_requests(model, requests, kernels,
                                               per_request, keep=False)
    log(f"profile, {model.cfg.name} gather (device time by kernel):")
    busy = device_breakdown(model, requests, 12)
    log(f"profile, {model.cfg.name} gather pts stage (voxelize + "
        "SparseLiDAREnc8x / SparseEncoderHD, device time by kernel):")
    pts_busy = device_breakdown(pts_stage(model), requests, 12)
    with torch.no_grad():
        syncs = sync_sites(model, requests[0])
        pts_syncs = sync_sites(pts_stage(model), requests[0])
    log(f"synchronizing calls in one gather forward: {sum(syncs.values())} "
        f"{dict(syncs)}; in its pts stage {sum(pts_syncs.values())}")
    if pts_syncs:
        raise AssertionError(f"the gather route synchronizes: {pts_syncs}")
    share = (lambda a, b: None if a is None or b is None else a / b)
    return {"request_ms": statistics.median(req_ms), "device_busy_ms": busy,
            "busy_share": share(busy, statistics.median(req_ms)),
            "pts_busy_ms": pts_busy, "pts_share": share(pts_busy, busy),
            "peak_gib": peak / 2 ** 30, "launches": launches,
            "syncs": sum(syncs.values()),
            "pts_syncs": sum(pts_syncs.values()),
            "caps": cap_drops(model, requests)}


def gather_agreement(flag, request, init):
    """The flagship's pts_voxel on the gather route against the dense and
    packed routes from one state_dict (`init`), fp32, on `request` cut to
    its first FEW_POINTS points (no cap binds): gather against dense within
    GATHER_VS_DENSE_*, packed against gather within PACKED_VS_DENSE_*
    (K2 rounds the packed encoder's SubM operands to bf16). -> the
    relative errors."""
    import torch
    from coocc_tpu_torch.entry import build_model
    small = request._replace(points_mask=request.points_mask & (
        torch.arange(request.points_mask.shape[1], device="cuda")
        < FEW_POINTS))
    models = {impl: build_model(with_impl(flag, impl), "cuda", init=init)
              for impl in ("gather", "dense", "packed")}
    pv = {impl: m(small, stop_at="pts")["pts_voxel"]
          for impl, m in models.items()}
    cap = flag.pts.max_voxels_test
    sites = [int(s.max()) for s in
             models["gather"].pts_middle_encoder.level_sites]
    if max(sites) > cap:
        raise AssertionError(f"the small request's sites {sites} pass the "
                             f"cap {cap}")
    del models
    out = {"sites": sites}
    for a, b, bmax, bmean in (
            ("gather", "dense", GATHER_VS_DENSE_MAX, GATHER_VS_DENSE_MEAN),
            ("packed", "gather", PACKED_VS_DENSE_MAX, PACKED_VS_DENSE_MEAN)):
        scale = float(pv[b].abs().max())
        err = (pv[a] - pv[b]).abs()
        rel = (float(err.max()) / scale, float(err.mean()) / scale)
        log(f"{a} vs {b} pts_voxel (fp32, {FEW_POINTS} points, sites "
            f"{sites}): max_abs_err {float(err.max()):.6g}, scale "
            f"{scale:.6g}, max {rel[0]:.6g} and mean {rel[1]:.6g} of the "
            f"scale (bounds {bmax}, {bmean})")
        if not (scale > 0 and rel[0] <= bmax and rel[1] <= bmean):
            raise AssertionError(f"{a} pts_voxel differs from {b}")
        out[f"{a}_vs_{b}"] = rel
    return out


def phase_lidar_routes(kernels):
    """The LiDAR encoder's other routes at full width, B=1, each model built
    on the card from the served model's weights (entry.build_model, seed
    0), none falling back to another route: the flagship with
    pts.impl="gather" (the gather-GEMM SparseLiDAREnc8x) served in bf16 (3
    requests, K1 2 and K2 0 launches each, device time of the forward and
    the pts stage by kernel, peak memory, each level's cap drops, the
    synchronizing calls), its pts_voxel against the dense and packed
    routes' on a request of FEW_POINTS points, its bf16 train step (K1 2,
    K2 0 a step; C8: two steps from one state equal bit for bit); the
    flagship's dense train step; coocc_lidar with pts.impl="gather"
    (SparseEncoderHD's rulebook form) served and trained (no K1 or K2);
    SparseLiDAREnc4x as a module on the flagship's 800x800x64 grid at
    max_voxels_test. -> the routes' numbers."""
    import torch
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import build_model, init_weights
    from coocc_tpu_torch.nn.sparse_enc import (SparseLiDAREnc4x,
                                               SparseLiDAREnc8x)
    from coocc_tpu_torch.nn.sparse_encoder_hd import SparseEncoderHD
    from coocc_tpu_torch.ops.sparse_conv import SparseTensor
    from coocc_tpu_torch.ops.voxelize import voxelize
    lap = lap_timer("LiDAR routes")
    nums = {}
    flag = get_config(FLAGSHIP)
    requests = [synthetic_batch(flag, batch_size=1, seed=s).to("cuda")
                for s in range(3)]
    model = build_model(with_impl(flag, "gather"), "cuda", seed=0,
                        dtype=torch.bfloat16)
    if type(model.pts_middle_encoder) is not SparseLiDAREnc8x:
        raise AssertionError("pts.impl='gather' did not give the gather "
                             "encoder")
    log(f"{FLAGSHIP} gather (bf16, as served):")
    nums["flagship_gather"] = gather_serve(model, requests, kernels,
                                           PER_ROUTE)
    # the served weights, for every other model of the flagship's routes
    init = loaded(model.state_dict())
    del model
    torch.cuda.empty_cache()
    lap("flagship gather served")
    nums["flagship_gather"]["agreement"] = gather_agreement(
        flag, requests[0], init)
    torch.cuda.empty_cache()
    lap("gather against dense and packed")
    nums["flagship_gather"]["train"] = phase_train(
        "flagship gather", kernels, cfg=with_impl(flag, "gather"),
        want=PER_ROUTE, c8=True, init=init)
    lap("flagship gather train")
    nums["flagship_dense_train"] = phase_train(
        "flagship dense", kernels, cfg=with_impl(flag, "dense"),
        want=PER_ROUTE, c8=False, init=init)
    del init
    lap("flagship dense train")

    lid = with_impl(get_config(LIDAR), "gather")
    lreq = [synthetic_batch(lid, batch_size=1, seed=s).to("cuda")
            for s in range(3)]
    model = build_model(lid, "cuda", seed=0, dtype=torch.bfloat16)
    if type(model.pts_middle_encoder) is not SparseEncoderHD:
        raise AssertionError("coocc_lidar on pts.impl='gather' did not give "
                             "SparseEncoderHD")
    log(f"{LIDAR} gather (bf16, as served):")
    nums["lidar_gather"] = gather_serve(model, lreq, kernels, NO_KERNELS)
    init = loaded(model.state_dict())
    del model
    torch.cuda.empty_cache()
    lap("coocc_lidar gather served")
    nums["lidar_gather"]["train"] = phase_train(
        "coocc_lidar gather", kernels, cfg=lid, want=NO_KERNELS, c8=False,
        init=init)
    del init
    lap("coocc_lidar gather train")

    # SparseLiDAREnc4x as a module: its 200x200x16 output is not the
    # flagship's fuser grid (the model raises there, as JAX's fuser fails)
    enc = init_weights(SparseLiDAREnc4x(4, 16, 128, flag.pts.sparse_shape_xyz)
                       .to("cuda"), 0).eval()
    cap = flag.pts.max_voxels_test
    sps = []
    for b in requests:
        v = voxelize(b.points[0], b.points_mask[0], flag.point_cloud_range,
                     flag.pts.voxel_size, flag.pts.sparse_shape_xyz,
                     max_voxels=cap,
                     max_points_per_voxel=flag.pts.max_num_points,
                     num_features=flag.pts.input_channel)
        sps.append(SparseTensor(*(t[None] for t in v)))
    with torch.no_grad():
        out = enc(sps[0], cap)
        sync()
        torch.cuda.reset_peak_memory_stats()
        ms = host_ms(lambda sp: enc(sp, cap), sps)
    want = (1, 128) + tuple(s // 4 for s in flag.pts.sparse_shape_xyz)
    if tuple(out.shape) != want or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"Enc4x output {tuple(out.shape)}, want {want}")
    sites = [int(s.max()) for s in enc.level_sites]
    nums["enc4x"] = {"forward_ms": ms, "sites": sites,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"SparseLiDAREnc4x on {flag.pts.sparse_shape_xyz} at {cap} voxels: "
        f"{ms:.3f} ms a forward (median of 3), output {want}, level sites "
        f"{sites} (cap {cap}), peak {nums['enc4x']['peak_gib']:.3f} GiB")
    del enc, out, sps, requests, lreq
    torch.cuda.empty_cache()
    lap("Enc4x")
    return nums


# the lane-major route's grid depth (the 800x800 grid over the flagship's
# point-cloud range): res1 at p=3 (96 lanes) and res2 at p=1 (64 lanes)
# take the narrow SubM route, down2 and down3 the lane-major downsample
LANE_MAJOR_Z = 36
# level 3 floors z 9 -> 4 (JAX's packed encoder); its dropped fifth slice
# reads level-0 slices 25-35 only
LANE_MAJOR_TOP = 25
# a forward: K2 at res3 and conv_out (128 lanes), the narrow route at res1
# and res2; a train step adds K2's dX at those five
PER_LANE_MAJOR = {"subm_ext_conv": 5, "subm_ext_conv_dx": 0,
                  "subm_conv_narrow": 8}
PER_LANE_MAJOR_STEP = {"subm_ext_conv": 5, "subm_ext_conv_dx": 5,
                       "subm_conv_narrow": 8}


def lane_major_k2_checks(label, run):
    """Every K2 call of one `run()` of the lane-major encoder against its
    plain version on the call's own inputs: each forward (the eval seam
    nn/sparse_enc_packed.py:subm_ext_conv and the training one
    ops/subm_conv.py:subm_ext_conv) by k2_check, each dX by k2_dx_check.
    These are res3 and conv_out, at z 4 after the 9 -> 4 floor: shapes no
    other phase gives K2. -> {"fwd": (calls, max abs err), "dx": (calls,
    max abs err)}."""
    from coocc_tpu_torch.nn import sparse_enc_packed
    from coocc_tpu_torch.ops import subm_conv as k2
    kept = {"fwd": [], "dx": []}
    inner = k2.subm_ext_conv, k2.subm_ext_conv_dx

    def keep_fwd(x_pb, w27, p, mcell, bn=None, identity=None):
        kept["fwd"].append((x_pb.detach().clone(), w27.detach().clone(), p,
                            mcell.clone(), bn, None if identity is None
                            else identity.detach().clone()))
        return inner[0](x_pb, w27, p, mcell, bn, identity)

    def keep_dx(dy, w27, p):
        kept["dx"].append((dy.detach().clone(), w27.detach().clone(), p))
        return inner[1](dy, w27, p)
    # the wrappers count their launches on the keep_* functions while the
    # seams are patched; the phase's counts were read before this run
    keep_fwd.launches = keep_dx.launches = 0
    sparse_enc_packed.subm_ext_conv = k2.subm_ext_conv = keep_fwd
    k2.subm_ext_conv_dx = keep_dx
    try:
        run()
        sync()
    finally:
        sparse_enc_packed.subm_ext_conv = k2.subm_ext_conv = inner[0]
        k2.subm_ext_conv_dx = inner[1]
    if not kept["fwd"]:
        raise AssertionError(f"lane-major {label}: no K2 call")
    out = {}
    for kind, calls in kept.items():
        errs = []
        for args in calls:
            if kind == "fwd":
                x, w27, p, mcell, bn, idn = args
                err, scale, _, ok = k2_check(x, w27, p, mcell, bn, idn)
                what = (f"{tuple(x.shape)} p={p} {str(x.dtype)[6:]} "
                        f"{k2_mode(bn, idn)}")
            else:
                err, ok = k2_dx_check(*args)
                scale = float(args[0].abs().max())
                what = (f"dX {tuple(args[0].shape)} p={args[2]} "
                        f"{str(args[0].dtype)[6:]}")
            log(f"lane-major {label} K2 vs plain [{what}]: max_abs_err "
                f"{err:.6g}, scale {scale:.6g}")
            if not ok:
                raise AssertionError(f"lane-major {label}: K2 differs from "
                                     f"its plain version at {what}")
            errs.append(err)
        out[kind] = (len(calls), max(errs, default=0.0))
    del kept
    return out


def phase_lane_major(kernels):
    """The flagship's PackedLiDAREnc8x (base 16 -> 128) alone at an
    800x800x36 grid, the synthetic request's 350,000 points voxelized over
    the flagship's point-cloud range with 36 voxels in z (the model cannot
    run there: its 100x100x4 pts_voxel is not the fuser's 100x100x8), from
    seeded weights (entry.init_weights, seed 0) loaded into encoders built
    on the card: served in fp32 (TF32 off) and bf16, 3 forwards each with
    the launches counted (PER_LANE_MAJOR), host and device ms a forward;
    the fp32 output against the dense twin DenseLiDAREnc8x's from the same
    weights (PACKED_VS_DENSE_MAX / _MEAN; the twin has neither new route)
    on the occupancy below level-0 z slice LANE_MAJOR_TOP, where the
    twin's fifth z slice at level 3, spconv's ceil(9 / 2) that the packed
    encoder floors away as JAX's does, is empty; the bf16 output's
    distance to the fp32 one logged; two bf16 train steps
    of the encoder alone (sum(out * noise), backward) from one state under
    cudnn_deterministic (the narrow route's backward is cuDNN's), their
    launches (PER_LANE_MAJOR_STEP) and outputs, gradients and moved
    statistics equal bit for bit; every K2 call of one forward in each
    dtype and of a third train step (forwards and dX) against its plain
    version on its own inputs (lane_major_k2_checks). -> the numbers."""
    import torch
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import init_weights
    from coocc_tpu_torch.nn.sparse_enc_dense import DenseLiDAREnc8x
    from coocc_tpu_torch.nn.sparse_enc_packed import PackedLiDAREnc8x
    from coocc_tpu_torch.ops.subm_conv import subm_conv_narrow
    from coocc_tpu_torch.ops.voxelize import voxelize_mask
    from coocc_tpu_torch.parallel.train_step import cudnn_deterministic
    lap = lap_timer("lane-major")
    flag = get_config(FLAGSHIP)
    pts, pcr = flag.pts, flag.point_cloud_range
    grid = tuple(pts.sparse_shape_xyz[:2]) + (LANE_MAJOR_Z,)
    vsize = tuple(pts.voxel_size[:2]) + ((pcr[5] - pcr[2]) / LANE_MAJOR_Z,)
    b = synthetic_batch(flag, batch_size=1, seed=0).to("cuda")
    occ = voxelize_mask(b.points[0], b.points_mask[0], pcr, vsize, grid,
                        max_voxels=pts.max_voxels_test)[None]
    widths = (pts.input_channel, pts.base_channel, pts.out_channel)
    sd = init_weights(PackedLiDAREnc8x(*widths), 0).state_dict()
    counted = {"subm_ext_conv": kernels["subm_ext_conv"],
               "subm_ext_conv_dx": kernels["subm_ext_conv_dx"],
               "subm_conv_narrow": subm_conv_narrow}

    def build(cls, dtype):
        with torch.device("cuda"):
            enc = cls(*widths, compute_dtype=dtype)
        enc.load_state_dict(sd)
        return enc.eval()

    def counts():
        return {n: k.launches for n, k in counted.items()}

    def reset():
        for k in counted.values():
            k.launches = 0
    nums = {"grid": grid, "active": int(occ.sum())}
    outs = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        enc = build(PackedLiDAREnc8x, dtype)
        with torch.no_grad():
            enc(occ)                                  # warm-up
            sync()
            reset()
            ms = host_ms(enc, [occ] * 3)
            launches = counts()
            busy = timed_ms(lambda: enc(occ), 3)
            outs[name] = enc(occ).float()
        want = {n: 3 * c for n, c in PER_LANE_MAJOR.items()}
        shape = tuple(outs[name].shape)
        log(f"lane-major encoder {grid} {name}: {ms:.3f} ms a forward "
            f"(host, median of 3), {busy:.3f} ms (device), launches over 3 "
            f"{launches} (want {want}), output {shape}")
        if launches != want:
            raise AssertionError(f"lane-major {name}: launches {launches}")
        if shape != (1, pts.out_channel) + tuple(g // 8 for g in grid) or \
                not bool(torch.isfinite(outs[name]).all()):
            raise AssertionError(f"lane-major {name} output {shape}")
        nums[name] = {"forward_ms": ms, "device_ms": busy,
                      "launches": launches}
        with torch.no_grad():
            nums[name]["k2_vs_plain"] = lane_major_k2_checks(
                name, lambda: enc(occ))
        del enc
        torch.cuda.empty_cache()
    lap("served in fp32 and bf16, K2 against its plain version")
    # the dense twin takes spconv's geometry, ceil(9 / 2) = 5 z slices at
    # level 3, where the packed encoder floors to 4 as JAX's does: on an
    # occupancy without its level-0 slices >= LANE_MAJOR_TOP the twin's
    # fifth slice is empty and the first four are the packed encoder's
    low = occ.clone()
    low[..., LANE_MAJOR_TOP:] = False
    dense = build(DenseLiDAREnc8x, torch.float32)
    packed = build(PackedLiDAREnc8x, torch.float32)
    with torch.no_grad():
        d = dense(low).float()
        p32 = packed(low).float()
    del dense, packed
    if d.shape[-1] != p32.shape[-1] + 1 or bool(d[..., -1].any()):
        raise AssertionError(f"the dense twin's output {tuple(d.shape)} has "
                             "no empty fifth z slice")
    d = d[..., :-1]
    scale = float(d.abs().max())
    err = (p32 - d).abs()
    rel = (float(err.max()) / scale, float(err.mean()) / scale)
    log(f"lane-major packed vs dense pts_voxel (fp32, the {int(low.sum())} "
        f"sites below level-0 z slice {LANE_MAJOR_TOP}): max {rel[0]:.6g} "
        f"and mean {rel[1]:.6g} of max|dense| {scale:.6g} (bounds "
        f"{PACKED_VS_DENSE_MAX}, {PACKED_VS_DENSE_MEAN})")
    if not (scale > 0 and rel[0] <= PACKED_VS_DENSE_MAX
            and rel[1] <= PACKED_VS_DENSE_MEAN):
        raise AssertionError("lane-major packed pts_voxel differs from the "
                             "dense twin's")
    scale32 = float(outs["fp32"].abs().max())
    err16 = (outs["bf16"] - outs["fp32"]).abs()
    nums["vs_dense"] = rel
    nums["bf16_vs_fp32"] = (float(err16.max()) / scale32,
                            float(err16.mean()) / scale32)
    log(f"lane-major bf16 vs fp32 pts_voxel: max {nums['bf16_vs_fp32'][0]:.6g}"
        f" and mean {nums['bf16_vs_fp32'][1]:.6g} of max|fp32| "
        f"{scale32:.6g} (logged)")
    del outs, d, p32, low, err, err16
    lap("against the dense twin")

    enc = build(PackedLiDAREnc8x, torch.bfloat16).train()
    state = {k: v.clone() for k, v in enc.state_dict().items()}
    noise = torch.randn((1, pts.out_channel) + tuple(g // 8 for g in grid),
                        generator=torch.Generator(device="cuda").manual_seed(
                            1), device="cuda")

    def step():
        enc.load_state_dict(state)
        enc.zero_grad(set_to_none=True)
        sync()
        t0 = time.perf_counter()
        out = enc(occ)
        (out * noise).sum().backward()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        return ms, [out.detach()] + [p.grad for p in enc.parameters()
                                     if p.grad is not None] + [
            v.clone() for k, v in enc.state_dict().items() if "running" in k]
    with cudnn_deterministic():
        step()                                        # warm-up
        reset()
        ms1, first = step()
        launches = counts()
        ms2, second = step()
    differ = sum(not torch.equal(x, y) for x, y in zip(first, second))
    log(f"lane-major bf16 train step of the encoder: {ms1:.3f} and "
        f"{ms2:.3f} ms (host), launches {launches} (want "
        f"{PER_LANE_MAJOR_STEP}); two steps from one state: {differ} of "
        f"{len(first)} tensors differ (the output, each gradient, each "
        "moved statistic)")
    if launches != PER_LANE_MAJOR_STEP or differ or len(first) != len(
            second):
        raise AssertionError(f"lane-major train step: launches {launches}, "
                             f"{differ} tensors differ between two steps")
    del first, second
    with cudnn_deterministic():
        k2_vs_plain = lane_major_k2_checks("bf16 train step", step)
    if k2_vs_plain["fwd"][0] != PER_LANE_MAJOR_STEP["subm_ext_conv"] or \
            k2_vs_plain["dx"][0] != PER_LANE_MAJOR_STEP["subm_ext_conv_dx"]:
        raise AssertionError(f"lane-major train step: K2 calls checked "
                             f"{k2_vs_plain}")
    nums["train"] = {"step_ms": (ms1, ms2), "launches": launches,
                     "differing": differ, "k2_vs_plain": k2_vs_plain}
    del enc, state
    torch.cuda.empty_cache()
    lap("two train steps, a third's K2 calls against their plain version")
    return nums


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


# ---------------------------------------------------------------------------
# C8 (the train step repeats) and data parallelism
# ---------------------------------------------------------------------------

# the configs whose step is run twice from one state (C8)
C8_CONFIGS = ("coocc_multi_r50_256x704", "coocc_lidar")
DP_WORLD = 2
DP_STEPS = 3
# SyncBN on a real activation against one process's BatchNorm on the
# concatenated batch: the statistics are summed in other orders (two
# ranks' means averaged against one mean), fp32 rounding of sums over
# millions of values, as fractions of each output's largest magnitude
SYNCBN_REL = 2e-5


def c8_check(name, trainer, batch):
    """C8: two train steps of `trainer` from one state, generator and batch
    (the card's step repeats bit for bit) and the leaves that differ; the
    kernels of one step (no upsample kernel, F.interpolate's, may run).
    What the repaired sites cost against what they replace is
    coocc_tpu_torch/tools/train_repeat.py's to time (PERF.md §6).
    -> (the numbers, the state before the steps)."""
    from coocc_tpu_torch.tools import train_repeat as tr
    lap = lap_timer(f"{name} C8")
    snap = tr.snapshot(trainer)
    first = tr.step_result(trainer, batch)
    tr.restore(trainer, snap)
    diff = tr.differing(first, tr.step_result(trainer, batch))
    del first
    counts = {k: len(v) for k, v in diff.items()}
    log(f"C8 {name}: two bf16 train steps from one state: differing loss "
        f"terms {counts['losses']}, gradient leaves {counts['grads']} of "
        f"{len(list(trainer.model.parameters()))}, moved statistics "
        f"{counts['stats']}, parameters after the update {counts['params']}")
    if any(counts.values()):
        raise AssertionError(f"C8 {name}: two train steps from one state "
                             f"differ: {counts}, the first gradients "
                             f"{diff['grads'][:4]}")
    lap("two steps")
    tr.restore(trainer, snap)
    upsample = sorted(k for k in tr.kernel_ms(lambda: trainer.step(batch))
                      if "upsample" in k)
    tr.restore(trainer, snap)
    log(f"C8 {name}: upsample kernels in one train step: {upsample}")
    if upsample:
        raise AssertionError(f"{name}: the train step still runs "
                             f"F.interpolate's kernels {upsample}")
    lap("the kernels of one step")
    return {"differing": counts, "upsample_kernels": upsample}, snap


def dp_world_one(trainer, batch, snap, repeats: bool):
    """The data-parallel step over an NCCL group of one process against
    the single-device step from the same state, bit for bit: both as they
    run where the step repeats (`repeats`), else both under
    torch.use_deterministic_algorithms, in which it does (C8). -> the
    differing counts (all 0) and the mode."""
    import contextlib
    import tempfile
    import torch.distributed as dist
    from coocc_tpu_torch.tools import train_repeat as tr
    mode = None if repeats else "algorithms"
    with tempfile.TemporaryDirectory() as d, (
            tr.deterministic(mode) if mode else contextlib.nullcontext()):
        tr.restore(trainer, snap)
        one = tr.step_result(trainer, batch)
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                world_size=1, rank=0)
        try:
            tr.restore(trainer, snap)
            dp = tr.step_result(trainer, batch, dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    tr.restore(trainer, snap)
    counts = {k: len(v) for k, v in tr.differing(one, dp).items()}
    log(f"data-parallel step over an NCCL group of 1 against the "
        f"single-device step from one state (deterministic algorithms: "
        f"{bool(mode)}): differing {counts}")
    if any(counts.values()):
        raise AssertionError(f"the world-size-1 data-parallel step departs "
                             f"from the single-device step: {counts}")
    return {"differing": counts, "mode": mode}


def _rank0_copy(t, src):
    """Rank src's t on every rank (a broadcast of a copy)."""
    import torch.distributed as dist
    out = t.detach().clone().contiguous()
    dist.broadcast(out, src)
    return out


def dp_equal_across_ranks(model):
    """Whether every parameter and buffer equals rank 0's bit for bit (a
    broadcast of rank 0's flat copy, compared on each rank; the answers
    combined by a MIN all-reduce)."""
    import torch
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors
    ts = [t.detach() for t in model.state_dict().values()
          if t.dtype == torch.float32]
    flat = _flatten_dense_tensors(ts)
    from coocc_tpu_torch.tools.train_repeat import bits
    ok = torch.equal(bits(_rank0_copy(flat, 0)), bits(flat))
    flag = torch.tensor(int(ok), device=flat.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def dp_syncbn_check(model, batch, mesh):
    """SyncBN at a real shape: the input of the model's first BatchNorm on
    this rank's sample, in fp32, through a
    BatchNorm with that layer's affine under bn_sync_group, forward and
    backward with a seeded cotangent; rank 0 holds the single-process
    BatchNorm on both ranks' rows concatenated: y and dx of each rank, and
    dw, db against the sum of the ranks' own. -> {output: max |err| /
    scale} on rank 0."""
    import torch
    from coocc_tpu_torch.nn.layers import BatchNorm, bn_sync_group
    name, bn = next((n, m) for n, m in model.named_modules()
                    if isinstance(m, BatchNorm))
    seen = []

    class Captured(Exception):
        pass

    def capture(m, args):
        seen.append(args[0].detach())
        raise Captured
    # the first BatchNorm's input comes before any other BatchNorm: an eval
    # forward reaches it with the training forward's values, moves no
    # statistic, and stops there
    hook = bn.register_forward_pre_hook(capture)
    try:
        with torch.no_grad():
            model.eval()(batch)
    except Captured:
        pass
    finally:
        hook.remove()
    x = seen[0].float().contiguous()
    g = torch.randn(x.shape, generator=torch.Generator(mesh.device)
                    .manual_seed(100 + mesh.rank), device=mesh.device)

    def run(x, g, group):
        layer = BatchNorm(x.shape[1], bn.eps).to(mesh.device).train()
        layer.load_state_dict(bn.state_dict())
        x = x.clone().requires_grad_()
        with bn_sync_group(group):
            y = layer(x)
        (y * g).sum().backward()
        return y.detach(), x.grad, layer.weight.grad, layer.bias.grad

    y, dx, dw, db = run(x, g, mesh.group)
    xs = [_rank0_copy(x, r) for r in range(mesh.world)]
    gs = [_rank0_copy(g, r) for r in range(mesh.world)]
    ys = [_rank0_copy(y, r) for r in range(mesh.world)]
    dxs = [_rank0_copy(dx, r) for r in range(mesh.world)]
    dws = [_rank0_copy(dw, r) for r in range(mesh.world)]
    dbs = [_rank0_copy(db, r) for r in range(mesh.world)]
    if mesh.rank != 0:
        return None
    ry, rdx, rdw, rdb = run(torch.cat(xs), torch.cat(gs), None)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    res = {"layer": name, "shape": list(x.shape),
           "y": rel(torch.cat(ys), ry), "dx": rel(torch.cat(dxs), rdx),
           "dw": rel(sum(dws), rdw), "db": rel(sum(dbs), rdb)}
    return res


def dp_rank_worker(steps):
    """One rank of the 2-rank flagship step (spawned; phase_data_parallel):
    its Trainer replica (bf16, seed 0, its own generator), `steps` steps
    on its row of synthetic_batch(cfg, batch_size=2, seed=i) with the
    kernels' counts set to 0 before them and read after them, each
    followed by the bit check of every parameter and statistic against
    rank 0's; ms a step, one profiled step's device busy time (the card is
    shared with the other rank), the gradient all-reduce's bytes and ms,
    the all-reduces of one step (SyncBN's among them), peak memory; the
    SyncBN check and the 2-rank eval's hists against rank 0's one-process
    hists of both samples. -> the rank's numbers."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import FLAGSHIP, Trainer
    from coocc_tpu_torch.ops._build import load_all_kernel_libraries
    from coocc_tpu_torch.ops.knn import knn2
    from coocc_tpu_torch.ops.subm_conv import subm_ext_conv, subm_ext_conv_dx
    from coocc_tpu_torch.ops.window_knn import window_knn
    from coocc_tpu_torch.parallel import train_step as ts
    from coocc_tpu_torch.parallel.mesh import make_mesh, shard_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_all_kernel_libraries()
    kernels = {"window_knn": window_knn, "subm_ext_conv": subm_ext_conv,
               "subm_ext_conv_dx": subm_ext_conv_dx, "knn2": knn2}
    mesh = make_mesh(device_type="cuda")
    cfg = get_config(FLAGSHIP)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, seed=0, steps_per_epoch=steps, mesh=mesh)
    build_s = time.perf_counter() - t0

    def rows(seed):
        return shard_batch(synthetic_batch(cfg, batch_size=mesh.world,
                                           seed=seed), mesh.rank,
                           mesh.world).to(mesh.device)
    batches = [rows(i) for i in range(steps)]
    # the all-reduces of one step: SyncBN's two a BatchNorm call, then the
    # gradients', the loss terms' and the statistics'
    reduces = []
    all_reduce = dist.all_reduce

    def counting(t, *a, **k):
        reduces.append(t.numel() * t.element_size())
        return all_reduce(t, *a, **k)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    step_ms, equal, losses = [], [], []
    for i, b in enumerate(batches):
        if i == 0:
            dist.all_reduce = counting
        sync()
        t1 = time.perf_counter()
        m = trainer.step(b)
        sync()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        dist.all_reduce = all_reduce
        losses.append({k: float(v) for k, v in m.items()})
        equal.append(dp_equal_across_ranks(trainer.model))
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grads_bytes = max(reduces)
    ar_ms = []
    for _ in range(2):
        sync()
        t1 = time.perf_counter()
        ts.average_gradients(trainer.optimizer.params, mesh.group)
        sync()
        ar_ms.append((time.perf_counter() - t1) * 1e3)
    busy = device_breakdown(trainer.step, batches[:1], 0)
    syncbn = dp_syncbn_check(trainer.model, batches[0], mesh)
    eval_batch = synthetic_batch(cfg, batch_size=mesh.world, seed=2000)
    hists = {k: v.cpu().numpy().tolist() for k, v in ts.eval_step(
        trainer.model, shard_batch(eval_batch, mesh.rank, mesh.world)
        .to(mesh.device), cfg, return_logits=False, group=mesh.group)
        .items() if k in ts.HISTS}
    one = None
    if mesh.rank == 0:
        one = {}
        for r in range(mesh.world):
            out = ts.eval_step(trainer.model, shard_batch(
                eval_batch, r, mesh.world).to(mesh.device), cfg,
                return_logits=False)
            for k in ts.HISTS:
                if k in out:
                    h = out[k].cpu().numpy()
                    one[k] = one[k] + h if k in one else h
        one = {k: v.tolist() for k, v in one.items()}
    return {"rank": mesh.rank, "device": str(mesh.device),
            "backend": dist.get_backend(), "build_s": build_s,
            "step_ms": step_ms, "losses": losses, "equal": equal,
            "launches": launches, "peak_gib": peak, "busy_ms": busy,
            "grad_allreduce_bytes": grads_bytes,
            "grad_allreduce_ms": statistics.median(ar_ms),
            "allreduces_a_step": len(reduces),
            "syncbn_allreduces_a_step": len(reduces) - 3,
            "syncbn": syncbn, "hists": hists, "one_process_hists": one}


def phase_data_parallel(kernels, trained):
    """Data parallelism on the card: C8's results and the world-size-1
    step (run in phase_train on the flagship's and coocc_lidar's trainers,
    `trained`), then the flagship's train step over DP_WORLD ranks at full
    width (bf16), DP_STEPS steps (dp_rank_worker). The machine has one
    card, and NCCL refuses two ranks on one device, so the ranks join
    through gloo (asked for by name) and share it; NCCL across 2 cards
    where the host has them. Checks: both ranks bit-equal after each step,
    finite losses, K1 2 / K2 13 / K2's dX 13 launches a step on each rank,
    SyncBN at a real shape within SYNCBN_REL, the 2-rank eval's hists equal
    to one process's of the same two samples. -> the numbers."""
    import torch
    from coocc_tpu_torch.parallel.distributed import spawn_ranks
    lap = lap_timer("data parallel")
    res = {"c8": {n: trained[n]["c8"] for n in C8_CONFIGS},
           "world1": trained[FLAGSHIP]["dp_world1"]}
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count()
                           >= DP_WORLD else [])
    for backend in backends:
        log(f"{DP_WORLD} ranks of the flagship's train step, backend "
            f"{backend}" + (" (asked for: NCCL refuses two ranks on one "
                            "card, and this host has "
                            f"{torch.cuda.device_count()})"
                            if backend == "gloo" else ""))
        ranks = spawn_ranks(dp_rank_worker, DP_WORLD, backend, (DP_STEPS,))
        lap(f"{DP_WORLD} ranks, {backend} (spawn, build, steps, checks)")
        want = {n: DP_STEPS * per for n, per in PER_TRAIN_STEP.items()}
        for r in ranks:
            log(f"rank {r['rank']} on {r['device']} ({r['backend']}): build "
                f"{r['build_s']:.1f} s; step ms "
                f"{[round(t, 3) for t in r['step_ms']]} (median "
                f"{statistics.median(r['step_ms']):.3f}), busy "
                f"{r['busy_ms']} ms, peak {r['peak_gib']:.3f} GiB; "
                f"launches over {DP_STEPS} steps {r['launches']}; gradient "
                f"all-reduce {r['grad_allreduce_bytes']} bytes in "
                f"{r['grad_allreduce_ms']:.3f} ms; {r['allreduces_a_step']} "
                f"all-reduces a step, {r['syncbn_allreduces_a_step']} of "
                f"them SyncBN's; bit-equal to rank 0 after each step "
                f"{r['equal']}; loss_total "
                f"{[round(m['loss_total'], 6) for m in r['losses']]}")
            if r["launches"] != want:
                raise AssertionError(f"rank {r['rank']}: launches "
                                     f"{r['launches']}, want {want}")
            if not all(r["equal"]):
                raise AssertionError(f"rank {r['rank']} departs from rank 0 "
                                     f"after a step: {r['equal']}")
            if not all(math.isfinite(v) for m in r["losses"]
                       for v in m.values()):
                raise AssertionError(f"rank {r['rank']}: {r['losses']}")
            if r["losses"] != ranks[0]["losses"]:
                raise AssertionError("the ranks' loss metrics differ")
        sb = ranks[0]["syncbn"]
        log(f"SyncBN at a real shape ({sb['layer']}, {sb['shape']} a rank, "
            f"fp32): max |err| / scale y {sb['y']:.3g}, dx {sb['dx']:.3g}, "
            f"dw {sb['dw']:.3g}, db {sb['db']:.3g} (bound {SYNCBN_REL})")
        if max(sb[k] for k in ("y", "dx", "dw", "db")) > SYNCBN_REL:
            raise AssertionError(f"SyncBN departs from one process's "
                                 f"BatchNorm: {sb}")
        one = ranks[0]["one_process_hists"]
        for r in ranks:
            if r["hists"] != one:
                raise AssertionError(f"rank {r['rank']}'s {DP_WORLD}-rank "
                                     "eval hists differ from one "
                                     "process's")
        log(f"{DP_WORLD}-rank eval: summed hists ({sorted(one)}) equal one "
            f"process's of the same {DP_WORLD} samples on every rank")
        res[backend] = {k: [r[k] for r in ranks] for k in (
            "step_ms", "busy_ms", "peak_gib", "launches",
            "grad_allreduce_bytes", "grad_allreduce_ms",
            "allreduces_a_step", "syncbn_allreduces_a_step", "build_s")}
        res[backend]["syncbn"] = sb
    return res


def train_phases(kernels, t0):
    """phase_train for every config of TRAIN_CONFIGS, then the flagship's
    train CLI on synthetic batches (one step; coocc_lidar's runs on a
    nuScenes tree in phase_data_path). -> {config: its numbers}."""
    trained = {}
    for name in TRAIN_CONFIGS:
        log(f"[{time.perf_counter() - t0:.1f} s] train path, {name} (bf16, "
            "the config's compute_dtype):")
        trained[name] = phase_train(name, kernels)
    log(f"[{time.perf_counter() - t0:.1f} s] train CLI, {FLAGSHIP} "
        "(synthetic):")
    trained[FLAGSHIP]["train_cli_eval_ms"] = phase_train_cli(FLAGSHIP)
    log("train steps (step ms median, device busy ms, peak GiB, launches "
        "over 3 steps): " + json.dumps(
            {n: {k: v for k, v in t.items() if k not in ("fwd", "dx")}
             for n, t in trained.items()}))
    return trained


def train_rows(trained, k1_row, k2_row):
    """The train path's entries of the kernels' JSON line: K1's and K2's
    launches over each config's 3 measured steps, K2's mask-only forward
    in training by config, and K2's dX row (the flagship's at the top,
    the other configs' under "configs")."""
    for row in (k1_row, k2_row):
        row["train_launches"] = {n: t["launches"][row["name"]]
                                 for n, t in trained.items()}
    k2_row["train"] = {n: t["fwd"] for n, t in trained.items() if "fwd" in t}
    k2_row["train_one_call"] = {n: {"max_abs_err": t["one_call"]["fwd"]}
                                for n, t in trained.items()
                                if "one_call" in t}
    flag = trained[FLAGSHIP]
    return {"name": "subm_ext_conv_dx", "route": "cuda",
            "source": "coocc_tpu_torch/csrc/subm_conv.cuh",
            "replaces": "coocc_tpu/ops/pallas/subm_conv.py:107 (its VJP, "
                        "which JAX takes through coocc_tpu/nn/"
                        "sparse_enc_packed.py:431-433)",
            "launches": flag["launches"]["subm_ext_conv_dx"],
            **{k: v for k, v in flag["dx"].items()
               if k != "launches_per_step"},
            "dtype": "bfloat16", "dW_ms": flag["dW_ms"],
            "configs": {n: {"launches": t["launches"]["subm_ext_conv_dx"],
                            **t["dx"], "dW_ms": t["dW_ms"]}
                        for n, t in trained.items()
                        if n != FLAGSHIP and "dx" in t},
            "one_call": {n: {"launches": t["launches"]["subm_ext_conv_dx"],
                             "max_abs_err": t["one_call"]["dx"]}
                         for n, t in trained.items() if "one_call" in t}}


# The Swin route: the flagship with its image backbone set to Swin-T, as
# JAX's tests/test_swin_model.py builds it (no config registers it, in JAX
# or here)
SWIN_LABEL = f"{FLAGSHIP} + Swin-T"


def swin_flagship_config():
    """The flagship with img_backbone SwinTransformer (the config's Swin-T
    defaults: embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24), window
    7) and its stage widths (96, 192, 384, 768) into the neck."""
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.config.base import ImageBackboneConfig
    cfg = get_config(FLAGSHIP)
    return dataclasses.replace(
        cfg, img_backbone=ImageBackboneConfig(type="SwinTransformer"),
        img_neck=dataclasses.replace(cfg.img_neck,
                                     in_channels=(96, 192, 384, 768)))


def phase_swin(kernels):
    """The Swin route at full width, B=1: served as the flagship is (bf16,
    entry.served_model, seeded weights) for 3 requests with the counts set
    to 0 before them and read after them (K1 2, K2 13 a request), request
    ms, device busy per request of the forward and of its img prefix (the
    backbone's stage: Swin-T, SECONDFPN, the depth net and the splat),
    peak memory; K1 and K2 on one call each against their plain versions;
    then phase_train's 3 bf16 train steps (K1 2, K2 13, K2's dX 13 a step,
    finite losses, moved parameters and BN statistics, a profiled step)
    and C8 (two steps from one state equal bit for bit). -> the numbers."""
    import torch
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import served_model
    from coocc_tpu_torch.nn.swin import SwinTransformer
    lap = lap_timer("Swin route")
    cfg = swin_flagship_config()
    model = served_model(cfg, "cuda")
    if type(model.img_backbone) is not SwinTransformer \
            or model.dtype != torch.bfloat16:
        raise AssertionError(f"{SWIN_LABEL}: {type(model.img_backbone)} in "
                             f"{model.dtype}")
    requests = [synthetic_batch(cfg, batch_size=1, seed=s).to("cuda")
                for s in range(3)]
    log(f"{SWIN_LABEL} (bf16, as served):")
    launches, req_ms, peak, _ = serve_requests(model, requests, kernels,
                                               PER_REQUEST, keep=False)
    log(f"profile, {SWIN_LABEL} (device time by kernel):")
    busy = device_breakdown(model, requests, 12)
    log(f"profile, {SWIN_LABEL} img prefix (device time by kernel):")
    img_busy = device_breakdown(lambda b: model(b, stop_at="img"),
                                requests, 8)
    nums = {"launches": launches, "request_ms": statistics.median(req_ms),
            "device_busy_ms": busy, "img_busy_ms": img_busy,
            "peak_gib": peak / 2 ** 30}
    lap("build, serve and profiles")
    nums.update(one_call_checks(SWIN_LABEL, model, requests[0]))
    lap("K1 and K2 on one call each")
    del model, requests
    torch.cuda.empty_cache()
    nums["train"] = phase_train(SWIN_LABEL, kernels, cfg=cfg,
                                want=PER_TRAIN_STEP, c8=True)
    lap("train steps and C8")
    return nums


def phase_swin_fingerprint():
    """The card's fp32 Swin-T (TF32 off) on one 256x704 camera against
    JAX's (coocc_tpu_torch/parity/swin_real.npz, written on a CPU by
    tests/test_torch_swin.py): the weights' and the image's digests, then
    each stage's output within 2x (max) and 1.5x (mean) of the CPU port's
    own distance to JAX (`parity.check`, its floors 1e-3 and 1e-4 of the
    scale). Every stage pads its tokens at this shape. -> check's rows."""
    import torch
    from coocc_tpu_torch import parity
    t0 = time.perf_counter()
    fp = parity.load(parity.SWIN)
    model, x = parity.swin_inputs("cuda")
    if parity.state_digest(model) != str(fp["state_digest"]) or \
            parity.digest({"x": x.cpu().numpy()}) != str(fp["input_digest"]):
        raise AssertionError("the Swin fingerprint's digests differ")
    res = parity.check(fp, "fp32", parity.swin_outputs(model, x), 1)
    for key, (dmax, dmean), (pmax, pmean), ok in res:
        log(f"real-shape parity Swin-T fp32 {key}: card max {dmax:.6g} "
            f"mean {dmean:.6g}; cpu port max {pmax:.6g} mean {pmean:.6g} "
            f"({'ok' if ok else 'FAIL'})")
    del model, x
    torch.cuda.empty_cache()
    if not all(r[3] for r in res):
        raise AssertionError(f"Swin-T differs from JAX's fingerprint: {res}")
    log(f"real-shape parity Swin-T: digests equal, within the bounds "
        f"({time.perf_counter() - t0:.1f} s)")
    return res


# the envelope's other modules, card against host: max |card - host| at
# most this share of max |host| (fp32, TF32 off on both)
MODULE_REL = 1e-4


def module_cases():
    """[(name, module or function, host inputs)] at realistic shapes, the
    modules with seeded weights (entry.init_weights) in eval mode:
    EfficientNet-b0 on 6x3x256x704; SECONDFPN2, GeneralizedLSSFPN and
    FPNRender on the R50 pyramid of a 6x256x704 request (256/512/1024/2048
    channels at strides 4/8/16/32); AddFuser, AttnFuser,
    TemporalBEVConcat (a rotated, translated ego motion) and
    OccupancyEncoder (its default widths) on [1, 128, 100, 100, 8], the
    flagship's fuser grid; MoE on 80,000 tokens of 128; FLoSP of one
    camera's 128x16x44 feature into the 200x200x16 grid."""
    import torch
    from coocc_tpu_torch.entry import init_weights
    from coocc_tpu_torch.models.temporal import TemporalBEVConcat
    from coocc_tpu_torch.nn.alt_fusers import AddFuser, AttnFuser
    from coocc_tpu_torch.nn.alt_necks import (FPNRender, GeneralizedLSSFPN,
                                              SECONDFPN2)
    from coocc_tpu_torch.nn.efficientnet import EfficientNet
    from coocc_tpu_torch.nn.flosp import flosp
    from coocc_tpu_torch.nn.moe import MoE
    from coocc_tpu_torch.nn.occnet import OccupancyEncoder
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    def mod(m, seed):
        return init_weights(m, seed).eval()
    r50 = (256, 512, 1024, 2048)
    pyramid = [randn(6, c, 256 // s, 704 // s)
               for c, s in zip(r50, (4, 8, 16, 32))]
    img, pts = randn(1, 128, 100, 100, 8), randn(1, 128, 100, 100, 8)
    a = 0.05
    rot = torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                        [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])
    poses = (torch.eye(3).expand(1, 6, 3, 3), torch.zeros(1, 6, 3),
             rot.expand(1, 6, 3, 3), torch.tensor([1.7, -0.6, 0.1]).expand(
                 1, 6, 3))
    V = 200 * 200 * 16
    pix = torch.stack([torch.randint(-4, 48, (V,), generator=g),
                       torch.randint(-4, 20, (V,), generator=g)], 1)
    fov = torch.rand(V, generator=g) < 0.7
    return [
        ("EfficientNet-b0", mod(EfficientNet("b0"), 1),
         (randn(6, 3, 256, 704),)),
        ("SECONDFPN2", mod(SECONDFPN2(r50, (128,) * 4,
                                      (0.25, 0.5, 1, 2)), 2), (pyramid,)),
        ("GeneralizedLSSFPN", mod(GeneralizedLSSFPN(r50, 256), 3),
         (pyramid,)),
        ("FPNRender", mod(FPNRender(r50, 256), 4), (pyramid,)),
        ("AddFuser", mod(AddFuser(128, 128), 5), (img, pts)),
        ("AttnFuser", mod(AttnFuser(128, 128, 4), 6), (img, pts)),
        ("OccupancyEncoder", mod(OccupancyEncoder(128), 7), (img,)),
        ("MoE", mod(MoE(128), 8), (randn(80_000, 128),)),
        ("TemporalBEVConcat", TemporalBEVConcat(),
         (img, pts, *poses, (1.024, 1.024), (-50.688, -50.688))),
        ("FLoSP", flosp, (randn(128, 16, 44), pix, fov, (200, 200, 16))),
    ]


def _on(x, device):
    """Tensors (in lists and tuples too) moved to `device`."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)) and any(
            isinstance(v, torch.Tensor) for v in x):
        return type(x)(_on(v, device) for v in x)
    return x


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _shapes(args):
    """The shapes of the tensors in args (lists and tuples opened)."""
    out = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out += _shapes(a)
        elif hasattr(a, "shape"):
            out.append(tuple(a.shape))
    return out


def phase_modules():
    """Each module of module_cases once on the card against the same
    module (the same weights) on the host's CPU, the route the tests hold
    against JAX (tests/test_torch_alt_modules.py): every output within
    MODULE_REL of its scale; the card's time of one call (CUDA events,
    median of 3). -> {name: {"ms", "rel_err"}}."""
    import copy
    import torch
    t0 = time.perf_counter()
    res = {}
    for name, fn, args in module_cases():
        with torch.no_grad():
            host = _flat(fn(*args))
            card_fn = copy.deepcopy(fn).to("cuda") \
                if isinstance(fn, torch.nn.Module) else fn
            card_args = [_on(a, "cuda") for a in args]
            card = _flat(card_fn(*card_args))
            rel = max(float((c.cpu() - h).abs().max() / h.abs().max())
                      for c, h in zip(card, host))
            ms = timed_ms(lambda: card_fn(*card_args), 3)
        log(f"module {name} on {_shapes(args)} -> {_shapes(host)}: card "
            f"against host max |diff| / max |host| {rel:.3g} (bound "
            f"{MODULE_REL}), card {ms:.3f} ms a call")
        if not rel <= MODULE_REL or not all(
                bool(torch.isfinite(c).all()) for c in card):
            raise AssertionError(f"module {name}: the card departs from the "
                                 f"host by {rel:.3g} of the scale")
        res[name] = {"ms": ms, "rel_err": rel}
        del card_fn, card_args, card, host
        torch.cuda.empty_cache()
    log(f"modules card against host took {time.perf_counter() - t0:.1f} s")
    return res


# the rest of the capability envelope (ops/ms_deform_attn.py,
# nn/image2bev.py, nn/mask2former_occ.py, models/render_ray.py,
# utils/native.py): card against host within MODULE_REL of the scale, fp32
# with TF32 off, seeded weights (entry.init_weights), B = 1
ENVELOPE_REPS = 3


def flagship_lidar2img(batch):
    """[1, N, 4, 4] lidar2img of a request's calibration: K [R^T | -R^T t]
    (R, t camera -> ego; the synthetic request's LiDAR frame is the ego
    frame), numpy."""
    import numpy as np
    R, t, K = (np.asarray(a[0], np.float64) for a in (
        batch.rots, batch.trans, batch.intrins))
    N = R.shape[0]
    ext = np.tile(np.eye(4), (N, 1, 1))
    ext[:, :3, :3] = R.transpose(0, 2, 1)
    ext[:, :3, 3] = -np.einsum("nji,nj->ni", R, t)
    k4 = np.tile(np.eye(4), (N, 1, 1))
    k4[:, :3, :3] = K
    return (k4 @ ext)[None].astype(np.float32)


def _rel(card, host):
    """max over the outputs of max |card - host| / max |host|."""
    return max(float((c.cpu() - h).abs().max() / h.abs().max())
               for c, h in zip(card, host))


def _check(name, rel, card):
    import torch
    if not rel <= MODULE_REL or not all(bool(torch.isfinite(c).all())
                                        for c in card):
        raise AssertionError(f"envelope {name}: the card departs from the "
                             f"host by {rel:.3g} of the scale")


def _card_host(name, module, args, flat, keep=lambda t: t):
    """module(*args) on the host's CPU and a copy on the card, `flat` of
    each output, compared on keep(output) -> SimpleNamespace(card, host
    (the outputs), rel, ms (the card's a call), module, args (the card's),
    peak (GiB of one card call))."""
    import copy
    import types
    import torch
    with torch.no_grad():
        host = flat(module(*args))
        card_m = copy.deepcopy(module).to("cuda")
        card_args = [_on(a, "cuda") for a in args]
        torch.cuda.reset_peak_memory_stats()
        card = flat(card_m(*card_args))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rel = _rel([keep(c) for c in card], [keep(h) for h in host])
        ms = timed_ms(lambda: card_m(*card_args), ENVELOPE_REPS)
    _check(name, rel, card)
    return types.SimpleNamespace(card=card, host=host, rel=rel, ms=ms,
                                 module=card_m, args=card_args, peak=peak)


def _grad_repeat(name, fn, leaves):
    """Two backward passes of sum(fn() * a fixed cotangent) on the card:
    every gradient leaf (inputs and parameters) bit-equal, else the run
    fails. -> (leaves compared, peak GiB of one pass)."""
    import torch
    grads = []
    cot = None
    for _ in range(2):
        for p in leaves:
            p.grad = None
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        if cot is None:
            g = torch.Generator(device="cuda").manual_seed(7)
            cot = torch.randn(out.shape, generator=g, device="cuda")
        (out * cot).sum().backward()
        sync()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        grads.append([p.grad.clone() for p in leaves])
        del out
    differ = sum(not torch.equal(a, b) for a, b in zip(*grads))
    log(f"envelope {name} backward twice: {differ} of {len(leaves)} "
        f"gradient leaves differ, peak {peak:.3f} GiB a pass")
    if differ:
        raise AssertionError(f"envelope {name}: two backward passes differ "
                             f"in {differ} leaves")
    for p in leaves:
        p.grad = None
    return len(leaves), peak


def phase_envelope():
    """The rest of the capability envelope at real shapes, B = 1, fp32,
    each on the card against the same weights on the host's CPU (within
    MODULE_REL of the scale) and timed on the card (CUDA events, median of
    ENVELOPE_REPS):
      * MSDeformAttn3D (128 wide, 4 heads, 3 levels, 4 points): 80,000
        queries at the cell centres of the flagship's 100x100x8 fuser grid
        over levels of 100x100x8, 50x50x4 and 25x25x2;
      * Image2BEVTransformer (256 wide, 8 heads, 4 levels, 6 cameras, a
        128x128 BEV grid over nuScenes' range) on 256-channel maps of six
        cameras at 32x88, 16x44, 8x22 and 4x11 (strides 8-64 of 256x704),
        lidar2img from the synthetic flagship request's calibration: 3
        layers timed on the card, the card held against the host at 1
        layer (the host's 3-layer forward takes about 25 s);
      * Mask2FormerOccHead (128 wide, 100 queries, 9 decoder layers, 3
        levels) on 200x200x16, 100x100x8, 50x50x4, 25x25x2: every stage's
        classes and masks and occ, then forward_lidarseg of the request's
        245,000 points;
      * render_rays: 4,224 rays, 112 stratified and 32 importance samples,
        deterministic, features grid_sample_3d of a [200, 200, 16, 32]
        volume, a fixed linear head;
      * two backward passes of MSDeformAttn3D and of the 1-layer
        transformer, bit-equal;
      * torch.profiler of the 3-layer transformer's and the head's forward
        by kernel name;
      * the native host library (g++ on this machine) against its numpy
        versions on the flagship request's cloud.
    -> {name: numbers}."""
    import numpy as np
    import torch
    from coocc_tpu_torch.config import get_config
    from coocc_tpu_torch.data.synthetic import synthetic_batch
    from coocc_tpu_torch.entry import FLAGSHIP, init_weights
    from coocc_tpu_torch.models import render_ray
    from coocc_tpu_torch.nn.image2bev import (Image2BEVTransformer,
                                              get_reference_points_3d,
                                              point_sampling)
    from coocc_tpu_torch.nn.mask2former_occ import (Mask2FormerOccHead,
                                                    _maxpool_to,
                                                    forward_lidarseg)
    from coocc_tpu_torch.ops.grid_sample import grid_sample_3d
    from coocc_tpu_torch.ops.ms_deform_attn import MSDeformAttn3D
    from coocc_tpu_torch.utils import native
    t0 = time.perf_counter()
    res = {}
    g = torch.Generator().manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    # --- MSDeformAttn3D ---------------------------------------------------
    X, Y, Z = 100, 100, 8
    cx, cy, cz = torch.meshgrid(
        (torch.arange(X) + 0.5) / X, (torch.arange(Y) + 0.5) / Y,
        (torch.arange(Z) + 0.5) / Z, indexing="ij")
    refs = torch.stack([cx, cy, cz], -1).reshape(1, -1, 3)
    levels = [randn(1, 128, X // s, Y // s, Z // s) for s in (1, 2, 4)]
    q = randn(1, X * Y * Z, 128)
    msda = init_weights(MSDeformAttn3D(), 21).eval()
    args = (q, levels, refs)
    r = _card_host("MSDeformAttn3D", msda, args, _flat)
    log(f"envelope MSDeformAttn3D on {_shapes(args)}: card against host "
        f"{r.rel:.3g} (bound {MODULE_REL}), card {r.ms:.3f} ms a call, "
        f"peak {r.peak:.3f} GiB")
    qg = r.args[0].clone().requires_grad_()
    lg = [v.clone().requires_grad_() for v in r.args[1]]
    n, gpeak = _grad_repeat(
        "MSDeformAttn3D", lambda: r.module(qg, lg, r.args[2]),
        [qg, *lg, *r.module.parameters()])
    res["MSDeformAttn3D"] = {"ms": r.ms, "rel_err": r.rel, "peak_gib": r.peak,
                             "grad_leaves": n, "grad_peak_gib": gpeak}
    del r, qg, lg, msda, levels, q
    torch.cuda.empty_cache()

    # --- Image2BEVTransformer ---------------------------------------------
    cfg = get_config(FLAGSHIP)
    request = synthetic_batch(cfg, batch_size=1, seed=0)
    l2i = torch.from_numpy(flagship_lidar2img(request))
    feats = [randn(1, 6, 256, h, w) for h, w in ((32, 88), (16, 44),
                                                  (8, 22), (4, 11))]
    img = tuple(cfg.data.input_size)
    i2b3 = init_weights(Image2BEVTransformer(), 22).eval().to("cuda")
    ref3d = torch.from_numpy(get_reference_points_3d(128, 128, 8.0, 4))
    pc_range = i2b3.encoder.pc_range
    _, bev_mask = point_sampling(ref3d, pc_range, l2i, img)
    _, card_mask = point_sampling(ref3d.cuda(), pc_range, l2i.cuda(), img)
    hits = bev_mask.any(-1)                            # [1, N, Q]
    hit_share = float(hits.any(1).float().mean())
    cams_a_pillar = float(hits.sum(1).float().mean())
    # a projection on an image's edge may fall in on one device and out on
    # the other: such a pillar's query reads other cameras there, so the
    # 1-layer comparison (where a query's output depends on its own
    # pillar's hits alone) leaves it out
    agree = (card_mask.cpu() == bev_mask).all(-1).all(1)[0]   # [Q]
    feats_c, l2i_c = [f.cuda() for f in feats], l2i.cuda()
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        out3 = i2b3(feats_c, l2i_c, img)
        peak3 = torch.cuda.max_memory_allocated() / 2 ** 30
        if not bool(torch.isfinite(out3).all()):
            raise AssertionError("envelope Image2BEVTransformer: a "
                                 "non-finite output")
        ms3 = timed_ms(lambda: i2b3(feats_c, l2i_c, img), ENVELOPE_REPS)
    log(f"envelope Image2BEVTransformer (3 layers) on {_shapes(feats)}: "
        f"{100 * hit_share:.1f}% of the {hits.shape[-1]:,} pillars hit a "
        f"camera ({cams_a_pillar:.2f} cameras a pillar; the card's hit mask "
        f"differs from the host's at {int((~agree).sum())} pillars), card "
        f"{ms3:.3f} ms a call, peak {peak3:.3f} GiB")
    log("  profile of its forward (device time by kernel):")
    with torch.no_grad():
        busy3 = device_breakdown(lambda _: i2b3(feats_c, l2i_c, img),
                                 [None], 12)
    del out3, i2b3
    torch.cuda.empty_cache()
    i2b1 = init_weights(Image2BEVTransformer(num_layers=1), 23).eval()
    args = (feats, l2i, img)
    r = _card_host("Image2BEVTransformer", i2b1, args, _flat,
                   keep=lambda t: t.cpu()[:, agree])
    log(f"envelope Image2BEVTransformer (1 layer) card against host "
        f"{r.rel:.3g} over {int(agree.sum()):,} queries (bound "
        f"{MODULE_REL}), card {r.ms:.3f} ms a call")
    fg = [f.clone().requires_grad_() for f in r.args[0]]
    n, gpeak = _grad_repeat(
        "Image2BEVTransformer (1 layer)",
        lambda: r.module(fg, r.args[1], img),
        [*fg, *r.module.parameters()])
    res["Image2BEVTransformer"] = {
        "ms": ms3, "busy_ms": busy3, "peak_gib": peak3, "ms_1_layer": r.ms,
        "rel_err_1_layer": r.rel, "hit_share": hit_share,
        "cameras_a_pillar": cams_a_pillar,
        "hit_mask_differs": int((~agree).sum()), "grad_leaves": n,
        "grad_peak_gib": gpeak}
    del r, fg, i2b1, feats, feats_c
    torch.cuda.empty_cache()

    # --- Mask2FormerOccHead -----------------------------------------------
    pyramid = [randn(1, 128, 200 // s, 200 // s, 16 // s)
               for s in (1, 2, 4, 8)]
    head = init_weights(Mask2FormerOccHead(), 24).eval()

    def head_flat(out):
        return [*out["cls_preds"], *out["mask_preds"], out["occ"]]
    r = _card_host("Mask2FormerOccHead", head, (pyramid,), head_flat)
    # the attention masks each stage hands the next (sigmoid of the
    # max-pooled mask < 0.5), card against host: a flip moves every later
    # stage
    sizes = [tuple(p.shape[2:]) for p in pyramid[1:][::-1]]
    flips = [int(((torch.sigmoid(_maxpool_to(c.cpu(), sz)) < 0.5)
                  != (torch.sigmoid(_maxpool_to(h, sz)) < 0.5)).sum())
             for i, (c, h) in enumerate(zip(r.card[10:19], r.host[10:19]))
             for sz in [sizes[i % 3]]]
    log(f"envelope Mask2FormerOccHead on {_shapes([pyramid])}: "
        f"{len(r.card) - 1} class and mask stages and occ "
        f"{tuple(r.card[-1].shape)}, card against host {r.rel:.3g} (bound "
        f"{MODULE_REL}), card {r.ms:.3f} ms a call, peak {r.peak:.3f} GiB; "
        f"attention-mask entries that differ, stage by stage: {flips}")
    log("  profile of its forward (device time by kernel):")
    with torch.no_grad():
        busy = device_breakdown(lambda _: r.module(r.args[0]), [None], 12)
    pts = torch.from_numpy(request.points[0][request.points_mask[0]])
    pts_c = pts.cuda()
    cls_c, mask_c = r.card[9], r.card[19]
    with torch.no_grad():
        seg_h = forward_lidarseg(cls_c.cpu(), mask_c.cpu(), [pts],
                                 pc_range=cfg.point_cloud_range)
        seg_c = forward_lidarseg(cls_c, mask_c, [pts_c],
                                 pc_range=cfg.point_cloud_range)
        seg_rel = _rel([seg_c], [seg_h])
        seg_ms = timed_ms(lambda: forward_lidarseg(
            cls_c, mask_c, [pts_c], pc_range=cfg.point_cloud_range),
            ENVELOPE_REPS)
    _check("forward_lidarseg", seg_rel, [seg_c])
    log(f"envelope forward_lidarseg of {pts.shape[0]:,} points: card "
        f"against host {seg_rel:.3g}, card {seg_ms:.3f} ms a call")
    res["Mask2FormerOccHead"] = {
        "ms": r.ms, "busy_ms": busy, "rel_err": r.rel, "peak_gib": r.peak,
        "mask_flips": flips, "lidarseg_ms": seg_ms,
        "lidarseg_rel_err": seg_rel}
    del r, head, pyramid, seg_c, cls_c, mask_c
    torch.cuda.empty_cache()

    # --- render_rays --------------------------------------------------------
    rays = 4224
    cams = torch.from_numpy(np.asarray(request.trans[0]))
    ray_o = cams.repeat_interleave(rays // cams.shape[0], 0)
    ray_d = randn(rays, 3)
    ray_d[:, 2] *= 0.1
    ray_d = ray_d / ray_d.norm(dim=-1, keepdim=True)
    vol = randn(1, 200, 200, 16, 32)
    head_w = randn(32, 4) * 0.2
    lo = torch.tensor(cfg.point_cloud_range[:3])
    hi = torch.tensor(cfg.point_cloud_range[3:])

    class RayField(torch.nn.Module):
        """render_rays over a feature volume: grid_sample_3d of vol (its
        [X, Y, Z, C] read as [D, H, W, C]: the grid is (z, y, x)) and a
        linear head, rgb sigmoid and sigma a tenth of softplus: a
        translucent medium, where every bin keeps a share of the weight
        (an importance sample in a bin of nearly none moves by ulp(cdf)
        over its share)."""

        def __init__(self):
            super().__init__()
            for name, t in (("vol", vol), ("w", head_w), ("lo", lo),
                            ("hi", hi)):
                self.register_buffer(name, t)

        def feature_fn(self, p):
            R, S, _ = p.shape
            grid = ((p - self.lo) / (self.hi - self.lo) * 2 - 1).flip(-1)
            return grid_sample_3d(self.vol, grid.reshape(1, R * S, 3))[
                0].reshape(R, S, -1)

        def rgb_sigma_fn(self, f):
            o = f @ self.w
            return torch.sigmoid(o[..., :3]), \
                torch.nn.functional.softplus(o[..., 3]) * 0.1

        def forward(self, o, d):
            return render_ray.render_rays(o, d, self.feature_fn,
                                          self.rgb_sigma_fn, 0.5, 50.0,
                                          n_samples=112, n_importance=32)
    keys = ("rgb", "depth", "rgb_fine", "depth_fine")
    r = _card_host("render_rays", RayField(), (ray_o, ray_d),
                   lambda out: [out[k] for k in keys])
    log(f"envelope render_rays: {rays:,} rays x (112 + 32) samples: card "
        f"against host {r.rel:.3g}, card {r.ms:.3f} ms a call")
    res["render_rays"] = {"ms": r.ms, "rel_err": r.rel}
    del r, vol
    torch.cuda.empty_cache()

    # --- the native host library -------------------------------------------
    tb = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - tb
    cloud = np.ascontiguousarray(request.points[0][request.points_mask[0]])
    R0, tr0, K0 = (np.asarray(a[0, 0]) for a in (
        request.rots, request.trans, request.intrins))
    cam = (cloud[:, :3] - tr0) @ R0                     # ego -> camera 0
    uvd = np.concatenate([cam[:, :2] / np.maximum(cam[:, 2:3], 1e-5)
                          @ K0[:2, :2].T + K0[:2, 2], cam[:, 2:3]],
                         1).astype(np.float32)
    H, W = cfg.data.input_size
    occ_range, occ_grid = cfg.point_cloud_range, (200, 200, 16)
    coords = np.floor((cloud[:, :3] - np.asarray(occ_range[:3])) / (
        (np.asarray(occ_range[3:]) - occ_range[:3]) / occ_grid)).astype(
            np.int64)
    coords = coords[((coords >= 0) & (coords < occ_grid)).all(1)]
    labels = np.random.RandomState(5).randint(0, 17, len(coords))
    vox = (cloud, cfg.point_cloud_range, cfg.pts.voxel_size,
           cfg.pts.sparse_shape_xyz)
    calls = {
        "zbuffer_depth": lambda impl: native.zbuffer_depth(uvd, H, W,
                                                           impl=impl),
        "majority_vote": lambda impl: native.majority_vote(
            coords, labels, occ_grid, impl=impl),
        "voxelize_mean": lambda impl: native.voxelize_mean(
            *vox, 10, cfg.pts.max_voxels_test, impl=impl)}
    nres = {"build_s": build_s}
    for name, call in calls.items():
        ts = {}
        outs = {}
        for impl in ("native", "numpy"):
            tc = time.perf_counter()
            outs[impl] = call(impl)
            ts[impl] = (time.perf_counter() - tc) * 1e3
        a, b = outs["native"], outs["numpy"]
        if name == "voxelize_mean":
            n = a[2]
            order = np.argsort(a[0][:n])
            ok = (n == b[2] and np.array_equal(a[0][:n][order], b[0][:n])
                  and np.allclose(a[1][:n][order], b[1][:n], rtol=1e-5,
                                  atol=1e-5))
            what = f"{n:,} voxels"
        else:
            ok = np.array_equal(a, b)
            what = f"{int((a != 0).sum()):,} non-zero cells"
        log(f"envelope native {name} on {len(cloud):,} points: {what}, "
            f"native {ts['native']:.2f} ms, numpy {ts['numpy']:.2f} ms, "
            f"{'equal' if ok else 'DIFFER'}")
        if not ok:
            raise AssertionError(f"native {name} differs from its numpy "
                                 "version")
        nres[name] = {"native_ms": ts["native"], "numpy_ms": ts["numpy"]}
    res["native"] = nres
    log(f"envelope took {time.perf_counter() - t0:.1f} s (native build "
        f"{build_s:.2f} s)")
    return res



def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    t0 = time.perf_counter()
    sys.path.insert(0, ROOT)
    from coocc_tpu_torch import parity
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
    # the parity phases' numpy weights, drawn from here on beside the card's
    # work (after the request timings of the host-bound served path)
    weights = ParityWeights((FLAGSHIP, parity.GATHER, parity.TRAIN,
                             OPENOCC, LIDAR, STEREO, KITTI))
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
              "source": "coocc_tpu_torch/csrc/subm_conv.cuh",
              "replaces": "coocc_tpu/ops/pallas/subm_conv.py:53",
              "launches": launches["subm_ext_conv"], "max_abs_err": k2_err,
              **k2_times16, "dtype": "bfloat16",
              "fp32": {"launches": launches32["subm_ext_conv"],
                       "max_abs_err": k2_err32, **k2_times32}}
    rows = [k1_row, k2_row, k3_row]
    for row in (k1_row, k3_row):
        row["launches"] = launches[row["name"]]
    log(f"[{time.perf_counter() - t0:.1f} s] bench and tiny config:")
    phase_bench(FLAGSHIP)
    phase_tiny_agreement()
    log(f"[{time.perf_counter() - t0:.1f} s] real-shape parity against JAX's "
        "fingerprint:")
    phase_real_shape_parity(FLAGSHIP, weights)
    log(f"[{time.perf_counter() - t0:.1f} s] the gather route's capped "
        "pts_voxel against JAX's fingerprint:")
    phase_real_shape_parity(parity.GATHER, weights)
    log(f"[{time.perf_counter() - t0:.1f} s] a full-width train step "
        "against JAX's fingerprint:")
    train_fp = phase_train_fingerprint(weights)
    log("train fingerprint: " + json.dumps(train_fp))
    trained = train_phases(kernels, t0)
    dx_row = train_rows(trained, k1_row, k2_row)
    rows.insert(2, dx_row)
    phase_tiny_train_agreement()
    log(f"[{time.perf_counter() - t0:.1f} s] the epoch loop (bf16, eval hook, "
        "checkpoint, test CLI):")
    loop_launches = phase_loop(kernels)
    for row in rows:
        row["loop_launches"] = loop_launches[row["name"]]
    t_dp = time.perf_counter()
    log(f"[{t_dp - t0:.1f} s] data parallelism (C8, the step over a group "
        f"of one, the flagship over {DP_WORLD} ranks):")
    dp = phase_data_parallel(kernels, trained)
    log(f"data parallelism took {time.perf_counter() - t_dp:.1f} s (C8 and "
        "the group of one in the train phase not counted)")
    log("data parallelism: " + json.dumps(dp))
    for row in rows:
        # each rank's launches over the DP_STEPS steps, by backend
        row["data_parallel"] = {
            b: {"launches_per_rank": [r[row["name"]]
                                      for r in dp[b]["launches"]],
                "steps": DP_STEPS}
            for b in ("gloo", "nccl") if b in dp}

    log(f"[{time.perf_counter() - t0:.1f} s] {OPENOCC} (bf16, as served; "
        "K1 and K2 at its shapes, real-shape parity, test CLI, bench):")
    served = {}
    k1_oo, k2_oo, served[OPENOCC] = phase_openocc(kernels, weights)
    for name in ("coocc_multi_r101_896x1600", "coocc_cam_r101_896x1600"):
        log(f"[{time.perf_counter() - t0:.1f} s] {name} (bf16, as served):")
        model, _, launches_c, served[name] = phase_served_config(name,
                                                                 kernels)
        served[name]["launches"] = launches_c
        del model
        torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t0:.1f} s] {LIDAR} (bf16, as served; K2 "
        "at its HD levels, real-shape parity, test CLI, bench):")
    k2_lidar, served[LIDAR] = phase_lidar(kernels, weights)
    log(f"[{time.perf_counter() - t0:.1f} s] {STEREO} (bf16, as served; K1 "
        "and K2 on one call each, the plane sweep's share, real-shape "
        "parity, bench, test CLI):")
    served[STEREO] = phase_stereo(kernels, weights)
    t_new = time.perf_counter()
    log(f"[{t_new - t0:.1f} s] {KITTI} (its img and pts prefixes at full "
        "width, bf16 and fp32; K2 on every call, real-shape parity):")
    k2_kitti, served[KITTI] = phase_kitti(kernels, weights)
    log(f"[{time.perf_counter() - t0:.1f} s] eval-time rendering (the "
        "flagship, bf16, test_rendering):")
    served["render"] = phase_render(kernels)
    log(f"{KITTI} and the render path took {time.perf_counter() - t_new:.1f}"
        " s")
    t_routes = time.perf_counter()
    log(f"[{t_routes - t0:.1f} s] the LiDAR encoder's other routes (gather "
        "served and trained, the dense twin's step, Enc4x):")
    routes = phase_lidar_routes(kernels)
    log(f"the LiDAR routes took {time.perf_counter() - t_routes:.1f} s")
    log("LiDAR routes: " + json.dumps(routes))
    t_swin = time.perf_counter()
    log(f"[{t_swin - t0:.1f} s] the Swin route ({SWIN_LABEL}, bf16: served, "
        "trained, C8), its real-shape fingerprint, the envelope's modules "
        "card against host:")
    served["swin"] = phase_swin(kernels)
    served["swin"]["fingerprint"] = phase_swin_fingerprint()
    modules = phase_modules()
    log(f"the Swin route, its fingerprint and the modules took "
        f"{time.perf_counter() - t_swin:.1f} s")
    log("modules (card ms a call, max |card - host| / max |host|): "
        + json.dumps(modules))
    t_env = time.perf_counter()
    log(f"[{t_env - t0:.1f} s] the rest of the envelope (deformable "
        "attention, Image2BEV, Mask2Former, the ray library, the native "
        "host library) card against host:")
    envelope = phase_envelope()
    log("envelope: " + json.dumps(envelope))
    t_lm = time.perf_counter()
    log(f"[{t_lm - t0:.1f} s] the lane-major downsample and the narrow SubM "
        f"route (the flagship's encoder at 800x800x{LANE_MAJOR_Z}):")
    lane_major = phase_lane_major(kernels)
    log(f"the lane-major route took {time.perf_counter() - t_lm:.1f} s")
    log(f"served configs (request ms median, device busy ms per request, "
        f"peak GiB): {json.dumps(served)}")
    # the kernels at OpenOccupancy's shapes, beside the flagship's
    k1_row["configs"] = {OPENOCC: {k: k1_oo[k] for k in (
        "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}}
    k2_row["configs"] = {OPENOCC: k2_oo, LIDAR: k2_lidar, KITTI: k2_kitti}
    # the stereo path's launches over its 3 requests and one call's check
    # (its shapes are the flagship's, timed in this row)
    for row, key in ((k1_row, "k1_max_abs_err"), (k2_row, "k2_max_abs_err")):
        row["configs"][STEREO] = {
            "launches": served[STEREO]["launches"][row["name"]],
            "max_abs_err": served[STEREO][key]}
        # the flagship's eval with rendering: launches over its 3 requests
        row["configs"]["render"] = {
            "launches": served["render"]["render"]["launches"][row["name"]]}
        # the LiDAR routes: launches over 3 requests and 3 train steps
        row["configs"]["routes"] = {
            "flagship_gather": routes["flagship_gather"]["launches"][
                row["name"]],
            "flagship_gather_train": routes["flagship_gather"]["train"][
                "launches"][row["name"]],
            "flagship_dense_train": routes["flagship_dense_train"][
                "launches"][row["name"]],
            "lidar_gather": routes["lidar_gather"]["launches"][row["name"]],
            "lidar_gather_train": routes["lidar_gather"]["train"][
                "launches"][row["name"]]}
        # the Swin route: launches over its 3 requests and 3 train steps,
        # and one call of the path against the plain version
        row["configs"]["swin"] = {
            "launches": served["swin"]["launches"][row["name"]],
            "train_launches": served["swin"]["train"]["launches"][
                row["name"]],
            "max_abs_err": served["swin"][key]}
    dx_row["configs"]["swin"] = {
        "launches": served["swin"]["train"]["launches"]["subm_ext_conv_dx"]}
    # the lane-major route at 800x800x36: K2 at res3 and conv_out over 3
    # bf16 forwards and in one train step, the narrow route beside it
    for row in (k2_row, dx_row):
        row["configs"]["lane_major"] = {
            "launches": lane_major["bf16"]["launches"][row["name"]],
            "train_launches": lane_major["train"]["launches"][row["name"]],
            "narrow_launches": lane_major["bf16"]["launches"][
                "subm_conv_narrow"],
            "narrow_train_launches": lane_major["train"]["launches"][
                "subm_conv_narrow"]}

    log(f"[{time.perf_counter() - t0:.1f} s] card: {card_line()}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
