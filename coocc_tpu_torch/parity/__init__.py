"""JAX's outputs at real shapes, carried as a small fingerprint per config.

The card's machine has no JAX, so the JAX package's real-shape outputs come
along as committed files, one per name in FINGERPRINTS:
`flagship_real.npz` (coocc_multi_r50_256x704), `openocc_real.npz`
(coocc_multi_r101_openoccupancy), `lidar_real.npz` (coocc_lidar),
`stereo_real.npz` (coocc_multi_r50_256x704_stereo) and `kitti_real.npz`
(coocc_kitti), written by the gated test tests/test_torch_real_shapes.py
(COOCC_TORCH_REAL=1) on a CPU that runs both packages;
`flagship_gather_real.npz` (GATHER: the flagship on pts.impl="gather", its
pts prefix and the sites each strided level kept) and
`flagship_train_real.npz` (TRAIN: one train step of the flagship,
`parity.train`), written by tests/test_torch_real_train.py; and
`swin_real.npz` (SWIN, below). Both sides build the config
(`fingerprint_config`) from one set of weights, `numpy_weights(model,
seed=0)` (drawn from numpy, so that every torch version draws the same
bits), and run synthetic_batch(seed=0), in fp32 and in bf16 (JAX's
CoOccRay(cfg, dtype=bfloat16) compiled with xla_allow_excess_precision
off).

Per dtype and output (the `stop_at` prefixes img_voxel, pts_voxel,
voxel_feats, semantic[0..3], occ, and the cascade's fine_logits, those the
config has: coocc_lidar has no img_voxel and no cascade; coocc_kitti's
holds its img and pts prefixes only and GATHER its pts_voxel, PREFIX_ONLY)
the file holds JAX's values at a fixed seeded sample of elements, its
per-channel sums and max |x|; the coarse argmax at a sample of cells; JAX's
refined coarse cells (the 20,000 of the eval cap) and a sample of their
children's logits by coordinates (N_FINE_ROWS rows: 512 cells of 8
children at cascade ratio 2, 64 of 64 at ratio 4); the CPU port's own
distance to all of these (max and mean relative to the output's max |x|,
the argmax agreement, the share of refined cells in common) and JAX's own
bf16-vs-fp32 drift at the same samples ("bf16/<key>/own"), with digests
of the state_dict and of the batch.

A run on another device is held in two ways (C9). In fp32 (TF32 off),
`check`: within 2x (max) and 1.5x (mean) of the CPU port's own distance to
JAX, with floors of 1e-3 and 1e-4 of the scale where the CPU's distance is
fp32 rounding alone, and after the LiDAR encoder a floor on the max set by
K2's rounding; the card and the CPU differ there by rounding only. In
bf16, `check_drift`: within 2x and 1.5x of JAX's own bf16-vs-fp32 drift,
the one yardstick that does not depend on which device ran the port (in
bf16 the random-weight image branch is chaotic between devices).

`swin_real.npz` (SWIN) holds the same samples of JAX's Swin-T backbone
alone (coocc_tpu/nn/swin.py) on camera 0 of that batch, fp32, from
`swin_inputs`' weights: every stage pads its tokens at 256 x 704, which
no tiny twin shows at every stage (tests/test_torch_swin.py writes it).
"""
from __future__ import annotations

import hashlib
import math
import os
from typing import Dict

import numpy as np
import torch

FLAGSHIP = "coocc_multi_r50_256x704"
# the Swin-T backbone's fingerprint: its four stage outputs (SWIN_OUTPUTS)
SWIN = "swin_t_256x704"
# the flagship on pts.impl="gather" (`fingerprint_config`), its pts prefix
GATHER = "coocc_multi_r50_256x704_gather"
# one train step of the flagship (tests/test_torch_real_train.py)
TRAIN = "coocc_multi_r50_256x704_train"
FINGERPRINTS = {FLAGSHIP: "flagship_real.npz",
                "coocc_multi_r101_openoccupancy": "openocc_real.npz",
                "coocc_lidar": "lidar_real.npz",
                "coocc_multi_r50_256x704_stereo": "stereo_real.npz",
                "coocc_kitti": "kitti_real.npz",
                SWIN: "swin_real.npz",
                GATHER: "flagship_gather_real.npz",
                TRAIN: "flagship_train_real.npz"}
# fingerprints that hold a stop_at prefix only: coocc_kitti's forward
# cannot go past its pts prefix, in JAX (its fuser fails) nor in the port
# (models/coocc_ray.py raises there); the gather route's holds what the
# route computes
PREFIX_ONLY = {"coocc_kitti": "pts", GATHER: "pts"}
N_SAMPLE = 2048        # sampled elements per output
N_ARGMAX = 4096        # sampled coarse cells for the argmax
N_FINE_ROWS = 4096     # sampled fine rows: the children of sampled cells
OUTPUTS = ("img_voxel", "pts_voxel", "voxel_feats", "semantic0",
           "semantic1", "semantic2", "semantic3", "occ")
SWIN_OUTPUTS = ("swin0", "swin1", "swin2", "swin3")
FLOOR_MAX, FLOOR_MEAN = 1e-3, 1e-4
# configs whose fp32 sides already differ from JAX's by more than JAX's own
# bf16 drift (tests/test_torch_real_shapes.py): their bf16 bound adds the
# CPU port's fp32 distance
FP32_SLACK = ("coocc_multi_r101_openoccupancy",)
# fingerprints whose bf16 bound has no K2 floor: the stereo config's had
# none before check_drift held every config, and the gather route runs no
# K2
NO_K2_FLOOR = ("coocc_multi_r50_256x704_stereo", GATHER)


@torch.no_grad()
def numpy_weights(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """entry.init_weights' distributions drawn from np.random.RandomState
    (float64 draws rounded once to fp32): conv/linear weights N(0,
    1/fan_in), biases N(0, 0.01), norm affines and BN statistics random
    around identity."""
    from ..nn.layers import BatchNorm
    rs = np.random.RandomState(seed)

    def put(t, a):
        t.copy_(torch.from_numpy(np.asarray(a, np.float32).reshape(t.shape)))

    for m in model.modules():
        if isinstance(m, (BatchNorm, torch.nn.GroupNorm,
                          torch.nn.LayerNorm)):
            C = m.weight.shape[0]
            put(m.weight, rs.rand(C) + 0.5)
            put(m.bias, rs.standard_normal(C) * 0.1)
            if isinstance(m, BatchNorm):
                put(m.running_mean, rs.standard_normal(C) * 0.3)
                put(m.running_var, rs.rand(C) * 1.5 + 0.2)
            continue
        for name, p in m.named_parameters(recurse=False):
            if name == "bias":
                std = 0.01
            elif isinstance(m, (torch.nn.ConvTranspose2d,
                                torch.nn.ConvTranspose3d)):
                std = 1 / math.sqrt(p.shape[0])
            else:
                std = 1 / math.sqrt(p[0].numel())
            put(p, rs.standard_normal(tuple(p.shape)) * std)
    return model


def fingerprint_config(name: str):
    """The config fingerprint `name` was written at: the registered config
    of that name, the flagship on pts.impl="gather" for GATHER, the
    flagship for TRAIN."""
    import dataclasses
    from ..config import get_config
    if name == GATHER:
        cfg = get_config(FLAGSHIP)
        return dataclasses.replace(
            cfg, pts=dataclasses.replace(cfg.pts, impl="gather"))
    return get_config(FLAGSHIP if name == TRAIN else name)


def kept_sites(model, capacity: int) -> np.ndarray:
    """[levels, B] int64: the sites each strided level of a gather
    encoder kept in its last forward, the count before the cap (its
    `level_sites`) capped at `capacity`."""
    return np.stack([np.minimum(s.cpu().numpy(), capacity)
                     for s in model.pts_middle_encoder.level_sites])


def fingerprint_model(cfg, device, dtype=None):
    """The fingerprint's CoOccRay(cfg, dtype), in eval mode on `device`."""
    from ..models.coocc_ray import CoOccRay
    return numpy_weights(CoOccRay(cfg, dtype), seed=0).eval().to(device)


def digest(arrays: Dict[str, np.ndarray]) -> str:
    """sha256 over the named arrays (names, dtypes, shapes and bytes)."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(f"{k}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def state_digest(model: torch.nn.Module) -> str:
    return digest({k: v.detach().cpu().numpy()
                   for k, v in model.state_dict().items()})


def batch_digest(batch) -> str:
    return digest({k: np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                 else v)
                   for k, v in batch._asdict().items() if v is not None})


def outputs_of(out) -> tuple:
    """The OUTPUTS (or SWIN_OUTPUTS) a run (or JAX's) has."""
    return tuple(k for k in OUTPUTS + SWIN_OUTPUTS if k in out)


def swin_inputs(device):
    """The Swin fingerprint's model and input: the port's Swin-T
    (nn/swin.py defaults) with `numpy_weights(seed=0)`, in eval mode on
    `device`, and camera 0 of the flagship's synthetic_batch(seed=0) as
    [1, 3, 256, 704] fp32 on `device`."""
    from ..config import get_config
    from ..data.synthetic import synthetic_batch
    from ..nn.swin import SwinTransformer
    imgs = synthetic_batch(get_config("coocc_multi_r50_256x704"),
                           batch_size=1, seed=0).imgs
    x = torch.from_numpy(np.asarray(imgs[0, :1])).permute(0, 3, 1, 2)
    model = numpy_weights(SwinTransformer(), seed=0).eval().to(device)
    return model, x.float().contiguous().to(device)


@torch.no_grad()
def swin_outputs(model, x) -> Dict[str, np.ndarray]:
    """The backbone's four outputs, channels-last fp32 numpy."""
    return {f"swin{i}": o.permute(0, 2, 3, 1).float().cpu().numpy()
            for i, o in enumerate(model(x))}


@torch.no_grad()
def capture(model, batch, stop_at=None) -> Dict[str, np.ndarray]:
    """One full eval forward of the port, with its prefixes' outputs read
    on the way (forward hooks on the modules whose outputs they are), all
    channels-last, widened to fp32 numpy. Without the fuser voxel_feats is
    pts_voxel; after the HD encoder pts_voxel is SECOND3DFPN's output.
    stop_at='pts': the img and pts prefix's outputs alone, and on a gather
    encoder its strided levels' kept sites ("kept", `kept_sites`)."""
    if stop_at is not None:
        out = model(batch, stop_at=stop_at)
        res = {k: v.float().cpu().numpy() for k, v in out.items()
               if v is not None}
        enc = getattr(model, "pts_middle_encoder", None)
        if hasattr(enc, "level_sites"):      # a gather encoder
            res["kept"] = kept_sites(model, model.cfg.pts.max_voxels_test)
        return res
    cap = {}

    def cl(t):
        return t.permute(0, 2, 3, 4, 1)
    dt = model.dtype
    taps = [("img_view_transformer", "img_voxel", lambda o: o[0]),
            ("occ_fuser", "voxel_feats", cl),
            ("semantic_neck", "semantic", lambda o: [cl(t) for t in o])]
    if hasattr(model, "pts_neck"):   # [B, C, Z, Y, X]
        taps.append(("pts_neck", "pts_voxel",
                     lambda o: o.permute(0, 4, 3, 2, 1)))
    else:
        taps.append(("pts_middle_encoder", "pts_voxel",
                     lambda o: cl(o.to(dt))))
    hooks = [getattr(model, m).register_forward_hook(
        lambda mod, i, o, name=name, fn=fn: cap.__setitem__(name, fn(o)))
        for m, name, fn in taps if hasattr(model, m)]
    try:
        out = model(batch)
    finally:
        for h in hooks:
            h.remove()
    if "voxel_feats" not in cap:
        cap["voxel_feats"] = cap.get("pts_voxel", cap.get("img_voxel"))
    res = {k: cap[k] for k in ("img_voxel", "pts_voxel", "voxel_feats")
           if k in cap}
    res.update({f"semantic{i}": t for i, t in enumerate(cap["semantic"])})
    res.update(out)
    return {k: v.float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in res.items()}


def _fine_rows(out) -> Dict[tuple, np.ndarray]:
    return {tuple(c): l for c, l, v in zip(
        out["fine_coords"][0].tolist(), out["fine_logits"][0],
        out["fine_valid"][0]) if v}


def path(name: str) -> str:
    """The committed fingerprint of config `name`."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        FINGERPRINTS[name])


def _cells(out, ratio: int) -> np.ndarray:
    """The refined coarse cells [n, 3] (each child block's first row)."""
    n = ratio ** 3
    c = out["fine_coords"][0][::n]
    return (c[out["fine_valid"][0][::n]] // ratio).astype(np.int16)


def entries(jax_out, port_out, prefix: str,
            ratio: int) -> Dict[str, np.ndarray]:
    """The fingerprint's arrays for one dtype from JAX's outputs (cascade
    ratio `ratio`; the refined cells and fine rows where JAX's outputs have
    the cascade's), with the CPU port's distance to them recorded
    beside."""
    rs = np.random.RandomState(0)
    fp = {}
    for k in outputs_of(jax_out):
        a = jax_out[k].reshape(-1)
        idx = rs.choice(a.size, N_SAMPLE, replace=False).astype(np.int64)
        fp[f"{prefix}/{k}/idx"] = idx
        fp[f"{prefix}/{k}/val"] = a[idx]
        fp[f"{prefix}/{k}/csum"] = jax_out[k].reshape(
            -1, jax_out[k].shape[-1]).astype(np.float64).sum(0)
        fp[f"{prefix}/{k}/scale"] = np.float64(np.abs(a).max())
    if "occ" in jax_out:
        occ = jax_out["occ"].reshape(-1, jax_out["occ"].shape[-1])
        cells = rs.choice(occ.shape[0], N_ARGMAX, replace=False)
        fp[f"{prefix}/argmax/idx"] = cells.astype(np.int64)
        fp[f"{prefix}/argmax/val"] = occ[cells].argmax(-1).astype(np.int8)
    if "fine_logits" in jax_out:
        fp.update(fine_entries(jax_out, prefix, ratio, rs))
    for key, (dmax, dmean) in distances(fp, prefix, port_out,
                                        ratio).items():
        fp[f"{prefix}/{key}/port"] = np.array([dmax, dmean])
    return fp


def fine_entries(jax_out, prefix: str, ratio: int, rs,
                 n_rows: int = N_FINE_ROWS):
    """The refined cells and a sample of their children's logits (n_rows
    rows: whole child blocks of sampled cells)."""
    fp = {}
    jc = _cells(jax_out, ratio)
    fp[f"{prefix}/cells"] = jc
    rows = _fine_rows(jax_out)
    n_kids = ratio ** 3
    pick = jc[rs.choice(len(jc), min(n_rows // n_kids, len(jc)),
                        replace=False)]
    kids = (pick[:, None, :].astype(np.int64) * ratio + np.stack(
        np.meshgrid(*[np.arange(ratio)] * 3, indexing="ij"), -1).reshape(
            1, n_kids, 3))
    kids = kids.reshape(-1, 3)
    fp[f"{prefix}/fine/coords"] = kids.astype(np.int16)
    fp[f"{prefix}/fine/val"] = np.stack([rows[tuple(c)] for c in
                                         kids.tolist()])
    fp[f"{prefix}/fine/scale"] = np.float64(
        np.abs(jax_out["fine_logits"]).max())
    return fp


def distances(fp, prefix: str, out, ratio: int) -> Dict[str, tuple]:
    """A run's distance to the fingerprint: per output (max, mean) of the
    sampled elements' |diff| and max of the channel sums' |diff|, each
    relative to JAX's scale (max |x|, max |channel sum|); for the coarse
    argmax (share disagreeing, 0), the refined cells (share of JAX's not
    refined, 0) and the fine logits on the sampled cells both refine."""
    d = {}
    for k in OUTPUTS + SWIN_OUTPUTS:
        if f"{prefix}/{k}/idx" not in fp:
            continue
        scale = float(fp[f"{prefix}/{k}/scale"])
        got = out[k].reshape(-1)[fp[f"{prefix}/{k}/idx"]]
        err = np.abs(got.astype(np.float64) - fp[f"{prefix}/{k}/val"])
        d[k] = (err.max() / scale, err.mean() / scale)
        cs = out[k].reshape(-1, out[k].shape[-1]).astype(np.float64).sum(0)
        ref = fp[f"{prefix}/{k}/csum"]
        d[f"{k}_csum"] = (np.abs(cs - ref).max() / np.abs(ref).max(), 0.0)
    if f"{prefix}/argmax/idx" not in fp:
        return d
    occ = out["occ"].reshape(-1, out["occ"].shape[-1])
    am = occ[fp[f"{prefix}/argmax/idx"]].argmax(-1)
    d["argmax"] = (float((am != fp[f"{prefix}/argmax/val"]).mean()), 0.0)
    if f"{prefix}/cells" not in fp:
        return d
    d.update(cascade_distances(fp, prefix, out, ratio))
    return d


def cascade_distances(fp, prefix: str, out, ratio: int) -> Dict[str, tuple]:
    """The refined cells (share of JAX's not refined, 0) and the fine
    logits on the sampled cells both refine, of a run's cascade outputs
    (fine_coords, fine_valid, fine_logits)."""
    d = {}
    ref_cells = {tuple(c) for c in fp[f"{prefix}/cells"].tolist()}
    got_cells = {tuple(c) for c in _cells(out, ratio).tolist()}
    d["cells"] = (1.0 - len(ref_cells & got_cells) / len(ref_cells), 0.0)
    rows = _fine_rows(out)
    coords = fp[f"{prefix}/fine/coords"].tolist()
    both = [i for i, c in enumerate(coords) if tuple(c) in rows]
    got = np.stack([rows[tuple(coords[i])] for i in both])
    err = np.abs(got - fp[f"{prefix}/fine/val"][both])
    scale = float(fp[f"{prefix}/fine/scale"])
    d["fine_logits"] = (err.max() / scale, err.mean() / scale)
    return d


def load(name: str):
    """The committed fingerprint of config `name`, as a dict of arrays."""
    with np.load(path(name)) as z:
        return {k: z[k] for k in z.files}


def kept_rows(fp, prefix: str, out):
    """check's row for the kept sites of a gather fingerprint (none for
    another): the number of (level, sample) counts that differ from JAX's,
    which must be 0 (the rulebooks are built from integer ids, bit-equal
    to JAX's)."""
    if f"{prefix}/kept/jax" not in fp:
        return []
    ref, got = fp[f"{prefix}/kept/jax"], np.asarray(out["kept"])
    n = int((got != ref).sum()) if got.shape == ref.shape else ref.size
    return [("kept", (float(n), 0.0), (0.0, 0.0), n == 0)]


def check(fp, prefix: str, out, ratio: int):
    """-> [(name, (max, mean) of this run, (max, mean) of the CPU port,
    ok)]: each within 2x (max) and 1.5x (mean) of the CPU port's distance
    (floors FLOOR_MAX, FLOOR_MEAN); the share of argmax flips and of
    missing refined cells within 2x the CPU port's plus 0.002.

    The max of an output after the LiDAR encoder has a second floor, 2x the
    CPU port's pts_voxel max: K2 rounds its operands to bf16 even in fp32,
    and an operand one fp32 ulp from a rounding boundary rounds one way on
    the CPU and the other on the card, so each run redraws a few one-ulp
    outliers at the encoder's output. Which sampled elements they reach is
    chance (the card's fp32 voxel_feats met one at 6.6x the CPU's max, with
    the mean 1.06x); the mean bound still holds every output to the CPU's
    distance."""
    res = []
    k2_noise = 2.0 * float(fp[f"{prefix}/pts_voxel/port"][0]) \
        if f"{prefix}/pts_voxel/port" in fp else 0.0
    for key, (dmax, dmean) in distances(fp, prefix, out, ratio).items():
        pmax, pmean = (float(v) for v in fp[f"{prefix}/{key}/port"])
        if key in ("argmax", "cells"):
            ok = dmax <= 2.0 * pmax + 0.002
        else:
            floor = FLOOR_MAX if key.startswith("img_voxel") \
                else max(FLOOR_MAX, k2_noise)
            ok = dmax <= max(2.0 * pmax, floor) and \
                dmean <= max(1.5 * pmean, FLOOR_MEAN)
        res.append((key, (dmax, dmean), (pmax, pmean), bool(ok)))
    return res + kept_rows(fp, prefix, out)


def check_drift(fp, out, ratio: int, name: str):
    """-> check's rows for config `name`'s bf16 run held to JAX's own
    bf16-vs-fp32 drift at the sampled elements (the fingerprint's
    "bf16/<key>/own"): each within 2x (max) and 1.5x (mean) of it, plus the
    CPU port's fp32 distance to JAX for the configs in FP32_SLACK (as
    tests/test_torch_real_shapes.py holds the CPU port), with check's
    floors (FLOOR_MAX, FLOOR_MEAN, and after the LiDAR encoder the K2 floor
    on the max, 2x the CPU port's bf16 pts_voxel max, but for the configs
    in NO_K2_FLOOR); the share of argmax flips and of missing refined
    cells within 2x JAX's own plus 0.002 (plus the slack).

    The rule for every bf16 reading (C9). `check` holds a run to the CPU
    port's distance, and in bf16 the random-weight image branch is chaotic
    between devices, so the card is another draw of that noise, which the
    CPU's distance need not bound (on an H100 80GB HBM3 at 700 W, 94% of
    the flagship's and 99% of the stereo config's depth_prob values differ
    between the card and the CPU: `python -m
    coocc_tpu_torch.tools.card_vs_cpu`). JAX's own drift does not depend
    on which device ran the port."""
    res = []
    k2_noise = 2.0 * float(fp["bf16/pts_voxel/port"][0]) \
        if "bf16/pts_voxel/port" in fp and name not in NO_K2_FLOOR else 0.0
    for key, (dmax, dmean) in distances(fp, "bf16", out, ratio).items():
        omax, omean = (float(v) for v in fp[f"bf16/{key}/own"])
        smax, smean = (float(v) for v in fp[f"fp32/{key}/port"]) \
            if name in FP32_SLACK else (0.0, 0.0)
        if key in ("argmax", "cells"):
            ok = dmax <= 2.0 * omax + smax + 0.002
        else:
            floor = FLOOR_MAX if key.startswith("img_voxel") \
                else max(FLOOR_MAX, k2_noise)
            ok = dmax <= max(2.0 * omax + smax, floor) and \
                dmean <= max(1.5 * omean + smean, FLOOR_MEAN)
        res.append((key, (dmax, dmean), (omax, omean), bool(ok)))
    return res + kept_rows(fp, "bf16", out)
