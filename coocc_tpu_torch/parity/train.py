"""JAX's train step of the flagship at real shapes, carried as a fingerprint
(`flagship_train_real.npz`, parity.TRAIN).

One step of coocc_multi_r50_256x704 at full width, B = 1, on
synthetic_batch(seed=0) from the fingerprint weights, as
coocc_tpu/parallel/train_step.py:27-55 computes it: the forward with
train=True (BatchNorm on batch statistics, which it moves), the losses, the
gradient of their sum; dropout off on both sides; the training cascade's
priorities JAX's own draw, stored in the file (`priorities`, fed to the
port's `fine_priorities`). Written by tests/test_torch_real_train.py on a
CPU that runs both packages, in fp32 and bf16.

The file holds, per dtype, of three groups of arrays (GROUPS):
  * "out": the outputs the losses read (TRAIN_OUTPUTS) and pts_voxel, the
    LiDAR encoder's output (for K2's floor), N_SAMPLE elements each, but
    fine_logits, whose rows follow the refined cells: JAX's refined cells
    and FINE_ROWS rows of their children by coordinates, as the forward
    fingerprints hold them (the training cascade refines the predicted
    occupied cells of highest priority, so a flipped coarse argmax can
    swap a cell);
  * "stat": every moved BatchNorm statistic, STAT_SAMPLE elements each;
  * "grad": every gradient leaf under the port's names, GRAD_SAMPLE
    elements each;
each item's seeded sample (the indices shared by both dtypes), its max |x|,
sum and sum of |x|; the raw loss terms (before loss_norm); the CPU port's
distance to all of these ("<dtype>/port")
and JAX's own bf16-vs-fp32 drift ("bf16/own"), row by row (`distances`).
The arrays of a group are concatenated, one entry per field, so that about
700 items keep the file under 1 MB.

A row's distance: for an item, the sample's max and mean |diff| relative
to the item's max |x| (absolute where that is 0), and its sum's |diff|
relative to its sum of |x| ("<item>:sum"); for a loss term the relative
|diff|; for the refined cells the share of JAX's not refined.

`check` holds a run against a yardstick: the CPU port's distance in
fp32, JAX's own bf16-vs-fp32 drift in bf16 (the C9 rule).
  * Row by row: each loss term within 2x of it (floor LOSS_FLOOR), the
    refined cells within 2x plus 0.002 (as `parity.check`), each output's
    sample and the fine logits within 2x (max) and 1.5x (mean) of it,
    with floors FLOOR_MAX and FLOOR_MEAN and, in fp32, K2's floor on the
    max (2x the CPU port's pts_voxel max: K2 rounds its operands to bf16
    even in fp32, and an operand one ulp from a boundary rounds apart on
    another device).
  * Item by item, a ceiling: each gradient leaf's and each statistic's
    sample within CEILING x its yardstick (max and mean; floors FLOOR_MAX
    and FLOOR_MEAN), each sum within CEILING x its yardstick or
    SUM_FLOOR of its sum of |x|, whichever is larger.
  * Pooled (POOLED): over the gradient leaves and over the statistics,
    the median of the run's ratio to the yardstick within 1.5x and the
    90th percentile within 2.5x (sample max and mean); over every sum, the
    median within 1.5x.
One leaf's, one statistic's or one sum's distance is one draw of noise,
hence a ceiling and not 2x: JAX's own bf16 gradient of a backbone leaf
moves by up to 60% of its scale from its fp32 one; over the 425 leaves
the CPU port's bf16 samples read up to 3.5x JAX's own (a median of 0.86x,
a 90th percentile of 1.29x), and an H100's fp32 ones up to 9.8x the CPU
port's (0.97x, 1.37x); a sum can cancel to almost nothing in one run and
not in another (the largest reading past 20x its yardstick: 0.097 of the
sum of |x| in the H100's fp32, 0.17 in the CPU port's bf16). A loss term
is one draw too, hence its floor: the H100's fp32 geo_scal loss read 2.6x
the CPU port's distance (1.1e-3), its bf16 loss_voxel_ce_fine 1.7e-3.

What the ceiling cannot see: a leaf whose yardstick is above 1/CEILING of
its scale. The step's gradient is chaotic at this size (K2's bf16
operands, the cascade's top-k, BatchNorm over one sample): the CPU port's
fp32 distance to JAX's fp32 is a median 0.53 of the scale over the LiDAR
encoder's 51 leaves and 0.16 over the backbone's 159, so a fault confined
to one of those modules that moves its leaves by their scale (half of it
on average) passes every leaf but the few whose yardstick is small: 3 of
the encoder's 51 under either yardstick (its stem's two, whose gradient
is 0 in both packages, and conv1's first weight, at the mean), none of
the backbone's under JAX's own drift. The occupancy head's leaves are
held tightly (30 of 34 in fp32). For the encoder, K2's dX is held call
by call against its plain version on the card
(chip_smoke.py) and the encoder's gradient against JAX on the CPU's tiny
twins (tests/test_torch_train.py, tests/test_torch_lane_major.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from . import (FLOOR_MAX, FLOOR_MEAN, N_SAMPLE, cascade_distances,
               fine_entries)

# the loss terms' floor: one bf16 rounding, of K2's operands in fp32
# (half a bf16 ulp) and of every op's output in bf16 (one ulp)
LOSS_FLOOR = {"fp32": 2.0 ** -9, "bf16": 2.0 ** -8}
# each leaf's, statistic's and sum's ceiling: CEILING x its yardstick, a
# sum's at least SUM_FLOOR of its sum of |x| (about twice the largest
# reading past CEILING x its yardstick, module note)
CEILING = 20.0
SUM_FLOOR = {"fp32": 0.2, "bf16": 0.35}
# the pooled rows' bounds on the median and the 90th percentile of a run's
# ratio to the yardstick
POOLED = (1.5, 2.5)
# the outputs sampled by index; fine_logits, whose rows follow the refined
# cells, is sampled by coordinates (CASCADE)
TRAIN_OUTPUTS = ("occ", "depth_prob", "voxel_feats", "render_depth",
                 "render_rgb", "pts_voxel")
CASCADE = ("fine_coords", "fine_valid", "fine_logits")
FINE_ROWS = 1024
RATIO = 2                  # the flagship's cascade ratio
GROUPS = ("out", "stat", "grad")
STAT_SAMPLE, GRAD_SAMPLE = 16, 32
SAMPLE = {"out": N_SAMPLE, "stat": STAT_SAMPLE, "grad": GRAD_SAMPLE}


def step_arrays(model, batch, priorities) -> Dict:
    """The port's train step of `model` (a CoOccRay) on `batch` with the
    cascade's `priorities`, dropout off, its gradients kept in .grad ->
    {"loss": {term: raw value}, "out": {...}, "stat": {...}, "grad":
    {...}} as fp32 numpy (every parameter: zeros where it has no
    gradient) and "cascade", the cascade's outputs (CASCADE)."""
    from ..models.losses import compute_losses
    from ..nn.layers import Dropout
    cfg = model.cfg
    model.train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model.zero_grad(set_to_none=True)
    keep = {}
    hook = model.pts_middle_encoder.register_forward_hook(
        lambda mod, i, o: keep.__setitem__("pts_voxel", o.detach()))
    try:
        outs = model(batch, fine_priorities=priorities)
    finally:
        hook.remove()
    losses = compute_losses(outs, batch, cfg)
    raw = compute_losses(outs, batch,
                         dataclasses.replace(cfg, loss_norm=False))
    sum(v for k, v in losses.items() if k.startswith("loss")).backward()

    def host(t):
        return t.detach().float().cpu().numpy()
    # pts_voxel channels-last, as JAX's capture holds it
    outs = {**outs, "pts_voxel": keep["pts_voxel"].permute(0, 2, 3, 4, 1)}
    return {"loss": {k: float(v) for k, v in raw.items()},
            "out": {k: host(outs[k]) for k in TRAIN_OUTPUTS
                    if outs.get(k) is not None},
            "stat": {k: host(v) for k, v in model.state_dict().items()
                     if "running" in k},
            "grad": {k: host(p.grad) if p.grad is not None
                     else np.zeros(tuple(p.shape), np.float32)
                     for k, p in model.named_parameters()},
            "cascade": {k: host(outs[k]) if k == "fine_logits"
                        else outs[k].cpu().numpy() for k in CASCADE}}


def entries(jax_res: Dict, prefix: str, fp: Dict) -> Dict:
    """The fingerprint's arrays for one dtype from JAX's step (same layout
    as step_arrays'): the groups' samples and measures, the raw loss terms,
    the refined cells and FINE_ROWS of their children's logits
    (`parity.fine_entries`); the sampled indices (seeded, shared by both
    dtypes) are drawn into fp the first time."""
    out = {}
    for g in GROUPS:
        names = sorted(jax_res[g])
        if f"{g}/names" not in fp:
            rs = np.random.RandomState(GROUPS.index(g))
            idx = [rs.choice(jax_res[g][n].size,
                             min(SAMPLE[g], jax_res[g][n].size),
                             replace=False) for n in names]
            fp[f"{g}/names"] = np.array(names)
            fp[f"{g}/offsets"] = np.cumsum([0] + [len(i) for i in idx])
            fp[f"{g}/idx"] = np.concatenate(idx).astype(np.int64)
        assert list(fp[f"{g}/names"]) == names, g
        vals, stats = [], []
        for i, n in enumerate(names):
            a = jax_res[g][n].reshape(-1)
            vals.append(a[_sl(fp, g, i)])
            stats.append((np.abs(a).max(), a.astype(np.float64).sum(),
                          np.abs(a).astype(np.float64).sum()))
        out[f"{prefix}/{g}/val"] = np.concatenate(vals).astype(np.float32)
        out[f"{prefix}/{g}/stats"] = np.array(stats, np.float64)
    terms = sorted(jax_res["loss"])
    fp.setdefault("loss/names", np.array(terms))
    assert list(fp["loss/names"]) == terms
    out[f"{prefix}/loss/val"] = np.array([jax_res["loss"][t]
                                          for t in terms])
    out.update(fine_entries(jax_res["cascade"], prefix, RATIO,
                            np.random.RandomState(len(GROUPS)), FINE_ROWS))
    return out


def _sl(fp, g, i):
    off = fp[f"{g}/offsets"]
    return fp[f"{g}/idx"][off[i]:off[i + 1]]


def rows(fp: Dict):
    """The rows' names, in the order of the recorded distances."""
    names = [f"{g}/{n}{m}" for g in GROUPS for n in fp[f"{g}/names"]
             for m in ("", ":sum")]
    return names + [f"loss/{t}" for t in fp["loss/names"]] + [
        "cells", "fine_logits"]


def distances(fp: Dict, prefix: str, res: Dict) -> np.ndarray:
    """[rows, 2] (max, mean) distances of a step's arrays `res` to the
    fingerprint's `prefix` entries, in the order of `rows`."""
    d = []
    for g in GROUPS:
        vals = fp[f"{prefix}/{g}/val"]
        stats = fp[f"{prefix}/{g}/stats"]
        off = fp[f"{g}/offsets"]
        for i, n in enumerate(fp[f"{g}/names"]):
            a = res[g][n].reshape(-1)
            scale, s, l1 = stats[i]
            err = np.abs(a[_sl(fp, g, i)].astype(np.float64)
                         - vals[off[i]:off[i + 1]])
            scale = scale if scale > 0 else 1.0
            d.append((err.max() / scale, err.mean() / scale))
            d.append((abs(a.astype(np.float64).sum() - s)
                      / (l1 if l1 > 0 else 1.0), 0.0))
    for t, ref in zip(fp["loss/names"], fp[f"{prefix}/loss/val"]):
        d.append((abs(res["loss"][t] - ref) / max(abs(ref), 1e-30), 0.0))
    cascade = cascade_distances(fp, prefix, res["cascade"], RATIO)
    d += [cascade["cells"], cascade["fine_logits"]]
    return np.array(d, np.float64)


def holds(names, got, ref, prefix: str):
    """The rule of `check` on the rows' distances `got` against the
    yardstick's `ref` ([rows, 2] each, in the order of `names`) -> [(name,
    (max, mean) read, (max, mean) bound, ok)]: a row for each item and,
    after them, the pooled rows."""
    k2 = 0.0
    if prefix == "fp32":
        k2 = 2.0 * float(ref[names.index("out/pts_voxel")][0])
    out, pooled = [], {}
    for name, (dmax, dmean), (rmax, rmean) in zip(names, got, ref):
        if name.endswith(":sum"):
            pooled.setdefault("sums", []).append((dmax / max(rmax, 1e-30),
                                                  0.0))
            bound = (max(CEILING * rmax, SUM_FLOOR[prefix]), 0.0)
        elif name.startswith(("grad/", "stat/")):
            pooled.setdefault(name.split("/")[0] + "s", []).append(
                (dmax / max(rmax, 1e-30), dmean / max(rmean, 1e-30)))
            bound = (max(CEILING * rmax, FLOOR_MAX),
                     max(CEILING * rmean, FLOOR_MEAN))
        elif name.startswith("loss/"):
            bound = (max(2.0 * rmax, LOSS_FLOOR[prefix]), 0.0)
        elif name == "cells":
            bound = (2.0 * rmax + 0.002, 0.0)
        else:
            bound = (max(2.0 * rmax, FLOOR_MAX, k2),
                     max(1.5 * rmean, FLOOR_MEAN))
        out.append((name, (float(dmax), float(dmean)), bound,
                    bool(dmax <= bound[0] and dmean <= bound[1])))
    # the pooled rows: over the gradient leaves and over the statistics
    # (sample max, sample mean) and over every sum, the median and the
    # 90th percentile of the run's ratio to the yardstick
    for pool, ratios in pooled.items():
        r = np.array(ratios)
        slots = (0,) if pool == "sums" else (0, 1)
        for slot in slots:
            med, p90 = np.median(r[:, slot]), np.quantile(r[:, slot], 0.9)
            name = f"{pool} ({'max' if slot == 0 else 'mean'}, {len(r)})"
            quantiles = (float(med), float(p90))
            bound = (POOLED[0], np.inf) if pool == "sums" else POOLED
            out.append((name, quantiles, bound,
                        bool(med <= bound[0] and p90 <= bound[1])))
    return out


def check(fp: Dict, prefix: str, res: Dict):
    """-> [(row, (max, mean) read, (max, mean) bound, ok)] of a run's step
    against the fingerprint, the yardstick the CPU port's distance in fp32
    and JAX's own bf16-vs-fp32 drift in bf16 (module note)."""
    ref = fp["fp32/port"] if prefix == "fp32" else fp["bf16/own"]
    return holds(rows(fp), distances(fp, prefix, res), ref, prefix)
