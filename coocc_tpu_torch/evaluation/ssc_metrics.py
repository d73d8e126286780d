"""SSC/SC and lidarseg metrics as confusion matrices.

Counterpart of coocc_tpu/evaluation/ssc_metrics.py (reference
coocc_ray.py:726-730 fast_hist, :539-554 the SC/SSC accumulation, :659-666
the trilinear upsampling of the logits to the GT grid; utils/ssc_metric.py
:14-169 SSCMetrics). The hists are int64 [C, C] tensors on the logits'
device (rows = gt, columns = prediction); the loop sums them on the host
(train/loop.py). `ssc_summary` is a numpy copy.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def fast_hist(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Confusion matrix hist[label, pred], masked by `valid`: an invalid
    cell counts in a sentinel bin past the matrix, which is dropped."""
    idx = label.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    if valid is not None:
        idx = torch.where(valid.reshape(-1), idx, num_classes * num_classes)
    hist = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return hist[:-1].reshape(num_classes, num_classes)


def _shift_edge(x: torch.Tensor, axis: int, delta: int) -> torch.Tensor:
    """x[i + delta] along `axis` (delta = +-1), the edge replicated."""
    n = x.shape[axis]
    if delta > 0:
        return torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                         axis)
    return torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)


def _resize_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """One axis of JAX's resize_linear (align_corners=False), op for op so
    that it rounds where JAX rounds: an integer ratio r <= 16 is r blends
    x + f * (x[i +- 1] - x) in x's dtype, interleaved; any other ratio
    gathers the two neighbours and lerps with fp32 weights, which promotes
    a bf16 x to fp32 as JAX's promotion does."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if out_size % in_size == 0 and out_size // in_size <= 16:
        r = out_size // in_size
        xm1, xp1 = _shift_edge(x, axis, -1), _shift_edge(x, axis, 1)
        phases = []
        for p in range(r):
            f = (p + 0.5) / r - 0.5
            if f < 0:
                phases.append(x + torch.tensor(-f, dtype=x.dtype)
                              * (xm1 - x))
            elif f == 0:
                phases.append(x)
            else:
                phases.append(x + torch.tensor(f, dtype=x.dtype) * (xp1 - x))
        shape = list(x.shape)
        shape[axis] = out_size
        return torch.stack(phases, axis + 1).reshape(shape)
    out = torch.arange(out_size, dtype=torch.float32, device=x.device)
    src = ((out + 0.5) * (in_size / out_size) - 0.5).clamp(min=0.0)
    lo = src.floor().long().clamp(0, in_size - 1)
    hi = (lo + 1).clamp(0, in_size - 1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = (src - lo).reshape(shape)
    return (x.index_select(axis, lo) * (1 - w)
            + x.index_select(axis, hi) * w)


def resize_logits(logits: torch.Tensor, size) -> torch.Tensor:
    """[B, X, Y, Z, C] -> [B, *size, C], trilinear with align_corners=False:
    JAX's resize_trilinear_chlast, one axis at a time (_resize_axis)."""
    for axis in range(3):
        logits = _resize_axis(logits, 1 + axis, size[axis])
    return logits


def occupancy_hists(logits: torch.Tensor, gt_occ: torch.Tensor,
                    num_classes: int, empty_idx: int = 0,
                    extra_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse logits [B, Xc, Yc, Zc, C] + GT [B, X, Y, Z] -> (SC [2, 2],
    SSC [C, C]). The logits are upsampled to the GT grid (resize_logits)
    before the argmax; cells with gt 255 do not count, nor, with
    extra_mask (the OpenOccupancy visible mask), cells where it is 0."""
    size = tuple(gt_occ.shape[1:4])
    if tuple(logits.shape[1:4]) != size:
        logits = resize_logits(logits, size)
    pred = logits.argmax(dim=-1)
    valid = gt_occ != 255
    if extra_mask is not None:
        valid = valid & (extra_mask != 0)
    sc = fast_hist(pred != empty_idx, gt_occ != empty_idx, 2, valid)
    gt_clip = torch.where(valid, gt_occ, 0)
    ssc = fast_hist(pred, gt_clip, num_classes, valid)
    return sc, ssc


def scatter_fine_into_pred(fine_logits, fine_coords, fine_valid, final_size,
                           empty_idx: int = 0) -> torch.Tensor:
    """The cascade's fine logits [B, P, C] at fine_coords [B, P, 3] (where
    fine_valid) written into a full-resolution grid whose other cells
    read empty (1 at empty_idx, 0 elsewhere) -> [B, X, Y, Z, C] in
    fine_logits' dtype (reference simple_test's pred_f,
    coocc_ray.py:545-554)."""
    B, P, C = fine_logits.shape
    X, Y, Z = final_size
    grid = fine_logits.new_zeros(B, X * Y * Z + 1, C)
    grid[..., empty_idx] = 1.0
    c = fine_coords.long()
    lid = (c[..., 0] * Y + c[..., 1]) * Z + c[..., 2]
    lid = torch.where(fine_valid, lid, X * Y * Z)  # the dropped row
    for b in range(B):
        grid[b, lid[b]] = fine_logits[b]
    return grid[:, :-1].reshape(B, X, Y, Z, C)


def ssc_summary(sc_hist, ssc_hist) -> Dict[str, float]:
    """The final metric table (reference ssc_metric.py:87-102): SC
    precision, recall and IoU, the per-class SSC IoU and its mean over
    classes 1..C-1."""
    sc = np.asarray(sc_hist, np.float64)
    tp = sc[1, 1]
    fp = sc[0, 1]
    fn = sc[1, 0]
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    iou = tp / max(tp + fp + fn, 1)

    h = np.asarray(ssc_hist, np.float64)
    tp_c = np.diag(h)
    denom = h.sum(1) + h.sum(0) - tp_c
    with np.errstate(divide="ignore", invalid="ignore"):
        iou_ssc = np.where(denom > 0, tp_c / denom, np.nan)
    miou = np.nanmean(iou_ssc[1:])  # classes 1..C-1 (exclude free)
    return {
        "SC_Precision": float(precision),
        "SC_Recall": float(recall),
        "SC_IoU": float(iou),
        "SSC_mIoU": float(miou),
        "SSC_IoU_per_class": iou_ssc.tolist(),
    }


def lidarseg_hist(point_logits, point_labels, valid, num_classes: int = 17):
    """The lidarseg hist over classes 1.. (reference fast_hist_crop,
    utils/metric_util.py:1-22; the argmax skips class 0 as
    coocc_ray.py:557 does)."""
    pred = point_logits[..., 1:].argmax(dim=-1) + 1
    return fast_hist(pred, point_labels, num_classes, valid)
