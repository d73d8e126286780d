"""Panoptic quality (PQ/SQ/RQ) evaluator.

A numpy copy of coocc_tpu/evaluation/panoptic.py (the reference's
utils/panoptic_eval.py; no shipped config uses it): panoptic metrics over
(semantic, instance) voxel or point labelings, segments matched at
IoU > 0.5.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class PanopticEvaluator:
    def __init__(self, num_classes: int, ignore_label: int = 255,
                 min_points: int = 0, things: Optional[Sequence[int]] = None):
        self.num_classes = num_classes
        self.ignore = ignore_label
        self.min_points = min_points
        self.things = set(things) if things is not None else None
        self.reset()

    def reset(self):
        C = self.num_classes
        self.pan_tp = np.zeros(C, np.int64)
        self.pan_fp = np.zeros(C, np.int64)
        self.pan_fn = np.zeros(C, np.int64)
        self.pan_iou = np.zeros(C, np.float64)

    def add_batch(self, pred_sem, pred_inst, gt_sem, gt_inst):
        """Flat int arrays of equal length."""
        valid = gt_sem != self.ignore
        pred_sem = pred_sem[valid]
        pred_inst = pred_inst[valid]
        gt_sem = gt_sem[valid]
        gt_inst = gt_inst[valid]

        for c in range(self.num_classes):
            if self.things is not None and c not in self.things:
                continue
            p_mask = pred_sem == c
            g_mask = gt_sem == c

            # the class's segments (instance ids) of at least min_points
            p_ids, p_cnt = np.unique(pred_inst[p_mask], return_counts=True)
            g_ids, g_cnt = np.unique(gt_inst[g_mask], return_counts=True)
            p_sizes = {k: v for k, v in zip(p_ids.tolist(), p_cnt.tolist())
                       if v >= self.min_points}
            g_sizes = {k: v for k, v in zip(g_ids.tolist(), g_cnt.tolist())
                       if v >= self.min_points}
            if not p_sizes and not g_sizes:
                continue

            # intersections between the class's predicted and true segments
            both = p_mask & g_mask
            keys = pred_inst[both].astype(np.int64) * (2 ** 32) \
                + gt_inst[both].astype(np.int64)
            uk, uc = np.unique(keys, return_counts=True)

            matched_p, matched_g = set(), set()
            for k, inter in zip(uk.tolist(), uc.tolist()):
                pid, gid = k >> 32, k & (2 ** 32 - 1)
                if pid not in p_sizes or gid not in g_sizes:
                    continue
                iou = inter / (p_sizes[pid] + g_sizes[gid] - inter)
                if iou > 0.5:
                    self.pan_tp[c] += 1
                    self.pan_iou[c] += iou
                    matched_p.add(pid)
                    matched_g.add(gid)
            self.pan_fp[c] += len(set(p_sizes) - matched_p)
            self.pan_fn[c] += len(set(g_sizes) - matched_g)

    def compute(self) -> Dict[str, float]:
        tp, fp, fn = self.pan_tp, self.pan_fp, self.pan_fn
        with np.errstate(divide="ignore", invalid="ignore"):
            sq = np.where(tp > 0, self.pan_iou / np.maximum(tp, 1), 0.0)
            rq = np.where(tp + fp + fn > 0,
                          tp / np.maximum(tp + 0.5 * fp + 0.5 * fn, 1e-9),
                          0.0)
        pq = sq * rq
        active = (tp + fp + fn) > 0
        n = max(int(active.sum()), 1)
        return {
            "PQ": float(pq[active].sum() / n) if active.any() else 0.0,
            "SQ": float(sq[active].sum() / n) if active.any() else 0.0,
            "RQ": float(rq[active].sum() / n) if active.any() else 0.0,
            "PQ_per_class": pq.tolist(),
        }
