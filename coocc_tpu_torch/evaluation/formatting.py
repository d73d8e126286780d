"""Result tables.

A numpy copy of coocc_tpu/evaluation/formatting.py (reference
projects/mmdet3d_plugin/utils/formating.py:4-168): cm_to_ious and the
SC/SSC and lidarseg tables printed at eval. tests/test_torch_eval.py pins
the lines equal to the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def cm_to_ious(cm: np.ndarray) -> np.ndarray:
    """Confusion matrix [C, C] (rows = gt) -> per-class IoU."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    denom = cm.sum(1) + cm.sum(0) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(denom > 0, tp / denom, np.nan)


def print_ssc_table(metrics: Dict, class_names: Sequence[str]):
    for ln in format_ssc_table(metrics, class_names):
        print(ln)


def format_ssc_table(metrics: Dict, class_names: Sequence[str]) -> List[str]:
    lines = ["=== Scene Completion (SC) ===",
             f"  Precision: {metrics['SC_Precision'] * 100:6.2f}",
             f"  Recall:    {metrics['SC_Recall'] * 100:6.2f}",
             f"  IoU:       {metrics['SC_IoU'] * 100:6.2f}",
             "=== Semantic Scene Completion (SSC) ==="]
    ious = metrics.get("SSC_IoU_per_class")
    if ious is not None:
        for name, iou in zip(class_names, ious):
            val = "  nan" if iou is None or np.isnan(iou) \
                else f"{iou * 100:6.2f}"
            lines.append(f"  {name:<22s} {val}")
    lines.append(f"  {'mIoU (1..C-1)':<22s} {metrics['SSC_mIoU'] * 100:6.2f}")
    if "render_PSNR" in metrics:
        lines.append("=== Rendering (test_rendering) ===")
        lines.append(f"  PSNR:      {metrics['render_PSNR']:6.2f} dB")
        lines.append(f"  SSIM:      {metrics['render_SSIM']:6.4f}")
    return lines


def format_lidarseg_table(hist: np.ndarray,
                          class_names: Sequence[str]) -> List[str]:
    ious = cm_to_ious(hist)
    lines = ["=== LiDAR segmentation ==="]
    for name, iou in zip(class_names[1:], ious[1:]):
        val = "  nan" if np.isnan(iou) else f"{iou * 100:6.2f}"
        lines.append(f"  {name:<22s} {val}")
    lines.append(f"  mIoU: {np.nanmean(ious[1:]) * 100:6.2f}")
    return lines
