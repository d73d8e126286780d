"""Rendering diagnostics: PSNR and SSIM of rendered views, and image dumps.

A numpy copy of coocc_tpu/evaluation/render_metrics.py (reference
utils/save_rendered_img.py:10-82, the test_rendering path of
coocc_ray.py:562-637). `save_rendered_img` needs PIL, which it imports
when it is called.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def compute_psnr(pred: np.ndarray, target: np.ndarray,
                 mask: Optional[np.ndarray] = None) -> float:
    """Images in [0, 1]; PSNR in dB."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    if mask is not None:
        diff = ((pred - target) ** 2)[mask.astype(bool)]
    else:
        diff = (pred - target) ** 2
    mse = float(diff.mean())
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))


def compute_ssim(pred: np.ndarray, target: np.ndarray) -> float:
    """Global (single-window) SSIM over [0, 1] images."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    mu_x, mu_y = pred.mean(), target.mean()
    var_x, var_y = pred.var(), target.var()
    cov = ((pred - mu_x) * (target - mu_y)).mean()
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return float(((2 * mu_x * mu_y + c1) * (2 * cov + c2))
                 / ((mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)))


def save_rendered_img(rgb: np.ndarray, gt_rgb: np.ndarray,
                      depth: np.ndarray, out_path: str) -> float:
    """A [render | gt | normalized depth] side-by-side PNG; returns the
    PSNR. Raises ImportError where PIL is not installed."""
    from PIL import Image

    d = (depth - depth.min()) / (depth.max() - depth.min() + 1e-8)
    panel = np.concatenate(
        [rgb, gt_rgb, np.repeat(d[..., None], 3, axis=-1)], axis=1)
    panel = np.clip(panel, 0, 1)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    Image.fromarray((panel * 255).astype(np.uint8)).save(out_path)
    return compute_psnr(rgb, gt_rgb)
