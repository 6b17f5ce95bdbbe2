"""Evaluation metrics: Middlebury-style bad-pixel rate and end-point error
(the port's own copy of crossscalepatchmatch_tpu.metrics; NumPy)."""

from __future__ import annotations

import numpy as np


def bad_pixel_rate(disp: np.ndarray, gt: np.ndarray,
                   valid: np.ndarray | None = None,
                   thresh: float = 1.0) -> float:
    """Fraction of pixels with |disp - gt| > thresh (Middlebury bad-N).

    Args:
      disp: predicted disparity (already divided by dis_scale).
      gt: ground-truth disparity.
      valid: evaluation mask (e.g. non-occluded); all pixels if None.
    """
    disp = np.asarray(disp, np.float64)
    gt = np.asarray(gt, np.float64)
    err = np.abs(disp - gt)
    if valid is None:
        valid = np.ones_like(err, bool)
    n = int(valid.sum())
    if n == 0:
        return 0.0
    return float((err[valid] > thresh).sum()) / n


def epe(disp: np.ndarray, gt: np.ndarray,
        valid: np.ndarray | None = None) -> float:
    """Mean absolute end-point error."""
    disp = np.asarray(disp, np.float64)
    gt = np.asarray(gt, np.float64)
    err = np.abs(disp - gt)
    if valid is None:
        valid = np.ones_like(err, bool)
    if valid.sum() == 0:
        return 0.0
    return float(err[valid].mean())
