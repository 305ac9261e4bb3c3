"""Prompt sampling (counterpart of ``medsam2_tpu/data/prompts.py``; rebuild of ``func_3d/utils.py:90-137`` and the 2D click
samplers): random foreground click and tight/jittered bounding boxes."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def random_click(mask: np.ndarray, point_label: int = 1,
                 rng: Optional[np.random.Generator] = None) -> Tuple[int, np.ndarray]:
    """Random foreground pixel of ``mask`` as an (x, y) click
    (``func_3d/utils.py:90-105``). Empty mask -> label 0 click on a random
    background pixel (the reference degenerates the label to the max value)."""
    rng = rng or np.random.default_rng()
    mask = np.asarray(mask)
    max_label = int(mask.max())
    if max_label == 0:
        point_label = 0
    indices = np.argwhere(mask == max_label)
    r = indices[rng.integers(len(indices))]
    return point_label, np.array([r[1], r[0]], np.float32)  # (x, y)


def generate_bbox(mask: np.ndarray, variation: float = 0.0,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Tight box around the mask with optional Gaussian size jitter
    (``func_3d/utils.py:107-137``). Returns [y0, x0, y1, x1] like the
    reference (note its row/col convention); NaNs when the mask is empty."""
    rng = rng or np.random.default_rng()
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"Mask shape is not 2D, but {mask.shape}")
    if mask.max() == 0:
        return np.array([np.nan, np.nan, np.nan, np.nan])
    indices = np.argwhere(mask == mask.max())
    x0, x1 = indices[:, 0].min(), indices[:, 0].max()
    y0, y1 = indices[:, 1].min(), indices[:, 1].max()
    if variation > 0:
        w, h = x1 - x0, y1 - y0
        mid_x, mid_y = (x0 + x1) / 2, (y0 + y1) / 2
        jit = rng.standard_normal(2) * variation
        w = w * (1 + jit[0])
        h = h * (1 + jit[1])
        x0, x1 = mid_x - w / 2, mid_x + w / 2
        y0, y1 = mid_y - h / 2, mid_y + h / 2
    return np.array([y0, x0, y1, x1], np.float32)


def bbox_to_xyxy(bbox_ref: np.ndarray) -> np.ndarray:
    """Reference [y0, x0, y1, x1] (rows/cols) -> (x, y) corner points [2, 2]."""
    y0, x0, y1, x1 = bbox_ref
    return np.array([[y0, x0], [y1, x1]], np.float32)
