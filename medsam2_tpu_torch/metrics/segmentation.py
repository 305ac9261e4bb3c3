"""Semantic segmentation metrics (counterpart of
``medsam2_tpu/metrics/segmentation.py``; rebuild of ``func_3d/utils.py:139-252`` /
``func_2d/utils.py:505-570``): threshold-averaged IoU and Dice."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _iou(outputs: np.ndarray, labels: np.ndarray) -> float:
    """Batch-mean IoU of int {0,1} masks [B, H, W] with 1e-6 smoothing."""
    smooth = 1e-6
    inter = (outputs & labels).sum((1, 2))
    union = (outputs | labels).sum((1, 2))
    return float(((inter + smooth) / (union + smooth)).mean())


def _dice(pred: np.ndarray, target: np.ndarray) -> float:
    """Batch-mean Dice with +1 smoothing (the reference's ``dice_coeff``)."""
    eps = 1e-4  # matches the reference DiceCoeff forward smoothing
    p = pred.reshape(pred.shape[0], -1).astype(np.float64)
    t = target.reshape(target.shape[0], -1).astype(np.float64)
    inter = 2.0 * (p * t).sum(1) + eps
    union = p.sum(1) + t.sum(1) + eps
    return float((inter / union).mean())


def eval_seg(pred: np.ndarray, true_mask: np.ndarray,
             thresholds: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9)):
    """Threshold-averaged (IoU, Dice) per channel.

    pred/true_mask: [B, C, H, W]; thresholds applied to BOTH pred and gt
    (the reference thresholds raw logits and gt alike, ``func_3d/utils.py:150-151``).
    C == 1 -> (iou, dice); C == 2 -> (iou_d, iou_c, dice_d, dice_c);
    C > 2 -> tuple of C ious then C dices.
    """
    pred = np.asarray(pred)
    true_mask = np.asarray(true_mask)
    b, c = pred.shape[:2]
    ious = np.zeros(c)
    dices = np.zeros(c)
    for th in thresholds:
        gt = (true_mask > th).astype(np.int32)
        vp = (pred > th).astype(np.int32)
        for i in range(c):
            ious[i] += _iou(vp[:, i], gt[:, i])
            dices[i] += _dice(vp[:, i].astype(np.float32), gt[:, i].astype(np.float32))
    ious /= len(thresholds)
    dices /= len(thresholds)
    if c == 1:
        return float(ious[0]), float(dices[0])
    if c == 2:
        return float(ious[0]), float(ious[1]), float(dices[0]), float(dices[1])
    return tuple(np.concatenate([ious, dices]).tolist())
