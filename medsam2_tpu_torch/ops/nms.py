"""Greedy non-maximum suppression on the host (counterpart of the numpy path
of ``medsam2_tpu/ops/nms.py``, which replaces torchvision's
``batched_nms`` in the reference AMG, and the nuclei engine's point NMS).
The JAX package's native C++ NMS is host code and computes the same
indices."""

from __future__ import annotations

import numpy as np


def _iou_matrix_np(boxes: np.ndarray) -> np.ndarray:
    x0 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y0 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x1 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y1 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area[:, None] + area[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def nms_np(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS: indices kept, by descending score (stable), suppressing
    IoU > ``iou_threshold`` (``torchvision.ops.nms`` semantics)."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    order = np.argsort(-scores, kind="stable")
    iou = _iou_matrix_np(boxes)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def batched_nms_np(boxes: np.ndarray, scores: np.ndarray, idxs: np.ndarray,
                   iou_threshold: float) -> np.ndarray:
    """Category-aware NMS by the coordinate-offset trick (torchvision's
    ``batched_nms``)."""
    boxes = np.asarray(boxes, np.float32)
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    offsets = np.asarray(idxs, np.float32) * (boxes.max() + 1)
    return nms_np(boxes + offsets[:, None], scores, iou_threshold)


def point_nms_np(points: np.ndarray, scores: np.ndarray, dist_threshold: float) -> np.ndarray:
    """Greedy distance NMS of points (``modeling/utils.py:342-355``): by
    descending score (stable), keep a point and suppress every other
    strictly closer than ``dist_threshold``, comparing squared distances in
    fp32 as the JAX package's native path does. Returns the kept indices in
    that order."""
    points = np.asarray(points, np.float32)
    if len(points) == 0:
        return np.zeros((0,), np.int64)
    order = np.argsort(-np.asarray(scores, np.float32), kind="stable")
    diff = points[:, None] - points[None, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    thr2 = np.float32(dist_threshold) * np.float32(dist_threshold)
    keep = []
    suppressed = np.zeros(len(points), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= d2[i] < thr2
        suppressed[i] = True
    return np.asarray(keep, np.int64)
