"""Nuclei instance-segmentation metrics (counterpart of
``medsam2_tpu/metrics/instance.py``; rebuild of
``sam2_train/modeling/stats_utils.py``): AJI, AJI+, PQ/DQ/SQ, instance Dice,
``remap_label``, ``pair_coordinates``. numpy and scipy on the host; the
pairwise overlaps of ids contiguous from 1 come from the port's C++
histogram (``native.instance_overlap``), as in the JAX package, and any
other ids from the numpy loop.

Algorithms follow the published CoNSeP/HoVer-Net metric definitions the
reference file implements.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist


def _pairwise_inter_union(true: np.ndarray, pred: np.ndarray):
    """Intersection and union matrices [n_true, n_pred] over the instance
    ids in ascending order, with the two area vectors."""
    true_ids = np.unique(true)
    true_ids = true_ids[true_ids > 0]
    pred_ids = np.unique(pred)
    pred_ids = pred_ids[pred_ids > 0]
    n_t, n_p = len(true_ids), len(pred_ids)
    # one pass in C++ when the ids run 1..n (remap_label's output)
    if n_t and n_p and true_ids[-1] == n_t and pred_ids[-1] == n_p:
        from medsam2_tpu_torch import native

        inter, t_areas, p_areas = native.instance_overlap(true, pred, n_t, n_p)
        union = t_areas[:, None] + p_areas[None, :] - inter
        return inter, union, t_areas, p_areas
    inter = np.zeros((n_t, n_p), np.float64)
    t_areas = np.zeros(n_t)
    # one pixel count per id (the JAX package's numpy branch sums one full
    # mask per predicted id, which a 1000 x 1000 map with hundreds of
    # instances cannot hold at once; the counts are the same integers)
    p_areas = np.bincount(np.searchsorted(pred_ids, pred[pred > 0]),
                          minlength=n_p).astype(np.float64)
    for i, tid in enumerate(true_ids):
        t_mask = true == tid
        t_areas[i] = t_mask.sum()
        overlap_ids = np.unique(pred[t_mask])
        overlap_ids = overlap_ids[overlap_ids > 0]
        for pid in overlap_ids:
            j = int(np.where(pred_ids == pid)[0][0])
            inter[i, j] = (t_mask & (pred == pid)).sum()
    union = t_areas[:, None] + p_areas[None, :] - inter
    return inter, union, t_areas, p_areas


def get_fast_aji(true: np.ndarray, pred: np.ndarray) -> float:
    """Aggregated Jaccard Index (greedy per-GT best-IoU pairing,
    ``stats_utils.py:11-89``)."""
    true = np.asarray(true)
    pred = np.asarray(pred)
    inter, union, t_areas, p_areas = _pairwise_inter_union(true, pred)
    n_t, n_p = inter.shape
    if n_t == 0:
        return 0.0
    if n_p == 0:
        return 0.0
    iou = inter / np.maximum(union, 1e-9)
    paired_pred = iou.argmax(axis=1)
    overall_inter = 0.0
    overall_union = 0.0
    used_pred = np.zeros(n_p, bool)
    for i in range(n_t):
        j = paired_pred[i]
        if iou[i, j] > 0:
            overall_inter += inter[i, j]
            overall_union += union[i, j]
            used_pred[j] = True
        else:
            overall_union += t_areas[i]
    overall_union += p_areas[~used_pred].sum()
    return float(overall_inter / max(overall_union, 1e-9))


def get_fast_aji_plus(true: np.ndarray, pred: np.ndarray) -> float:
    """AJI+ — optimal (Hungarian) pairing variant (``stats_utils.py:93-174``)."""
    true = np.asarray(true)
    pred = np.asarray(pred)
    inter, union, t_areas, p_areas = _pairwise_inter_union(true, pred)
    n_t, n_p = inter.shape
    if n_t == 0 or n_p == 0:
        return 0.0
    iou = inter / np.maximum(union, 1e-9)
    rows, cols = linear_sum_assignment(-iou)
    paired = iou[rows, cols] > 0
    rows, cols = rows[paired], cols[paired]
    overall_inter = inter[rows, cols].sum()
    overall_union = union[rows, cols].sum()
    unpaired_t = np.setdiff1d(np.arange(n_t), rows)
    unpaired_p = np.setdiff1d(np.arange(n_p), cols)
    overall_union += t_areas[unpaired_t].sum() + p_areas[unpaired_p].sum()
    return float(overall_inter / max(overall_union, 1e-9))


def get_fast_pq(true: np.ndarray, pred: np.ndarray,
                match_iou: float = 0.5) -> Tuple[Tuple[float, float, float], list]:
    """Panoptic Quality -> ((DQ, SQ, PQ), [paired_true, paired_pred, unpaired_true,
    unpaired_pred]) (``stats_utils.py:178-279``)."""
    true = np.asarray(true)
    pred = np.asarray(pred)
    assert match_iou >= 0.0
    inter, union, t_areas, p_areas = _pairwise_inter_union(true, pred)
    n_t, n_p = inter.shape
    if n_t == 0 and n_p == 0:
        return (0.0, 0.0, 0.0), [[], [], [], []]
    iou = inter / np.maximum(union, 1e-9)

    if match_iou >= 0.5:
        # unique by definition: each pair with IoU > 0.5 is one-to-one
        rows, cols = np.nonzero(iou > match_iou)
        paired_iou = iou[rows, cols]
    else:
        r, c = linear_sum_assignment(-iou)
        ok = iou[r, c] > match_iou
        rows, cols = r[ok], c[ok]
        paired_iou = iou[rows, cols]

    tp = len(rows)
    unpaired_true = np.setdiff1d(np.arange(n_t), rows)
    unpaired_pred = np.setdiff1d(np.arange(n_p), cols)
    fp = len(unpaired_pred)
    fn = len(unpaired_true)
    dq = tp / max(tp + 0.5 * fp + 0.5 * fn, 1e-6)
    sq = paired_iou.sum() / max(tp, 1e-6)
    return (float(dq), float(sq), float(dq * sq)), [
        (rows + 1).tolist(), (cols + 1).tolist(),
        (unpaired_true + 1).tolist(), (unpaired_pred + 1).tolist()]


def get_fast_dice_2(true: np.ndarray, pred: np.ndarray) -> float:
    """Ensemble (instance-paired) Dice (``stats_utils.py:283-319``)."""
    true = np.asarray(true)
    pred = np.asarray(pred)
    inter, union, t_areas, p_areas = _pairwise_inter_union(true, pred)
    n_t, n_p = inter.shape
    if n_t == 0 or n_p == 0:
        return 0.0
    # the reference sums over EVERY overlapping (true, pred) pair — a GT
    # instance overlapping k preds contributes its area k times, and vice
    # versa (stats_utils.py:303-317) — not best-pair-per-GT
    overlap = inter > 0
    total_intersect = float(inter[overlap].sum())
    total_markup = float(
        (overlap * (t_areas[:, None] + p_areas[None, :])).sum())
    return float(2.0 * total_intersect / max(total_markup, 1e-9))


def get_dice_1(true: np.ndarray, pred: np.ndarray) -> float:
    """Traditional binary Dice over the union of instances (``stats_utils.py:323-334``)."""
    t = np.asarray(true) > 0
    p = np.asarray(pred) > 0
    denom = t.sum() + p.sum()
    if denom == 0:
        return 1.0
    return float(2.0 * (t & p).sum() / denom)


def remap_label(pred: np.ndarray, by_size: bool = False) -> np.ndarray:
    """Renumber instance ids contiguously from 1 (optionally largest-first)
    (``stats_utils.py:362-391``)."""
    pred = np.asarray(pred)
    pred_ids = list(np.unique(pred))
    if 0 in pred_ids:
        pred_ids.remove(0)
    if len(pred_ids) == 0:
        return pred
    if by_size:
        sizes = [(pred == pid).sum() for pid in pred_ids]
        pred_ids = [x for _, x in sorted(zip(sizes, pred_ids), reverse=True)]
    new_pred = np.zeros_like(pred)
    for new_id, pid in enumerate(pred_ids, start=1):
        new_pred[pred == pid] = new_id
    return new_pred


def pair_coordinates(setA: np.ndarray, setB: np.ndarray, radius: float):
    """Optimal point pairing within ``radius`` via Hungarian assignment
    (``stats_utils.py:395-431``). Returns (pairing [M, 2], unpairedA, unpairedB)."""
    setA = np.asarray(setA, np.float64)
    setB = np.asarray(setB, np.float64)
    if len(setA) == 0 or len(setB) == 0:
        return (np.zeros((0, 2), np.int64), np.arange(len(setA)), np.arange(len(setB)))
    cost = cdist(setA, setB, metric="euclidean")
    rows, cols = linear_sum_assignment(cost)
    ok = cost[rows, cols] <= radius
    pairing = np.stack([rows[ok], cols[ok]], axis=-1)
    unpairedA = np.setdiff1d(np.arange(len(setA)), rows[ok])
    unpairedB = np.setdiff1d(np.arange(len(setB)), cols[ok])
    return pairing, unpairedA, unpairedB
