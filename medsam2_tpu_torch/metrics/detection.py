"""Point-detection mAP with distance-threshold matching (counterpart of
``medsam2_tpu/metrics/detection.py``; rebuild of ``func_2d/eval_map.py``:
mmdet-derived AP where TP/FP assignment uses a euclidean distance
threshold, dis_thr=20, instead of box IoU). numpy on the host."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area") -> np.ndarray:
    """AP from recall/precision curves (``eval_map.py:9-53``).

    recalls/precisions: [num_scales, num_dets] or [num_dets].
    """
    no_scale = recalls.ndim == 1
    if no_scale:
        recalls = recalls[None]
        precisions = precisions[None]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    if mode == "area":
        zeros = np.zeros((num_scales, 1), recalls.dtype)
        ones = np.ones((num_scales, 1), recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    elif mode == "11points":
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                ap[i] += precs.max() if precs.size > 0 else 0
        ap /= 11
    else:
        raise ValueError('Unrecognized mode, only "area" and "11points" supported')
    return ap[0] if no_scale else ap


def tpfp_points(det_points: np.ndarray, gt_points: np.ndarray,
                dis_thr: float = 20.0) -> Tuple[np.ndarray, np.ndarray]:
    """TP/FP flags for point detections (``eval_map.py:56-...`` semantics).

    det_points: [N, 3] (x, y, score); gt_points: [M, 2].
    Reference semantics (``eval_map.py:120-150``): each det's candidate GT is
    its globally NEAREST one (precomputed, independent of coverage); greedy by
    descending score, a det is TP if that nearest GT is within ``dis_thr`` and
    not yet covered, FP if it is covered or out of range — a second det whose
    nearest GT is taken does NOT re-match to another in-range GT.
    """
    det_points = np.asarray(det_points, np.float64)
    gt_points = np.asarray(gt_points, np.float64)
    N = len(det_points)
    tp = np.zeros(N, np.float32)
    fp = np.zeros(N, np.float32)
    if N == 0:
        return tp, fp
    if len(gt_points) == 0:
        fp[:] = 1
        return tp, fp
    order = np.argsort(-det_points[:, 2], kind="stable")
    covered = np.zeros(len(gt_points), bool)
    dists = np.linalg.norm(
        det_points[:, None, :2] - gt_points[None, :, :], axis=-1)
    dist_min = dists.min(axis=1)
    dist_argmin = dists.argmin(axis=1)
    for i in order:
        if dist_min[i] <= dis_thr:
            j = dist_argmin[i]
            if not covered[j]:
                covered[j] = True
                tp[i] = 1
            else:
                fp[i] = 1
        else:
            fp[i] = 1
    return tp, fp


def eval_map(det_results: List[np.ndarray], annotations: List[np.ndarray],
             dis_thr: float = 20.0, mode: str = "area"):
    """Dataset-level point-detection mAP.

    det_results: per-image [N_i, 3] (x, y, score) arrays.
    annotations: per-image [M_i, 2] GT point arrays.
    Returns (mean_ap, {"recall", "precision", "ap", "num_gts", "num_dets",
    "f1"}).
    """
    all_tp, all_fp, all_scores = [], [], []
    num_gts = 0
    for det, gt in zip(det_results, annotations):
        det = np.asarray(det, np.float64).reshape(-1, 3)
        gt = np.asarray(gt, np.float64).reshape(-1, 2)
        tp, fp = tpfp_points(det, gt, dis_thr)
        all_tp.append(tp)
        all_fp.append(fp)
        all_scores.append(det[:, 2])
        num_gts += len(gt)

    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    tp = np.concatenate(all_tp) if all_tp else np.zeros(0)
    fp = np.concatenate(all_fp) if all_fp else np.zeros(0)
    order = np.argsort(-scores, kind="stable")
    tp, fp = tp[order], fp[order]
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    eps = np.finfo(np.float32).eps
    recalls = tp_cum / max(num_gts, eps)
    precisions = tp_cum / np.maximum(tp_cum + fp_cum, eps)
    ap = average_precision(recalls, precisions, mode) if len(tp) else 0.0
    tp_total = float(tp.sum())
    precision = tp_total / max(len(tp), 1)
    recall = tp_total / max(num_gts, 1)
    f1 = 2 * precision * recall / max(precision + recall, eps)
    return float(ap), {
        "recall": recalls, "precision": precisions, "ap": float(ap),
        "num_gts": num_gts, "num_dets": int(len(tp)), "f1": float(f1),
    }
