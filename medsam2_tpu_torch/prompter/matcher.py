"""DETR-style Hungarian matcher (counterpart of
``medsam2_tpu/prompter/matcher.py``; reference
``sam2_train/modeling/matcher.py``), numpy + scipy on the host.

Cost = cost_point * ||pred - gt||_2 + cost_class * (-softmax prob of gt class),
built in float64 and solved by ``scipy.optimize.linear_sum_assignment``.
The port trains eagerly: the step runs one prompter forward, pulls
``pred_coords`` / ``pred_logits`` once and matches here, so it needs neither
the JAX package's host callback nor its second "precompute" forward. The
float64 cost is the one the JAX package's ``matcher_mode="precompute"``
builds (its callback mode builds it in fp32).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    cost_point: float = 0.1
    cost_class: float = 1.0


def _match_host(cost: np.ndarray, gt_valid: np.ndarray) -> np.ndarray:
    """cost [B, N, M]; gt_valid [B, M] bool -> src indices [B, M] int32
    (-1 for padding slots)."""
    from scipy.optimize import linear_sum_assignment

    B, N, M = cost.shape
    out = -np.ones((B, M), np.int32)
    for b in range(B):
        valid_cols = np.flatnonzero(gt_valid[b])
        if valid_cols.size == 0:
            continue
        rows, cols = linear_sum_assignment(cost[b][:, valid_cols])
        out[b, valid_cols[cols]] = rows.astype(np.int32)
    return out


def hungarian_match_host(mcfg: MatcherConfig, pred_coords: np.ndarray,
                         pred_logits: np.ndarray, gt_points: np.ndarray,
                         gt_labels: np.ndarray, gt_valid: np.ndarray) -> np.ndarray:
    """pred_coords [B, N, 2]; pred_logits [B, N, C+1]; gt_points [B, M, 2];
    gt_labels [B, M]; gt_valid [B, M]. Returns the matched prediction of
    each GT slot, [B, M] int32 (-1 for padding): ``HungarianMatcher.forward``
    (``matcher.py:29-47``), padded GT slots at a huge cost so that they
    never take a prediction."""
    pred_coords = np.asarray(pred_coords, np.float64)
    pred_logits = np.asarray(pred_logits, np.float64)
    gt_points = np.asarray(gt_points, np.float64)
    gt_labels = np.asarray(gt_labels)
    gt_valid = np.asarray(gt_valid, bool)
    B, N, _ = pred_coords.shape
    M = gt_points.shape[1]
    cost_point = np.linalg.norm(
        pred_coords[:, :, None, :] - gt_points[:, None, :, :], axis=-1)
    z = pred_logits - pred_logits.max(-1, keepdims=True)
    prob = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    lbl = np.clip(gt_labels, 0, prob.shape[-1] - 1)
    cost_class = -np.take_along_axis(
        prob, np.broadcast_to(lbl[:, None, :], (B, N, M)), axis=-1)
    cost = mcfg.cost_point * cost_point + mcfg.cost_class * cost_class
    cost = np.where(gt_valid[:, None, :], cost, 1e9)
    out = _match_host(cost, gt_valid)
    return np.where(gt_valid, out, -1).astype(np.int32)
