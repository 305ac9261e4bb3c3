"""Training losses (counterpart of ``medsam2_tpu/train/losses.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits, targets, pos_weight: float = 1.0):
    """Elementwise ``BCEWithLogitsLoss`` with ``pos_weight`` (the 3D recipe
    uses pos_weight=2, ``func_3d/function.py:35-36``); not reduced."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def binary_focal_loss(logits, targets, gamma: float = 2.0):
    """``pytorch_toolbelt.losses.BinaryFocalLoss()`` as the reference
    criterion constructs it (``sam2_train/modeling/criterion.py:41``): no
    alpha weighting, gamma=2, mean reduction. loss = (1 - pt)^gamma * BCE,
    pt = exp(-BCE)."""
    ce = bce_with_logits(logits.float(), targets.float())
    pt = torch.exp(-ce)
    return torch.mean((1.0 - pt) ** gamma * ce)


def dice_loss_pooled(logits, targets, eps: float = 1e-7):
    """``pytorch_toolbelt.losses.DiceLoss('binary')`` as constructed at
    ``criterion.py:42``: sigmoid probabilities, one soft-dice score pooled over
    batch and spatial dims, smooth=0, ``clamp_min(eps)`` on the denominator,
    and zero loss when the batch ground truth is empty."""
    p = torch.sigmoid(logits.float())
    t = targets.float()
    inter = torch.sum(p * t)
    card = torch.sum(p) + torch.sum(t)
    score = 2.0 * inter / card.clamp_min(eps)
    return torch.where(torch.sum(t) > 0, 1.0 - score, torch.zeros_like(score))


def dice_loss(logits, targets, eps: float = 1e-5):
    """Soft Dice on sigmoid probabilities, per sample."""
    probs = torch.sigmoid(logits)
    p = probs.reshape(probs.shape[0], -1)
    t = targets.reshape(targets.shape[0], -1)
    inter = torch.sum(p * t, dim=1)
    denom = torch.sum(p, dim=1) + torch.sum(t, dim=1)
    return 1.0 - (2.0 * inter + eps) / (denom + eps)


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Elementwise binary focal loss (used by the 2D criterion)."""
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss


def iou_between(pred_mask, gt_mask, eps: float = 1e-6):
    """Binary IoU per sample over flattened masks."""
    p = pred_mask.reshape(pred_mask.shape[0], -1).float()
    g = gt_mask.reshape(gt_mask.shape[0], -1).float()
    inter = torch.sum(p * g, dim=1)
    union = torch.sum(torch.maximum(p, g), dim=1)
    return inter / (union + eps)
