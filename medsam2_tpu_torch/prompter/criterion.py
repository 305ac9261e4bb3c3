"""Joint prompter + SAM training criterion (counterpart of
``medsam2_tpu/prompter/criterion.py``; reference
``sam2_train/modeling/criterion.py``).

Losses, given the Hungarian assignment (``src_idx`` [B, M], -1 padding):

- ``loss_reg``: L2 on matched point coordinates, summed / num_points (x20);
- ``loss_cls``: cross-entropy over every query, the no-object class at
  ``eos_coef`` weight (x20);
- ``loss_mask``: binary focal loss on the prompter's semantic mask (x20);
- ``loss_focal``: Dice on the SAM cell masks (the reference's names are
  swapped, ``criterion.py:136-137``: its ``loss_focal`` computes Dice and
  ``loss_dice`` focal; the math is kept, the names too);
- ``loss_dice``: focal loss on the SAM cell masks;
- ``loss_iou``: MSE between the predicted IoU and the sigmoid mask's soft
  IoU (``MaskIoULoss``).

Focal and Dice are ``pytorch_toolbelt``'s at the reference's construction
defaults (:func:`~medsam2_tpu_torch.train.losses.binary_focal_loss`,
:func:`~medsam2_tpu_torch.train.losses.dice_loss_pooled`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from medsam2_tpu_torch.train.losses import binary_focal_loss, dice_loss_pooled


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 1
    eos_coef: float = 0.3
    reg_loss_coef: float = 20.0
    cls_loss_coef: float = 20.0
    mask_loss_coef: float = 20.0
    loss_focal: float = 1.0   # weight on the Dice term (reference naming)
    loss_dice: float = 1.0    # weight on the focal term
    loss_iou: float = 1.0


def loss_reg(pred_coords, gt_points, src_idx, gt_valid, num_points):
    """L2 on matched points (``criterion.py:48-61``)."""
    idx = src_idx.clamp_min(0).long()
    matched = torch.gather(pred_coords, 1, idx[..., None].expand(*idx.shape, 2))
    err = torch.sum((matched - gt_points) ** 2, dim=-1)
    err = torch.where(gt_valid, err, torch.zeros_like(err))
    return torch.sum(err) / (num_points + 1e-7)


def loss_cls(pred_logits, gt_labels, src_idx, gt_valid, ccfg: CriterionConfig):
    """CE over all queries; unmatched queries target the background class at
    ``eos_coef`` weight (``criterion.py:63-75``). Padded GT slots scatter
    into an extra column N that is then cut off, the JAX package's
    ``mode="drop"``, so that they never alias query 0."""
    B, N, _ = pred_logits.shape
    bg = ccfg.num_classes
    idx = torch.where(gt_valid & (src_idx >= 0), src_idx, N).long()
    targets = torch.full((B, N + 1), bg, dtype=torch.long, device=pred_logits.device)
    targets = targets.scatter(1, idx, gt_labels.long())[:, :N]
    logp = F.log_softmax(pred_logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    weight = torch.where(targets == bg, ccfg.eos_coef, 1.0)
    return torch.sum(nll * weight) / torch.sum(weight).clamp_min(1e-7)


def mask_iou_loss(pred_mask, gt_mask, pred_iou):
    """``MaskIoULoss`` (``criterion.py:11-29``): MSE between the predicted IoU
    and the soft IoU of the sigmoid mask."""
    p = torch.sigmoid(pred_mask.float())
    inter = torch.sum(p * gt_mask, dim=(1, 2))
    union = torch.sum(p, dim=(1, 2)) + torch.sum(gt_mask, dim=(1, 2)) - inter
    iou = (inter + 1e-7) / (union + 1e-7)
    return torch.mean((iou - pred_iou) ** 2)


def criterion_losses(ccfg: CriterionConfig, outputs: Dict, gt_points, gt_labels, gt_valid,
                     gt_semantic_mask, src_idx, sam_pred, sam_iou, sam_gt
                     ) -> Dict[str, torch.Tensor]:
    """outputs: the prompter's pred_coords / pred_logits / pred_masks;
    gt_points [B, M, 2], gt_labels [B, M], gt_valid [B, M] bool;
    gt_semantic_mask [B, H, W]; src_idx [B, M]; sam_pred [R, H, W] cell
    logits, sam_iou [R], sam_gt [R, H, W]. Returns the six weighted losses."""
    num_points = torch.sum(gt_valid.float()).clamp_min(1.0)
    return {
        "loss_reg": loss_reg(outputs["pred_coords"], gt_points, src_idx, gt_valid,
                             num_points) * ccfg.reg_loss_coef,
        "loss_cls": loss_cls(outputs["pred_logits"], gt_labels, src_idx, gt_valid,
                             ccfg) * ccfg.cls_loss_coef,
        "loss_mask": binary_focal_loss(outputs["pred_masks"],
                                       gt_semantic_mask) * ccfg.mask_loss_coef,
        "loss_focal": dice_loss_pooled(sam_pred, sam_gt) * ccfg.loss_focal,
        "loss_dice": binary_focal_loss(sam_pred, sam_gt) * ccfg.loss_dice,
        "loss_iou": mask_iou_loss(sam_pred, sam_gt, sam_iou) * ccfg.loss_iou,
    }
