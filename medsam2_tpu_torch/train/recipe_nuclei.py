"""Joint prompter + SAM2 nuclei training recipe (counterpart of
``medsam2_tpu/train/recipe_nuclei.py``; reference ``func_2d/function.py:27-266``
and ``train_2d.py`` on MoNuSeg / CPM-17).

One step: the DPA-P2PNet prompter (training forward: the mask head's batch
statistics, head dropout) predicts cell points -> the predicted point
nearest each chosen GT cell point becomes that cell's prompt
(``find_nearest_points``, ``func_2d/function.py:680-703``), without a
gradient -> SAM2 encodes the images and conditions them on the similarity
bank (:func:`~medsam2_tpu_torch.train.recipe_2d.encode_and_condition`) ->
one mask per cell slot, all B x M slots in one decoder call through its
``image_indices`` gather -> the memory encoder on the union of the valid
cells' masks, written to the bank -> the pulled prompter outputs matched
to the GT points on the host (:func:`hungarian_match_host`) -> the DETR
criterion and the SAM mask losses -> one AdamW step over both modules,
after clipping the prompter's gradients alone, then the mask head's
running statistics (momentum 0.1).

Cells are padded to ``max_cells`` per image with a validity mask; padded
rows drop out of every loss. The port runs eagerly, so one prompter forward
feeds both the match and the loss (the JAX package's ``precompute`` mode
runs it twice with one dropout key, which is the same). Each random stream
has its own ``torch.Generator``: the bank's draws, the memory-attention
dropout and the head dropout; ``indices`` overrides the bank's draws (the
tests inject the JAX package's).

On the card the trunk trains through B7 / B8 with ``MEDSAM2_FUSED_MLP`` /
``MEDSAM2_FUSED_BLOCK`` on (forward the kernels, backward their twins). At
nuclei_256 no attention reaches the flash gate (256 query tokens).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.sam2_model import SAM2Model
from medsam2_tpu_torch.prompter.criterion import CriterionConfig, criterion_losses
from medsam2_tpu_torch.prompter.dpa_p2pnet import Prompter, PrompterConfig
from medsam2_tpu_torch.prompter.matcher import MatcherConfig, hungarian_match_host
from medsam2_tpu_torch.state import similarity_bank as sb
from medsam2_tpu_torch.train.recipe_2d import (clip_by_global_norm, encode_and_condition,
                                               prompt_encode_nograd)
from medsam2_tpu_torch.train.recipe_3d import _grads

BN_MOMENTUM = 0.1   # torch's BatchNorm default, the running-stat update


@dataclasses.dataclass(frozen=True)
class NucleiRecipeConfig:
    prompter: PrompterConfig = PrompterConfig()
    matcher: MatcherConfig = MatcherConfig()
    criterion: CriterionConfig = CriterionConfig()
    memory_bank_size: int = 16
    max_cells: int = 64           # cell slots per image
    lr: float = 1e-4
    weight_decay: float = 1e-4
    clip_grad: float = 0.1        # prompter gradients only (func_2d/function.py:257-258)
    out_size: int = 256


def find_nearest_points(pred_coords, gt_points, gt_valid):
    """For each GT cell point, the nearest predicted point
    (``func_2d/function.py:680-703``): [B, N, 2] x [B, M, 2] -> [B, M, 2],
    zero in padded slots."""
    d = torch.linalg.vector_norm(pred_coords[:, None, :, :].float()
                                 - gt_points[:, :, None, :].float(), dim=-1)   # [B, M, N]
    idx = d.argmin(dim=-1)
    nearest = torch.gather(pred_coords, 1, idx[..., None].expand(*idx.shape, 2))
    return torch.where(gt_valid[..., None], nearest, torch.zeros_like(nearest))


def forward_nuclei(model: SAM2Model, prompter: Prompter, rcfg: NucleiRecipeConfig, batch: Dict,
                   bank, generator: Optional[torch.Generator], bank_nonempty: bool,
                   dropout_generator: Optional[torch.Generator] = None,
                   head_generator: Optional[torch.Generator] = None, indices=None):
    """The joint forward (``recipe_nuclei.forward_nuclei``). batch (tensors
    on the model's device): images [B, S, S, 3], gt_points [B, M, 2],
    gt_labels [B, M], gt_valid [B, M] bool (prefix-valid). The prompter runs
    in its current mode (training: ``prompter.train()``). Returns (the
    prompter's outputs, cell logits [B, M, out, out], cell IoUs [B, M], the
    cells' prompt points, the new bank)."""
    images, gt_valid = batch["images"], batch["gt_valid"]
    B, M, S = images.shape[0], rcfg.max_cells, model.cfg.image_size
    outputs, _ = prompter(images, None, dropout_generator=head_generator)
    nearest = find_nearest_points(outputs["pred_coords"], batch["gt_points"], gt_valid).detach()

    image_embed, high_res, vision_feats = encode_and_condition(
        model, images, bank, generator, bank_nonempty, B,
        dropout_generator=dropout_generator, indices=indices)
    # point labels are the 0-based cell class, as the reference feeds them
    # (func_2d/function.py:64,144): 0, the negative-point embedding, for
    # single-class nuclei; padding -1
    coords = nearest.reshape(B * M, 1, 2)
    labels = torch.where(gt_valid.reshape(B * M), batch["gt_labels"].reshape(B * M).int(),
                         -1)[:, None]
    sparse, dense = prompt_encode_nograd(model, coords, labels)
    image_pe = model.sam_prompt_encoder.get_dense_pe()
    image_indices = torch.arange(B, device=images.device).repeat_interleave(M)
    low_res, ious, _, _ = model.sam_mask_decoder(
        image_embed, image_pe, sparse, dense, multimask_output=False,
        high_res_features=high_res, image_indices=image_indices)
    out = rcfg.out_size
    pred_cells = layers.interpolate(low_res.float().permute(0, 2, 3, 1), (out, out),
                                    method="bilinear")[..., 0].reshape(B, M, out, out)
    iou_cells = ious[:, 0].reshape(B, M)

    # memory write: the union of the valid cells' masks per image
    union = torch.where(gt_valid[..., None, None], pred_cells,
                        torch.full_like(pred_cells, float("-inf"))).amax(dim=1)
    binary = layers.interpolate((union > 0).float()[..., None], (S, S), method="bilinear")
    maskmem, _ = model.encode_new_memory(vision_feats[-1], binary.permute(0, 3, 1, 2),
                                         is_mask_from_pts=True)
    mean_iou = (torch.where(gt_valid, iou_cells, torch.zeros_like(iou_cells)).sum()
                / gt_valid.sum().clamp_min(1))
    bank = sb.write_similarity_bank(bank, maskmem.detach(), mean_iou.detach(),
                                    image_embed.reshape(B, -1).float().detach())
    return outputs, pred_cells, iou_cells, nearest, bank


def nuclei_losses(rcfg: NucleiRecipeConfig, outputs: Dict, pred_cells, iou_cells, batch: Dict,
                  src_idx) -> Dict[str, torch.Tensor]:
    """The six losses of the step (``recipe_nuclei.py:160-193``). Padded cell
    rows get logits -1e9 (sigmoid exactly 0) and gt 0, so they add nothing to
    the pooled Dice or the focal sums, and their soft IoU (0 + 1e-7) / (0 +
    1e-7) = 1 cancels a pinned predicted IoU of 1; the per-cell means
    ``loss_dice`` and ``loss_iou`` are then divided by the valid fraction."""
    B, M = iou_cells.shape
    out = rcfg.out_size
    vmask = batch["gt_valid"].reshape(B * M)
    flat_pred = torch.where(vmask[:, None, None], pred_cells.reshape(B * M, out, out),
                            torch.full((), -1e9, device=pred_cells.device))
    flat_gt = torch.where(vmask[:, None, None],
                          batch["gt_cell_masks"].reshape(B * M, out, out).float(),
                          torch.zeros((), device=pred_cells.device))
    flat_iou = torch.where(vmask, iou_cells.reshape(B * M).float(),
                           torch.ones((), device=iou_cells.device))
    losses = criterion_losses(rcfg.criterion, outputs, batch["gt_points"], batch["gt_labels"],
                              batch["gt_valid"], batch["gt_semantic"], src_idx, flat_pred,
                              flat_iou, flat_gt)
    valid_frac = vmask.float().mean().clamp_min(1e-6)
    for k in ("loss_dice", "loss_iou"):
        losses[k] = losses[k] / valid_frac
    return losses


def named_trainables(model: SAM2Model, prompter: Prompter) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of what the recipe trains: every SAM2 parameter but the
    prompt encoder's (the reference calls it under ``torch.no_grad``,
    ``func_2d/function.py:140-152``; the JAX package labels all of it,
    random-Fourier matrix included, frozen), then every prompter parameter
    under ``prompter.`` (its BN running statistics are buffers)."""
    return ([(n, p) for n, p in model.named_parameters()
             if not n.startswith("sam_prompt_encoder.")]
            + [(f"prompter.{n}", p) for n, p in prompter.named_parameters()])


def make_optimizer_nuclei(model: SAM2Model, prompter: Prompter,
                          rcfg: NucleiRecipeConfig) -> torch.optim.AdamW:
    """Set the trainable tensors to require gradients (the rest of the
    model stays frozen) and return one AdamW over them
    (``make_optimizer_nuclei``: ``optax.adamw(lr, weight_decay)``; betas
    (0.9, 0.999), eps 1e-8 after the square root, decoupled decay)."""
    model.requires_grad_(False)
    tensors = [t.requires_grad_(True) for _, t in named_trainables(model, prompter)]
    return torch.optim.AdamW(tensors, lr=rcfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=rcfg.weight_decay)


@torch.no_grad()
def update_bn_running_stats(prompter: Prompter, stats: Optional[Dict]) -> None:
    """rs = (1 - m) rs + m batch, m = 0.1, after the optimizer
    (``recipe_nuclei.py:214-224``)."""
    if stats is None:
        return
    bn = prompter.mask_head.bn
    bn.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * stats["mean"])
    bn.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * stats["var"])


def make_train_step_nuclei(model: SAM2Model, prompter: Prompter, rcfg: NucleiRecipeConfig,
                           optimizer: torch.optim.Optimizer):
    """The joint step. ``train_step(batch, bank, bank_nonempty, generator=None,
    dropout_generator=None, head_generator=None, indices=None)`` takes the
    packed batch (arrays or tensors: images, gt_points, gt_labels, gt_valid,
    gt_cell_masks [B, M, out, out], gt_semantic [B, S, S]) and returns (the
    new bank, metrics as 0-dim device tensors: the six losses and ``loss``).
    It puts the prompter in training mode. After a step each trainable
    tensor's ``.grad`` holds the gradient AdamW applied (the prompter's
    clipped)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    names = [n for n, _ in named_trainables(model, prompter)]
    prompter_grads = [i for i, n in enumerate(names) if n.startswith("prompter.")]

    def train_step(batch: Dict, bank, bank_nonempty: bool,
                   generator: Optional[torch.Generator] = None,
                   dropout_generator: Optional[torch.Generator] = None,
                   head_generator: Optional[torch.Generator] = None, indices=None):
        dev = model.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        prompter.train()
        outputs, pred_cells, iou_cells, _, bank = forward_nuclei(
            model, prompter, rcfg, batch, bank, generator, bank_nonempty,
            dropout_generator=dropout_generator, head_generator=head_generator,
            indices=indices)
        src_idx = hungarian_match_host(
            rcfg.matcher, outputs["pred_coords"].detach().cpu().numpy(),
            outputs["pred_logits"].detach().cpu().numpy(),
            batch["gt_points"].cpu().numpy(), batch["gt_labels"].cpu().numpy(),
            batch["gt_valid"].cpu().numpy())
        losses = nuclei_losses(rcfg, outputs, pred_cells, iou_cells, batch,
                               torch.from_numpy(src_idx).to(dev))
        total = sum(losses.values())
        grads = _grads(total, params, retain_graph=False)
        if rcfg.clip_grad > 0:
            clip_by_global_norm([grads[i] for i in prompter_grads], rcfg.clip_grad)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        update_bn_running_stats(prompter, outputs.get("mask_bn_stats"))
        return bank, {**{k: v.detach() for k, v in losses.items()}, "loss": total.detach()}

    return train_step
