"""2D training recipe with the similarity memory bank (counterpart of
``medsam2_tpu/train/recipe_2d.py``; the REFUGE click-prompt variant of the
reference's ``func_2d`` engine, ``func_2d/function.py:27-266``).

One step: encode the batch -> condition the top-level features on memories
drawn from the cross-image similarity bank (memory attention) -> prompt
encoder (no gradient) -> mask decoder -> upscale -> memory encoder on the
thresholded prediction -> bank insert / replace -> BCE(pos_weight) + Dice +
IoU-head MSE -> one AdamW step over every parameter, after clipping the
global gradient norm.

As in the JAX package the whole model trains, the Hiera trunk included
(``jax.value_and_grad`` over all of ``params``), and so does the prompt
encoder's random-Fourier matrix, which the JAX package keeps among its
parameters (the reference registers it as a buffer): it gets its gradient
through the decoder's dense positional encoding. On the card the trunk's
global blocks and the memory attention reach the flash kernels (B1 forward
with LSE, B3 / B4 backward); with the encoder switches on, B7 and B8 run
their kernels forward and their twins backward.

Parameters that the loss does not reach (the prompt encoder behind its
no-grad, the memory encoder behind the bank, memory attention on the
empty-bank first step) get zero gradients, not None, so that AdamW decays
them as ``optax.adamw`` does. The memory-attention dropout and the bank's
draws come from one ``torch.Generator`` on the model's device; ``indices``
overrides the draws (the tests inject the JAX package's).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from medsam2_tpu_torch.core import layers
from medsam2_tpu_torch.core.pos_enc import sine_pos_embed_grid
from medsam2_tpu_torch.core.sam2_model import SAM2Model, compute_dtype
from medsam2_tpu_torch.state import similarity_bank as sb
from medsam2_tpu_torch.train.losses import bce_with_logits, dice_loss, iou_between
from medsam2_tpu_torch.train.recipe_3d import _grads


@dataclasses.dataclass(frozen=True)
class Recipe2DConfig:
    memory_bank_size: int = 16        # cfg.py:56
    lr: float = 1e-4
    weight_decay: float = 1e-4
    pos_weight: float = 2.0
    out_size: int = 1024              # loss resolution
    clip_grad: float = 0.1
    iou_loss_weight: float = 1.0      # MaskIoULoss (criterion.py:11-29)


def init_bank(model: SAM2Model, size: int) -> Dict[str, torch.Tensor]:
    """An empty similarity bank of ``size`` slots on the model's device:
    P = (image embedding size)^2 memory tokens of mem_dim channels, and the
    flattened [P x hidden] image embedding per slot."""
    cfg = model.cfg
    P = cfg.sam_image_embedding_size ** 2
    return sb.init_similarity_bank(size, P, cfg.mem_dim, P * cfg.hidden_dim, model.device)


@functools.lru_cache(maxsize=8)
def _bank_memory_pos_on(mem_h: int, mem_dim: int, num_samples: int, device: str,
                        dtype: torch.dtype) -> torch.Tensor:
    pos = sine_pos_embed_grid(mem_h, mem_h, mem_dim).reshape(-1, mem_dim)
    return torch.from_numpy(np.tile(pos, (num_samples, 1))).to(device, dtype)


def _bank_memory_pos(model: SAM2Model, num_samples: int, dtype) -> torch.Tensor:
    """The sampled memories' positions [num_samples * P, mem_dim]: the sine
    grid of one memory tiled once per drawn slot, made once per (size,
    device, dtype)."""
    cfg = model.cfg
    return _bank_memory_pos_on(cfg.sam_image_embedding_size, cfg.mem_dim, num_samples,
                               str(model.device), dtype)


def encode_and_condition(model: SAM2Model, images, bank, generator, bank_nonempty: bool,
                         num_samples: int, dropout_generator: Optional[torch.Generator] = None,
                         indices=None):
    """Image encoder + similarity-bank memory conditioning
    (``func_2d/function.py:70-129``). Returns (image_embed [B, h, w, C],
    the high-res skip features, the features for the memory encoder).
    ``bank_nonempty`` is host control flow, as the JAX package's static
    argument; ``dropout_generator`` turns on the memory-attention dropout."""
    backbone_out = model.forward_image(images.to(compute_dtype(model.cfg)))
    feats, pos = model.prepare_backbone_features(backbone_out)
    top = feats[-1]
    B, h, w, C = top.shape
    if bank_nonempty:
        cur_embeds = top.reshape(B, -1).float().detach()
        memory, _ = sb.read_similarity_bank(bank, cur_embeds, generator, num_samples,
                                            indices=indices)
        mem_pos = _bank_memory_pos(model, num_samples, top.dtype)
        conditioned = model.memory_attention(
            top.reshape(B, h * w, C), pos[-1].reshape(B, h * w, C).to(top.dtype), q_hw=(w, h),
            memory=memory.to(top.dtype), memory_pos=mem_pos[None].expand(B, *mem_pos.shape),
            num_obj_ptr_tokens=0, generator=dropout_generator)
        top = conditioned.reshape(B, h, w, C)
    # the reference mutates vision_feats[-1] in place (``:119``), so the
    # memory encoder downstream sees the conditioned top feature
    return top, list(feats[:-1]), list(feats[:-1]) + [top]


def prompt_encode_nograd(model: SAM2Model, coords, labels):
    """Sparse and dense prompt embeddings without a graph (the JAX
    package's ``stop_gradient``): the prompt encoder's weights get zero
    gradients."""
    with torch.no_grad():
        return model.sam_prompt_encoder((coords, labels))


def forward_2d(model: SAM2Model, rcfg: Recipe2DConfig, images, coords, labels, bank,
               generator: Optional[torch.Generator], bank_nonempty: bool,
               multimask_output: bool = False,
               dropout_generator: Optional[torch.Generator] = None, is_eval: bool = False,
               indices=None):
    """One 2D forward: returns (pred logits [B, out, out], iou_pred [B], the
    new bank, aux dict). ``is_eval`` turns on the decoder's
    dynamic-stability fallback for single-mask outputs, as the reference's
    validation does (``func_2d/function.py:271``), not its training."""
    B = images.shape[0]
    num_samples = B
    image_embed, high_res, vision_feats = encode_and_condition(
        model, images, bank, generator, bank_nonempty, num_samples,
        dropout_generator=dropout_generator, indices=indices)
    sparse, dense = prompt_encode_nograd(model, coords, labels)
    image_pe = model.sam_prompt_encoder.get_dense_pe()
    low_res, ious, _, _ = model.sam_mask_decoder(
        image_embed, image_pe, sparse, dense, multimask_output=multimask_output,
        high_res_features=high_res, dynamic_multimask_via_stability=is_eval)
    iou_best = ious.amax(dim=1)
    pred = layers.interpolate(low_res.float().permute(0, 2, 3, 1),
                              (rcfg.out_size, rcfg.out_size), method="bilinear")[..., 0]

    # memory encoder on the thresholded prediction (func_2d/function.py:180-191)
    cfg = model.cfg
    high_res_bin = (pred > 0).float()[..., None]
    mask = layers.interpolate(high_res_bin, (cfg.image_size, cfg.image_size),
                              method="bilinear").permute(0, 3, 1, 2)
    maskmem_features, _ = model.encode_new_memory(vision_feats[-1], mask, is_mask_from_pts=True)
    bank = sb.write_similarity_bank(bank, maskmem_features.detach(),
                                    iou_best.mean().detach(),
                                    image_embed.reshape(B, -1).float().detach())
    return pred, iou_best, bank, {"low_res": low_res}


def loss_2d(model: SAM2Model, rcfg: Recipe2DConfig, batch: Dict, bank,
            generator: Optional[torch.Generator], bank_nonempty: bool, indices=None):
    """The step's loss (BCE with ``pos_weight`` + Dice + the IoU head's MSE
    to the prediction's IoU), the new bank and the metrics. The reference
    trains with dropout active, so ``generator`` draws the dropout too."""
    pred, iou_pred, bank, _ = forward_2d(
        model, rcfg, batch["images"], batch["coords"], batch["labels"], bank, generator,
        bank_nonempty, dropout_generator=generator, indices=indices)
    gt = batch["gt_masks"]
    bce = bce_with_logits(pred, gt, rcfg.pos_weight).mean()
    dsc = dice_loss(pred, gt).mean()
    actual_iou = iou_between((pred > 0).float(), gt)
    iou_l = torch.mean((iou_pred.float() - actual_iou.detach()) ** 2)
    loss = bce + dsc + rcfg.iou_loss_weight * iou_l
    return loss, bank, {"loss": loss, "bce": bce, "dice": dsc, "iou_mse": iou_l}


GAUSS = "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"


def named_trainables(model: SAM2Model) -> List[Tuple[str, torch.Tensor]]:
    """(state-dict name, tensor) of everything the recipe trains: every
    parameter, then the prompt encoder's random-Fourier matrix (a JAX
    parameter, a buffer here)."""
    return [*model.named_parameters(),
            (GAUSS, model.sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix)]


def make_optimizer_2d(model: SAM2Model, rcfg: Recipe2DConfig) -> torch.optim.AdamW:
    """Set every trainable tensor to require a gradient, and return
    ``optax.adamw(lr, weight_decay=wd)`` over them: one group, betas (0.9,
    0.999), eps 1e-8 after the square root, decoupled decay of the old
    weights (the same update as optax's)."""
    tensors = [t.requires_grad_(True) for _, t in named_trainables(model)]
    return torch.optim.AdamW(tensors, lr=rcfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=rcfg.weight_decay)


def clip_by_global_norm(grads: List[torch.Tensor], clip: float) -> None:
    """Scale the gradients in place by ``min(1, clip / max(|g|, 1e-9))``, |g|
    the global norm over all of them: the JAX recipe's rule (not
    ``clip_grad_norm_``, which divides by ``|g| + 1e-6``). No host sync."""
    gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                  for g in grads]))
    scale = torch.clamp(clip / gnorm.clamp_min(1e-9), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def make_train_step_2d(model: SAM2Model, rcfg: Recipe2DConfig, optimizer: torch.optim.Optimizer):
    """The REFUGE-style SAM-only click training step.

    batch: images [B, S, S, 3], coords [B, P, 2], labels [B, P], gt_masks
    [B, out, out] (arrays or tensors; moved to the model's device).
    ``train_step(batch, bank, generator, bank_nonempty, indices=None)``
    returns (the new bank, metrics as 0-dim device tensors). After a step
    each trainable tensor's ``.grad`` holds the clipped gradient AdamW
    applied."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def train_step(batch: Dict, bank, generator: Optional[torch.Generator],
                   bank_nonempty: bool, indices=None):
        dev = model.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, bank, metrics = loss_2d(model, rcfg, batch, bank, generator, bank_nonempty,
                                      indices=indices)
        grads = _grads(loss, params, retain_graph=False)
        if rcfg.clip_grad > 0:
            clip_by_global_norm(grads, rcfg.clip_grad)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        return bank, {k: v.detach() for k, v in metrics.items()}

    return train_step
